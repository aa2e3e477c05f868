"""Interprocedural call graph + hot-path reachability (counterpart of
`repro.lint.callgraph`, whose resolution it keeps as it is).

The graph is seeded at the port's round loop, its engines' round bodies and
its kernel wrappers, and every function statically reachable from a seed is
"hot" — the hot-path rules (host sync, reproducibility, dtype, hot-densify)
apply to the whole reachable set regardless of module.

Resolution policy (documented misses included):

  1. bare `f(...)`          -> same-module def, nested def of the caller, or
                               an imported project symbol (alias-aware);
  2. `mod.f(...)`           -> `f` in the imported project module (dotted
                               aliases and `from pkg import mod` both work);
  3. `Cls.f(...)`           -> method `f` of an imported/local project class;
  4. `self.f(...)`          -> `f` in the enclosing class, its project
                               ancestors AND its project descendants (the
                               subclass set over-approximates dispatch);
  5. `obj.f(...)`           -> dispatch-by-name, restricted to ENGINE
                               classes (anything deriving from the engine
                               base, `TorchRoundEngine` in the port):
                               `engine.step(...)` reaches every engine's
                               `step`.  Method calls on non-engine values
                               (`ctx.tiled.nnz()`) are a DOCUMENTED MISS —
                               the receiver's type is not tracked, so such
                               callees must be reachable some other way or
                               seeded explicitly.

Function REFERENCES create edges too (`jax.jit(fn)`, `functools.partial(fn)`,
`lax.while_loop(cond, body)`): a function passed around by a hot caller is
assumed callable from it.  Loop-body positions of `while_loop`/`scan`/
`fori_loop` additionally mark the target as a loop body (the reference's
loops; lambda bodies are recorded on the enclosing function).  The port's
round loops are Python `while` statements: every seeded function that holds
one is a round loop (`round_loops`), read by the loop-carry rule.

One edge is not drawn: a call in the true branch of `if on_cpu(...)` runs
on CPU tensors only, never on the card, so a kernel wrapper's plain-torch
version is hot only where something else on the hot path calls it
(`tiled_ref`'s tile operators are).  RPT015 keeps every wrapper's call of a
`*_plain` function inside such a branch, so the cut is sound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.lint.analysis import (
    LOOP_BODY_KWARGS,
    LOOP_CALLS,
    ClassInfo,
    FunctionInfo,
    LintContext,
    ModuleInfo,
)

# The port's hot-path seeds, by key ("module:qualname"), not by leaf name:
# the reference seeds leaf names, so the port's names stay off its list and
# the reference's lint never takes a port function for one of its own.
SEED_KEYS = (
    # the convergence loop of `run_tc_mis` (its set-up and epilogue run
    # once a solve, outside it)
    "repro_torch.core.tc_mis:_converge",
    # the profiler twin, host-stepped by design (suppressed on its def line)
    "repro_torch.core.tc_mis:run_phases",
    # the sharded round loop, one per rank
    "repro_torch.core.distributed:build_distributed_mis.run",
    # the warm re-entry of the dynamic route
    "repro_torch.dyngraph.repair:repair_solution",
    "repro_torch.dyngraph.repair:warm_start",
    "repro_torch.dyngraph.repair:_seed_cover",
    "repro_torch.dyngraph.repair:_seed_cover_bits",
)
SEED_ENGINE_METHODS = frozenset(
    {
        "step",
        "step_bits",
        "fused_step",
        "fused_step_bits",
        "step_with_stats",
        "_step_bits_with_stats",
        "step_hybrid",
        "step_bits_hybrid",
        "_step_hybrid_with_stats",
        "_step_bits_hybrid_with_stats",
    }
)
ENGINE_BASE = "TorchRoundEngine"
# kernel modules: the modules of these packages that define a `_launch*`
# function; each of its `_launch*` functions and each public module-level
# function that is not a `*_plain` version (the wrappers) is a seed
WRAPPER_PACKAGES = ("repro_torch.hopper",)
LAUNCH_PREFIX = "_launch"
PLAIN_SUFFIX = "_plain"

# A seed spec is a dict of: "keys", "engine_methods", "engine_base",
# "wrapper_packages" (the port's), and the reference's leaf-name
# "functions" and "suffixes" (seeded in packages named `kernels`), so the
# reference's own DEFAULT_SEEDS, with "engine_base": "RoundEngine", seeds
# as the reference does.  Functions handed to `pallas_call` are seeds under
# any spec, as in the reference; the port hands none.
DEFAULT_SEEDS = {
    "keys": list(SEED_KEYS),
    "engine_methods": sorted(SEED_ENGINE_METHODS),
    "engine_base": ENGINE_BASE,
    "wrapper_packages": list(WRAPPER_PACKAGES),
}
SUFFIX_PACKAGE = "kernels"
HANDED_TO = "pallas_call"


def _in_package(module: str, pkg: str) -> bool:
    return module == pkg or module.startswith(pkg + ".")


@dataclasses.dataclass
class CallGraph:
    edges: Dict[str, Set[str]]
    hot: Set[str]
    seeds: Set[str]
    loop_bodies: Set[str]
    engine_classes: Set[str]                 # "module:ClassName"
    engine_methods: Dict[str, Set[str]]      # method name -> function keys
    round_loops: Set[str] = dataclasses.field(default_factory=set)

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, ctx: LintContext, seeds=None) -> "CallGraph":
        seeds = DEFAULT_SEEDS if seeds is None else seeds
        graph = cls(
            edges={},
            hot=set(),
            seeds=set(),
            loop_bodies=set(),
            engine_classes=set(),
            engine_methods={},
        )
        graph._index_engine_classes(ctx, seeds.get("engine_base", ENGINE_BASE))
        for mi in ctx.modules.values():
            for fi in mi.functions.values():
                graph._collect_edges(ctx, mi, fi)
        graph._seed(ctx, seeds)
        graph._reach()
        return graph

    # -- engine classes: the engine base + transitive subclasses ----------
    def _index_engine_classes(self, ctx: LintContext, base: str) -> None:
        by_name: Dict[str, List[Tuple[str, ClassInfo]]] = {}
        for mi in ctx.modules.values():
            for ci in mi.classes.values():
                by_name.setdefault(ci.name.split(".")[-1], []).append(
                    (mi.name, ci)
                )
        # fixpoint over "derives (by base name) from an engine class"
        engine_names = {base}
        changed = True
        while changed:
            changed = False
            for entries in by_name.values():
                for mod, ci in entries:
                    leaf = ci.name.split(".")[-1]
                    if leaf in engine_names:
                        continue
                    if any(b[-1] in engine_names for b in ci.bases):
                        engine_names.add(leaf)
                        changed = True
        for entries in by_name.values():
            for mod, ci in entries:
                if ci.name.split(".")[-1] in engine_names:
                    self.engine_classes.add(f"{mod}:{ci.name}")
                    for meth, key in ci.methods.items():
                        self.engine_methods.setdefault(meth, set()).add(key)

    # -- per-function edge collection --------------------------------------
    def _add(self, src: str, dst: str) -> None:
        self.edges.setdefault(src, set()).add(dst)

    def _collect_edges(
        self, ctx: LintContext, mi: ModuleInfo, fi: FunctionInfo
    ) -> None:
        for nested in fi.nested:
            self._add(fi.key, nested)  # framework-invoked (`@pl.when`) bodies
        for call in fi.calls:
            if call.cpu_only:
                continue  # runs on CPU tensors only (the module docstring)
            if call.chain:
                for dst in self.resolve(ctx, mi, fi, call.chain):
                    self._add(fi.key, dst)
                # loop-body marking for Name-valued body args
                if call.chain[-1] in LOOP_CALLS:
                    self._mark_loop_body(ctx, mi, fi, call)
            for ref in call.arg_chains:
                for dst in self.resolve(ctx, mi, fi, ref, reference=True):
                    self._add(fi.key, dst)

    def _mark_loop_body(self, ctx, mi, fi, call) -> None:
        import ast

        pos = LOOP_CALLS[call.chain[-1]]
        node = call.node
        body_arg = None
        if len(node.args) > pos:
            body_arg = node.args[pos]
        else:
            kw = LOOP_BODY_KWARGS[call.chain[-1]]
            for k in node.keywords:
                if k.arg == kw:
                    body_arg = k.value
        chain = None
        if body_arg is not None and not isinstance(body_arg, ast.Lambda):
            from repro_torch.lint.analysis import attr_chain

            chain = attr_chain(body_arg)
        if chain:
            for dst in self.resolve(ctx, mi, fi, chain, reference=True):
                self.loop_bodies.add(dst)

    # -- chain resolution ---------------------------------------------------
    def resolve(
        self,
        ctx: LintContext,
        mi: ModuleInfo,
        fi: Optional[FunctionInfo],
        chain: Tuple[str, ...],
        reference: bool = False,
    ) -> Set[str]:
        out: Set[str] = set()
        root, rest = chain[0], chain[1:]

        # nested def of the caller (or of an enclosing function)
        scope = fi
        while scope is not None and not rest:
            cand = f"{scope.qualname}.{root}"
            if cand in mi.functions:
                return {f"{mi.name}:{cand}"}
            scope = (
                ctx.function(scope.parent) if scope.parent else None
            )

        if not rest:
            # same-module def (module level or method of the enclosing class)
            if root in mi.functions:
                return {f"{mi.name}:{root}"}
            if fi is not None and fi.class_name:
                cand = f"{fi.class_name}.{root}"
                if cand in mi.functions:
                    return {f"{mi.name}:{cand}"}
            tgt = mi.imports.get(root)
            if tgt and tgt[0] == "symbol":
                _, src_mod, sym = tgt
                dst = ctx.modules.get(src_mod)
                if dst and sym in dst.functions:
                    return {f"{dst.name}:{sym}"}
                # `from pkg import name` re-exported via pkg/__init__
                dst2 = ctx.modules.get(f"{src_mod}.{sym}")
                if dst2 is None and dst is not None:
                    fwd = dst.imports.get(sym)
                    if fwd and fwd[0] == "symbol":
                        dst3 = ctx.modules.get(fwd[1])
                        if dst3 and fwd[2] in dst3.functions:
                            return {f"{dst3.name}:{fwd[2]}"}
            return out

        # self./cls. method dispatch: class family (ancestors + descendants)
        if root in ("self", "cls") and fi is not None and fi.class_name:
            meth = chain[-1]
            for key in self._family_methods(ctx, mi, fi.class_name, meth):
                out.add(key)
            return out

        tgt = mi.imports.get(root)
        if tgt is not None:
            if tgt[0] == "module":
                mod_parts = [tgt[1], *rest[:-1]]
            else:
                mod_parts = [f"{tgt[1]}.{tgt[2]}", *rest[:-1]]
            # longest dotted prefix that names a universe module wins
            for cut in range(len(mod_parts), 0, -1):
                cand_mod = ".".join(mod_parts[:cut])
                dst = ctx.modules.get(cand_mod)
                if dst is None:
                    continue
                tail = [*mod_parts[cut:], chain[-1]]
                if len(tail) == 1 and tail[0] in dst.functions:
                    out.add(f"{dst.name}:{tail[0]}")
                elif len(tail) == 2 and tail[0] in dst.classes:
                    key = dst.classes[tail[0]].methods.get(tail[1])
                    if key:
                        out.add(key)
                break
            if out or tgt[0] == "module":
                return out
            # `Cls.meth(...)` where Cls was imported as a symbol
            if tgt[0] == "symbol" and len(rest) == 1:
                dst = ctx.modules.get(tgt[1])
                if dst and tgt[2] in dst.classes:
                    key = dst.classes[tgt[2]].methods.get(rest[0])
                    if key:
                        return {key}
            return out

        # local class: `Cls.meth(...)` / `Cls().meth(...)` approximations
        if root in mi.classes and len(rest) == 1:
            key = mi.classes[root].methods.get(rest[0])
            if key:
                return {key}

        # dispatch-by-name, engine classes only (`engine.step(...)`).
        # Method calls on other untyped receivers are a documented miss.
        if len(chain) == 2 and not reference:
            out |= self.engine_methods.get(chain[-1], set())
        return out

    def _family_methods(
        self, ctx: LintContext, mi: ModuleInfo, class_name: str, meth: str
    ) -> Set[str]:
        """`self.meth` targets: enclosing class, ancestors, descendants."""
        out: Set[str] = set()
        leaf = class_name.split(".")[-1]
        family = {leaf}
        # expand by base-name ancestry in both directions until fixpoint
        all_classes = [
            (m.name, ci) for m in ctx.modules.values()
            for ci in m.classes.values()
        ]
        changed = True
        while changed:
            changed = False
            for mod, ci in all_classes:
                cleaf = ci.name.split(".")[-1]
                base_leaves = {b[-1] for b in ci.bases}
                if cleaf in family and not base_leaves <= family:
                    family |= base_leaves
                    changed = True
                elif base_leaves & family and cleaf not in family:
                    family.add(cleaf)
                    changed = True
        for mod, ci in all_classes:
            if ci.name.split(".")[-1] in family and meth in ci.methods:
                out.add(ci.methods[meth])
        return out

    # -- seeding + reachability --------------------------------------------
    def _seed(self, ctx: LintContext, seeds) -> None:
        fn_names = set(seeds.get("functions", ()))
        keys = set(seeds.get("keys", ()))
        meth_names = set(seeds.get("engine_methods", ()))
        suffixes = tuple(seeds.get("suffixes", ()))
        wrapper_pkgs = tuple(seeds.get("wrapper_packages", ()))
        for mi in ctx.modules.values():
            # `*_kernel` suffix seeding is scoped to kernels packages so a
            # host-side `_bench_pallas_kernel` helper in benchmarks/ does
            # not masquerade as a device kernel ...
            kernels_pkg = SUFFIX_PACKAGE in mi.name.split(".")
            for fi in mi.functions.values():
                if fi.key in keys:
                    self.seeds.add(fi.key)
                elif fi.name in fn_names and fi.class_name is None:
                    self.seeds.add(fi.key)
                elif kernels_pkg and suffixes and fi.name.endswith(suffixes):
                    self.seeds.add(fi.key)
                elif (
                    fi.name in meth_names
                    and fi.class_name is not None
                    and f"{mi.name}:{fi.class_name}" in self.engine_classes
                ):
                    self.seeds.add(fi.key)
            # ... and any function actually handed to pallas_call() is a
            # kernel body wherever it lives.
            for fi in mi.functions.values():
                for call in fi.calls:
                    if call.name == HANDED_TO:
                        for ref in call.arg_chains:
                            self.seeds |= self.resolve(
                                ctx, mi, fi, ref, reference=True
                            )
            for call in mi.calls:
                if not call.stack and call.name == HANDED_TO:
                    for ref in call.arg_chains:
                        self.seeds |= self.resolve(
                            ctx, mi, None, ref, reference=True
                        )
            if any(_in_package(mi.name, p) for p in wrapper_pkgs):
                self.seeds |= set(kernel_wrappers(mi))
        for key in self.seeds:
            fi = ctx.function(key)
            if fi is not None and fi.whiles:
                self.round_loops.add(key)

    def _reach(self) -> None:
        stack = list(self.seeds)
        self.hot = set(self.seeds)
        while stack:
            cur = stack.pop()
            for nxt in self.edges.get(cur, ()):
                if nxt not in self.hot:
                    self.hot.add(nxt)
                    stack.append(nxt)

    # -- queries ------------------------------------------------------------
    def is_hot(self, key: str) -> bool:
        return key in self.hot

    def hot_functions(self, ctx: LintContext):
        for key in sorted(self.hot):
            fi = ctx.function(key)
            if fi is not None:
                yield fi


def kernel_wrappers(mi: ModuleInfo) -> List[str]:
    """The launch functions and wrappers of a kernel module (one that
    defines a module-level `_launch*` function): every `_launch*` function
    and every public module-level function but the `*_plain` versions.
    Empty for any other module."""
    top = [fi for fi in mi.functions.values()
           if fi.parent is None and fi.class_name is None]
    if not any(fi.name.startswith(LAUNCH_PREFIX) for fi in top):
        return []
    return [fi.key for fi in top
            if fi.name.startswith(LAUNCH_PREFIX)
            or (not fi.name.startswith("_") and not fi.name.endswith(PLAIN_SUFFIX))]
