"""The rule catalog of the port (counterpart of `repro.lint.rules`; the
README's "The hot-path lint" renders the table).

Each rule is numbered after the reference rule it ports (RPT0xx for
RPR0xx), so a suppression in one package never silences a rule of the
other.  RPT001–RPT005 are module-scoped, like the reference's guards;
RPT010+ predicate on the call graph's hot set — every function statically
reachable from the port's round loop, its engines' round bodies and its
kernel wrappers (`callgraph.DEFAULT_SEEDS`).

The invariants are the reference's, read for eager PyTorch on a card: one
host sync a round, no 64-bit creep, packed stays packed, no hidden
fallback.  Where the reference's jit freezes impure values at trace time,
the port's invariant is its rule of explicit generators.

Adding a rule: write a generator over `LintContext` yielding `Finding`s,
wrap it in a `Rule` with an unused RPT0xx id, and append it to ALL_RULES.
A new engine inherits every hot-path rule the moment its class derives
from `TorchRoundEngine`.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.lint.analysis import (
    CallInfo,
    FunctionInfo,
    LintContext,
    ModuleInfo,
    attr_chain,
)
from repro_torch.lint.callgraph import (
    LAUNCH_PREFIX,
    PLAIN_SUFFIX,
    _in_package as _in_pkg,
    kernel_wrappers,
)
from repro_torch.lint.model import Finding, Rule, Severity

# --------------------------------------------------------------------------
# vocabulary
# --------------------------------------------------------------------------
TILE_UNPACKS = ("unpack_tile_bits", "unpack_tile_mask")
TILE_DENSE_DISPATCH = ("dense_tiles", "dense_tile_mask")
DENSIFY_CALLS = TILE_UNPACKS + TILE_DENSE_DISPATCH
FRONTIER_UNPACKS = ("unpack_frontier_bits", "unpack_frontier_words")
ORACLE_SUFFIXES = (PLAIN_SUFFIX, "_oracle")

HOPPER_PKG = "repro_torch.hopper"
DYNGRAPH_PKG = "repro_torch.dyngraph"
HOT_PKGS = ("repro_torch.core", "repro_torch.hopper")
TILING_MODULE = "repro_torch.core.tiling"
ENGINE_MODULE = "repro_torch.core.engine"
FRONTIER_SEAMS = {
    ("repro_torch.core.tc_mis", "_result"),
    ("repro_torch.core.distributed", "gather_bool"),
}

# RPT005: explicit waits on the card
SYNC_CALLS = ("synchronize",)
# RPT010: tensor methods that copy to the host or size an output by a read
HOST_COPY_METHODS = ("item", "tolist", "cpu", "numpy")
SIZED_BY_DATA = ("nonzero", "argwhere", "unique", "unique_consecutive",
                 "masked_select", "bincount")
PY_SCALARS = ("int", "float", "bool")
# tensor methods whose result a Python scalar conversion or a branch reads
TENSOR_VALUE_METHODS = (
    "any", "all", "sum", "mean", "prod", "max", "min", "amax", "amin",
    "argmax", "argmin", "count_nonzero", "norm", "std", "var", "median",
    "eq", "ne", "lt", "le", "gt", "ge", "equal", "allclose", "isclose",
    "logical_and", "logical_or", "logical_not", "logical_xor", "abs",
    "squeeze", "reshape", "view", "flatten", "to", "float", "long", "int",
    "bool", "double", "cumsum", "dot", "clone",
)
# RPT011: draws of the global generator unless `generator=` is given
TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "bernoulli",
               "multinomial", "normal", "poisson")
TORCH_LIKE_DRAWS = ("rand_like", "randn_like", "randint_like")
TENSOR_DRAWS = ("bernoulli_", "uniform_", "normal_", "random_",
                "exponential_", "geometric_", "cauchy_", "log_normal_")
IMPURE_STDLIB = ("random", "time", "datetime")
# RPT012: 64-bit dtypes
DTYPE64 = ("int64", "long", "float64", "double", "uint64", "complex128",
           "cdouble")
CASTS64 = ("long", "double")
INT64_DEFAULTS = ("arange", "randint", "randperm")
# ops that take int64 indices only: method name -> index argument position
INDEX64_OPS = {
    "index_copy_": 1, "index_copy": 1,
    "scatter": 1, "scatter_": 1, "scatter_add": 1, "scatter_add_": 1,
    "scatter_reduce": 1, "scatter_reduce_": 1, "gather": 1,
}
# RPT013
LOOP_GROWING = ("cat", "concat", "concatenate", "stack", "hstack", "vstack",
                "dstack", "column_stack", "append")
# RPT014: the engine spellings `core.engine.get_engine` warns about
DEPRECATED_ENGINES = ("ref", "pallas")
# RPT015: what must never sit inside a `try` with a handler
LOAD_CALLS = ("library", "entry", "build_all")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _symbol(stack: Tuple[str, ...]) -> str:
    return ".".join(stack) if stack else "<module>"


def _mk(
    mi: ModuleInfo, rule_id: str, severity: str, node, symbol: str, msg: str
) -> Finding:
    return Finding(
        rule=rule_id,
        severity=severity,
        path=mi.rel,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0) + 1,
        module=mi.name,
        symbol=symbol,
        message=msg,
    )


def _import_target(mi: ModuleInfo, alias: str) -> Optional[str]:
    """Dotted module or symbol an alias refers to (`np` -> `numpy`,
    `F` -> `torch.nn.functional`)."""
    tgt = mi.imports.get(alias)
    if tgt is None:
        return None
    if tgt[0] == "module":
        return tgt[1]
    return f"{tgt[1]}.{tgt[2]}"


def _rooted_at(mi: ModuleInfo, name: str, package: str) -> bool:
    tgt = _import_target(mi, name)
    return tgt is not None and (tgt == package or tgt.startswith(package + "."))


def _is_torch_rooted(mi: ModuleInfo, name: str) -> bool:
    return _rooted_at(mi, name, "torch")


def _is_numpy_rooted(mi: ModuleInfo, name: str) -> bool:
    return _rooted_at(mi, name, "numpy")


def _method_call(mi: ModuleInfo, node: ast.AST) -> bool:
    """A call of a tensor method that yields a tensor's value: `x.any()`,
    `state.alive.sum()`, `(a & b).any()` — not a call of a module's
    function, nor a host method (`t.is_contiguous()`, `d.get(k)`)."""
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in TENSOR_VALUE_METHODS:
        return False
    chain = attr_chain(node.func)
    return chain is None or chain[0] not in mi.imports


def _torch_call(mi: ModuleInfo, node: ast.AST) -> bool:
    """A call of a torch function that yields a tensor (not one of the
    host predicates `torch.is_*`, `torch.cuda.*`)."""
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    if not chain or len(chain) < 2 or not _is_torch_rooted(mi, chain[0]):
        return False
    return not chain[-1].startswith("is_") and "cuda" not in chain


def _tensor_rooted(mi: ModuleInfo, node: ast.AST) -> bool:
    """Is the expression, under subscripts and unary operators, a call
    rooted at `torch` or a method call on a value?  `bool(alive.any())`
    and `int(torch.sum(x))` yes; `int(T // 32)` and `int(cfg.max_rounds)`
    no.  A plain `int(x)` of a tensor local is a documented miss."""
    while isinstance(node, (ast.Subscript, ast.UnaryOp)):
        node = node.value if isinstance(node, ast.Subscript) else node.operand
    return _torch_call(mi, node) or _method_call(mi, node)


def _keyword(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _own_nodes(fi: FunctionInfo) -> Iterator[ast.AST]:
    """Every node of the function's body, nested defs and classes left to
    their own FunctionInfo (lambdas stay, as their calls do)."""
    stack = list(fi.node.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                stack.append(child)


def _hot_report_functions(ctx: LintContext) -> Iterator[FunctionInfo]:
    for fi in ctx.graph.hot_functions(ctx):
        if fi.module in ctx.report:
            yield fi


def _stack_is_sanctioned(stack: Tuple[str, ...], *suffixes: str) -> bool:
    return any(fn.endswith(tuple(suffixes)) for fn in stack)


def _callee_name(mi: ModuleInfo, call: CallInfo) -> Optional[str]:
    """The callee's own name: a bare alias resolved through the import
    table (`load` -> `library`), else the chain's last part."""
    if not call.chain:
        return None
    if len(call.chain) == 1:
        tgt = mi.imports.get(call.chain[0])
        if tgt and tgt[0] == "symbol":
            return tgt[2]
    return call.chain[-1]


# --------------------------------------------------------------------------
# RPT001 + RPT002 — kernel modules keep tiles as stored
# --------------------------------------------------------------------------
def _hopper_calls(ctx: LintContext, names: Sequence[str]):
    for mi in ctx.report_modules():
        if not _in_pkg(mi.name, HOPPER_PKG):
            continue
        for call in mi.calls:
            if call.name in names and not _stack_is_sanctioned(
                call.stack, PLAIN_SUFFIX
            ):
                yield mi, call


def _check_kernel_tile_unpack(ctx: LintContext) -> Iterator[Finding]:
    for mi, call in _hopper_calls(ctx, TILE_UNPACKS):
        yield _mk(
            mi, "RPT001", Severity.ERROR, call.node, _symbol(call.stack),
            f"{call.name} outside a *{PLAIN_SUFFIX} body in a kernel module "
            f"— a wrapper or launch hands the kernel its tiles as stored; "
            f"an unpack materialises (nt, T, T) on the card",
        )


def _check_kernel_densify(ctx: LintContext) -> Iterator[Finding]:
    for mi, call in _hopper_calls(ctx, TILE_DENSE_DISPATCH + ("to_storage",)):
        yield _mk(
            mi, "RPT002", Severity.ERROR, call.node, _symbol(call.stack),
            f"{call.name} outside a *{PLAIN_SUFFIX} body in a kernel module "
            f"— whole-array densify belongs to the plain versions; kernels "
            f"consume tiles as stored",
        )


# --------------------------------------------------------------------------
# RPT003 — the dyngraph delta path never densifies outside oracles
# --------------------------------------------------------------------------
def _check_dyngraph_densify(ctx: LintContext) -> Iterator[Finding]:
    watched = DENSIFY_CALLS + ("to_storage",)
    for mi in ctx.report_modules():
        if not _in_pkg(mi.name, DYNGRAPH_PKG):
            continue
        for call in mi.calls:
            if call.name in watched and not _stack_is_sanctioned(
                call.stack, *ORACLE_SUFFIXES
            ):
                yield _mk(
                    mi, "RPT003", Severity.ERROR, call.node,
                    _symbol(call.stack),
                    f"{call.name} outside a *{PLAIN_SUFFIX}/*_oracle body — "
                    f"the delta path edits packed tiles as packed words, "
                    f"never densifies",
                )


# --------------------------------------------------------------------------
# RPT004 — frontier words stay packed outside the sanctioned seams
# --------------------------------------------------------------------------
def _frontier_sanctioned(module: str, stack: Tuple[str, ...]) -> bool:
    seams = {fn for (mod, fn) in FRONTIER_SEAMS if mod == module}
    return _stack_is_sanctioned(stack, *ORACLE_SUFFIXES) or any(
        fn in seams for fn in stack
    )


def _check_frontier_unpack(ctx: LintContext) -> Iterator[Finding]:
    for mi in ctx.report_modules():
        if not _in_pkg(mi.name, "repro_torch") or mi.name == TILING_MODULE:
            continue
        for call in mi.calls:
            if call.name in FRONTIER_UNPACKS and not _frontier_sanctioned(
                mi.name, call.stack
            ):
                yield _mk(
                    mi, "RPT004", Severity.ERROR, call.node,
                    _symbol(call.stack),
                    f"{call.name} outside a *{PLAIN_SUFFIX}/*_oracle body or "
                    f"a seam (tc_mis._result, distributed.gather_bool) — "
                    f"frontier vectors stay packed words through the round",
                )


# --------------------------------------------------------------------------
# RPT005 — no explicit waits or prints in device-hot modules
# --------------------------------------------------------------------------
def _check_host_callbacks(ctx: LintContext) -> Iterator[Finding]:
    for mi in ctx.report_modules():
        if not any(_in_pkg(mi.name, p) for p in HOT_PKGS):
            continue
        for call in mi.calls:
            func = call.node.func
            if isinstance(func, ast.Attribute) and func.attr in SYNC_CALLS:
                shown = ".".join(call.chain) if call.chain else f"....{func.attr}"
                yield _mk(
                    mi, "RPT005", Severity.ERROR, call.node,
                    _symbol(call.stack),
                    f"`{shown}()` in a device-hot module — an "
                    f"explicit wait drains the stream the round queues on; "
                    f"round observability goes through the telemetry buffer "
                    f"(repro_torch.obs.rounds)",
                )
            elif call.chain == ("print",):
                yield _mk(
                    mi, "RPT005", Severity.ERROR, call.node,
                    _symbol(call.stack),
                    "print() in a device-hot module — printing a tensor "
                    "copies it to the host, a round trip per round",
                )


# --------------------------------------------------------------------------
# RPT010 — host syncs on the hot path
# --------------------------------------------------------------------------
def _to_cpu(mi: ModuleInfo, call: ast.Call) -> bool:
    """`.to("cpu")`, `.to(device="cpu")`, `.to(torch.device("cpu"))`."""
    args = list(call.args[:1])
    dev = _keyword(call, "device")
    if dev is not None:
        args.append(dev)
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (
            isinstance(a, ast.Call)
            and _torch_call(mi, a)
            and a.args
            and isinstance(a.args[0], ast.Constant)
            and a.args[0].value == "cpu"
        ):
            return True
    return False


def _host_sync(mi: ModuleInfo, call: CallInfo) -> Optional[str]:
    """What makes the call a host sync, or None."""
    chain, node = call.chain, call.node
    if chain is None:
        # `(a & b).any()`-style receivers: only the method name is known
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if name in HOST_COPY_METHODS or name in SIZED_BY_DATA:
                return f".{name}()"
        return None
    name = chain[-1]
    if len(chain) >= 2:
        torch_fn = _is_torch_rooted(mi, chain[0])
        if not torch_fn and name in HOST_COPY_METHODS:
            return f".{name}()"
        if name == "to" and not torch_fn and _to_cpu(mi, node):
            return '.to("cpu")'
        if name in SIZED_BY_DATA:
            return f"`{'.'.join(chain)}`"
        if torch_fn and name == "where" and len(node.args) == 1:
            return "one-argument `torch.where` (a nonzero)"
        if (
            torch_fn
            and name == "repeat_interleave"
            and _keyword(node, "output_size") is None
        ):
            return "`torch.repeat_interleave` without output_size="
        if _is_numpy_rooted(mi, chain[0]):
            return f"numpy call `{'.'.join(chain)}`"
    elif name in PY_SCALARS and any(_tensor_rooted(mi, a) for a in node.args):
        return f"{name}() over a tensor expression"
    return None


def _check_host_sync(ctx: LintContext) -> Iterator[Finding]:
    for fi in _hot_report_functions(ctx):
        mi = ctx.modules[fi.module]
        for call in fi.calls:
            what = _host_sync(mi, call)
            if what:
                yield _mk(
                    mi, "RPT010", Severity.ERROR, call.node, fi.qualname,
                    f"{what} in hot `{fi.qualname}` — a device->host sync on "
                    f"the hot path stalls the host until the card drains; "
                    f"the round loop allows one a round",
                )
        for node in _own_nodes(fi):
            if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                continue
            test = node.test
            if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
                test = test.operand
            if _method_call(mi, test) or _torch_call(mi, test):
                kind = "while" if isinstance(node, ast.While) else "if"
                yield _mk(
                    mi, "RPT010", Severity.ERROR, node, fi.qualname,
                    f"`{kind}` on a tensor call in hot `{fi.qualname}` — the "
                    f"branch reads the value on the host (a sync)",
                )


# --------------------------------------------------------------------------
# RPT011 — reproducibility on the hot path
# --------------------------------------------------------------------------
def _check_reproducibility(ctx: LintContext) -> Iterator[Finding]:
    for fi in _hot_report_functions(ctx):
        mi = ctx.modules[fi.module]
        for line in fi.global_decls:
            anchor = type("A", (), {"lineno": line, "col_offset": 0})
            yield _mk(
                mi, "RPT011", Severity.ERROR, anchor, fi.qualname,
                f"global/nonlocal write in hot `{fi.qualname}` — a round "
                f"depends only on its inputs and its explicit generator",
            )
        for call in fi.calls:
            if call.chain is None:
                continue
            dotted = ".".join(call.chain)
            name = call.chain[-1]
            if len(call.chain) >= 2 and _is_torch_rooted(mi, call.chain[0]):
                if name in TORCH_LIKE_DRAWS or (
                    name in TORCH_DRAWS and _keyword(call.node, "generator") is None
                ):
                    yield _mk(
                        mi, "RPT011", Severity.ERROR, call.node, fi.qualname,
                        f"`{dotted}` draws from the global generator in hot "
                        f"`{fi.qualname}` — pass generator= (a solve draws "
                        f"from the torch.Generator its caller gives)",
                    )
                continue
            if len(call.chain) >= 2 and name in TENSOR_DRAWS and (
                _keyword(call.node, "generator") is None
            ):
                yield _mk(
                    mi, "RPT011", Severity.ERROR, call.node, fi.qualname,
                    f"`.{name}()` draws from the global generator in hot "
                    f"`{fi.qualname}` — pass generator=",
                )
            elif len(call.chain) >= 2:
                tgt = _import_target(mi, call.chain[0])
                if tgt is not None and tgt.split(".")[0] in IMPURE_STDLIB:
                    yield _mk(
                        mi, "RPT011", Severity.ERROR, call.node, fi.qualname,
                        f"`{dotted}` in hot `{fi.qualname}` — stdlib "
                        f"{tgt.split('.')[0]} makes a round depend on the "
                        f"host's state",
                    )
                elif (
                    _is_numpy_rooted(mi, call.chain[0])
                    and len(call.chain) >= 3
                    and call.chain[1] == "random"
                ):
                    yield _mk(
                        mi, "RPT011", Severity.ERROR, call.node, fi.qualname,
                        f"`{dotted}` in hot `{fi.qualname}` — numpy's RNG is "
                        f"not the solve's generator",
                    )
            elif call.chain == ("print",):
                yield _mk(
                    mi, "RPT011", Severity.ERROR, call.node, fi.qualname,
                    f"print() in hot `{fi.qualname}` — output on the hot "
                    f"path is the telemetry buffer's job",
                )


# --------------------------------------------------------------------------
# RPT012 — dtype discipline on the hot path (no 64-bit creep)
# --------------------------------------------------------------------------
def _dtype64_expr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name) and node.id in ("float", "int"):
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in DTYPE64:
        return node.attr
    if isinstance(node, ast.Constant) and node.value in DTYPE64:
        return str(node.value)
    return None


def _int_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    )


def _int_data(node: ast.AST) -> bool:
    """An integer literal or a list/tuple holding only integer literals."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return bool(node.elts) and all(_int_data(e) for e in node.elts)
    return _int_literal(node)


def _index_positions(fi: FunctionInfo) -> set:
    """ids of the nodes that sit in an index position: the index argument
    of an op that takes int64 indices only, or a subscript's slice."""
    out = set()
    for node in _own_nodes(fi):
        roots: List[ast.AST] = []
        if isinstance(node, ast.Subscript):
            roots.append(node.slice)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if name in INDEX64_OPS:
                pos = INDEX64_OPS[name]
                chain = attr_chain(node.func)
                # `torch.gather(input, dim, index)` carries the input first
                if chain and len(chain) == 2 and chain[0] == "torch":
                    pos += 1
                if len(node.args) > pos:
                    roots.append(node.args[pos])
                kw = _keyword(node, "index")
                if kw is not None:
                    roots.append(kw)
        for r in roots:
            out.update(id(n) for n in ast.walk(r))
    return out


def _dtype_hits(mi: ModuleInfo, call: ast.Call) -> List[str]:
    chain = attr_chain(call.func)
    name = call.func.attr if isinstance(call.func, ast.Attribute) else (
        chain[-1] if chain else None)
    hits: List[str] = []
    dtype_kw = _keyword(call, "dtype")
    if dtype_kw is not None:
        d = _dtype64_expr(dtype_kw)
        if d:
            hits.append(f"dtype={d}")
    torch_fn = bool(chain) and len(chain) >= 2 and _is_torch_rooted(mi, chain[0])
    if name in CASTS64 and not call.args and not torch_fn:
        hits.append(f".{name}()")
    elif name in ("to", "type") and not torch_fn and call.args:
        d = _dtype64_expr(call.args[0])
        if d:
            hits.append(f".{name}({d})")
    if torch_fn and dtype_kw is None:
        if name in INT64_DEFAULTS:
            hits.append(f"torch.{name} without dtype= (int64 by default)")
        elif name in ("tensor", "as_tensor") and call.args and _int_data(call.args[0]):
            hits.append(f"torch.{name} of integers without dtype= (int64)")
        elif name == "full" and len(call.args) >= 2 and _int_literal(call.args[1]):
            hits.append("torch.full with an int fill without dtype= (int64)")
    return hits


def _check_dtype(ctx: LintContext) -> Iterator[Finding]:
    for fi in _hot_report_functions(ctx):
        mi = ctx.modules[fi.module]
        escaped = None
        for call in fi.calls:
            hits = _dtype_hits(mi, call.node)
            if not hits:
                continue
            if escaped is None:
                escaped = _index_positions(fi)
            for h in hits:
                cast = h.startswith(".")
                if cast and id(call.node) in escaped:
                    continue   # written where an index op needs int64
                yield _mk(
                    mi, "RPT012", Severity.ERROR, call.node, fi.qualname,
                    f"{h} in hot `{fi.qualname}` — 64-bit on the hot path "
                    f"doubles the bytes it moves; carried state and tiles "
                    f"stay 32-bit (cast in the index position of an op that "
                    f"needs int64)",
                )


# --------------------------------------------------------------------------
# RPT013 — loop-carry hygiene inside the round loops
# --------------------------------------------------------------------------
def _growing_call(mi: ModuleInfo, node: ast.Call) -> Optional[str]:
    chain = attr_chain(node.func)
    if not chain or chain[-1] not in LOOP_GROWING or len(chain) < 2:
        return None
    if _is_torch_rooted(mi, chain[0]) or _is_numpy_rooted(mi, chain[0]):
        return ".".join(chain)
    if chain[-1] == "append":
        return ".".join(chain)   # a list that grows a round
    return None


def _while_body_nodes(loop: ast.While) -> Iterator[ast.AST]:
    stack = list(loop.body) + list(loop.orelse)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ):
                stack.append(child)


def _check_loop_carry(ctx: LintContext) -> Iterator[Finding]:
    for key in sorted(ctx.graph.round_loops):
        fi = ctx.function(key)
        if fi is None or fi.module not in ctx.report:
            continue
        mi = ctx.modules[fi.module]
        for loop in fi.whiles:
            for node in _while_body_nodes(loop):
                if isinstance(node, ast.Call):
                    name = _growing_call(mi, node)
                    if name:
                        yield _mk(
                            mi, "RPT013", Severity.ERROR, node, fi.qualname,
                            f"`{name}` inside the round loop of "
                            f"`{fi.qualname}` — round state keeps fixed "
                            f"shapes; preallocate and write in place (as the "
                            f"telemetry buffer is)",
                        )


# --------------------------------------------------------------------------
# RPT014 — deprecated shims: the engine spellings get_engine warns about
# --------------------------------------------------------------------------
def _deprecated_engine(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and node.value in DEPRECATED_ENGINES:
        return node.value
    return None


def _check_deprecation(ctx: LintContext) -> Iterator[Finding]:
    for mi in ctx.report_modules():
        if mi.name == ENGINE_MODULE or "test" in mi.name.split(".")[-1]:
            continue
        for call in mi.calls:
            spelled = _deprecated_engine(_keyword(call.node, "engine"))
            if spelled is None and call.name == "get_engine" and call.node.args:
                spelled = _deprecated_engine(call.node.args[0])
            if spelled:
                yield _mk(
                    mi, "RPT014", Severity.ERROR, call.node,
                    _symbol(call.stack),
                    f"deprecated engine spelling {spelled!r} — use the "
                    f"registered name (tiled_ref / tiled_pallas)",
                )


# --------------------------------------------------------------------------
# RPT015 — kernel-wrapper hygiene: the device rule made static
# --------------------------------------------------------------------------
def _kernel_module(mi: ModuleInfo) -> bool:
    return _in_pkg(mi.name, HOPPER_PKG) and bool(kernel_wrappers(mi))


def _guarded_calls(mi: ModuleInfo) -> Iterator[Tuple[ast.Try, ast.Call]]:
    """Calls inside the body of a `try` that has a handler."""
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Try) and node.handlers:
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        yield node, sub


def _check_wrapper_hygiene(ctx: LintContext) -> Iterator[Finding]:
    for mi in ctx.report_modules():
        if not _in_pkg(mi.name, "repro_torch"):
            continue
        if _kernel_module(mi):
            for call in mi.calls:
                if call.name is None or not call.name.endswith(PLAIN_SUFFIX):
                    continue
                if any(fn.startswith(LAUNCH_PREFIX) for fn in call.stack):
                    yield _mk(
                        mi, "RPT015", Severity.ERROR, call.node,
                        _symbol(call.stack),
                        f"{call.name} called from a launch function — a "
                        f"launch runs the kernel or raises; it never "
                        f"computes the plain version",
                    )
                elif not call.cpu_only and not _stack_is_sanctioned(
                    call.stack, PLAIN_SUFFIX
                ):
                    yield _mk(
                        mi, "RPT015", Severity.ERROR, call.node,
                        _symbol(call.stack),
                        f"{call.name} called outside `if on_cpu(...)` — a "
                        f"wrapper runs its plain version only because its "
                        f"tensors lie on the CPU",
                    )
        stack_of = {id(c.node): c for c in mi.calls}
        for _, node in _guarded_calls(mi):
            call = stack_of.get(id(node))
            if call is None:
                continue
            name = _callee_name(mi, call)
            if name and (name.startswith(LAUNCH_PREFIX) or name in LOAD_CALLS):
                yield _mk(
                    mi, "RPT015", Severity.ERROR, node, _symbol(call.stack),
                    f"`{name}(...)` inside a try with a handler — a kernel "
                    f"that does not build, load or launch raises; nothing "
                    f"falls back",
                )


# --------------------------------------------------------------------------
# RPT016 — hot-path densify: the call-graph generalisation of RPT004
# --------------------------------------------------------------------------
def _check_hot_densify(ctx: LintContext) -> Iterator[Finding]:
    watched = FRONTIER_UNPACKS + ("to_storage",)
    for fi in _hot_report_functions(ctx):
        if fi.module == TILING_MODULE:
            continue
        mi = ctx.modules[fi.module]
        for call in fi.calls:
            if call.name not in watched or _frontier_sanctioned(
                fi.module, call.stack
            ):
                continue
            yield _mk(
                mi, "RPT016", Severity.ERROR, call.node, fi.qualname,
                f"{call.name} in hot `{fi.qualname}` — a densify reached "
                f"from the round loop or an engine smuggles a dense round "
                f"trip into the packed round, wherever the helper lives",
            )


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
ALL_RULES: Tuple[Rule, ...] = (
    Rule(
        id="RPT001", name="kernel-tile-unpack", severity=Severity.ERROR,
        summary="tile unpack outside a *_plain body in repro_torch.hopper",
        rationale="packed tiles stay packed until the kernel reads them; an "
                  "unpack in a wrapper or launch materialises (nt,T,T) on "
                  "the card (RPR001)",
        escapes="*_plain bodies (the port's plain versions)",
        check=_check_kernel_tile_unpack,
    ),
    Rule(
        id="RPT002", name="kernel-densify", severity=Severity.ERROR,
        summary="dense_tiles/dense_tile_mask/to_storage in repro_torch.hopper "
                "outside *_plain",
        rationale="whole-array densify belongs to the plain versions; "
                  "kernels consume tiles as stored (RPR002)",
        escapes="*_plain bodies",
        check=_check_kernel_densify,
    ),
    Rule(
        id="RPT003", name="dyngraph-densify", severity=Severity.ERROR,
        summary="densify on the dyngraph delta path outside *_plain/*_oracle",
        rationale="delta application edits packed tiles as packed words; a "
                  "densify turns the O(delta) patch into O(tiles) (RPR003)",
        escapes="*_plain and *_oracle bodies",
        check=_check_dyngraph_densify,
    ),
    Rule(
        id="RPT004", name="frontier-unpack", severity=Severity.ERROR,
        summary="frontier unpack outside plain/oracle/seam (module-scoped)",
        rationale="frontier vectors ride the round as packed words; one "
                  "unpack at the epilogue only (RPR004)",
        escapes="core/tiling.py, *_plain/*_oracle bodies, tc_mis._result, "
                "distributed.gather_bool",
        check=_check_frontier_unpack,
    ),
    Rule(
        id="RPT005", name="host-round-trip", severity=Severity.ERROR,
        summary="synchronize()/print in repro_torch.core and .hopper",
        rationale="an explicit wait or a print is a host round trip; a "
                  "round's observability is the telemetry buffer (RPR005)",
        escapes="suppress on the def line for host-stepped loops (the "
                "run_phases profiler twin)",
        check=_check_host_callbacks,
    ),
    Rule(
        id="RPT010", name="hot-host-sync", severity=Severity.ERROR,
        summary=".item/.tolist/.cpu/.numpy/nonzero/unique/int(t)/if t.any() "
                "on the hot path",
        rationale="a host sync anywhere the round loop, an engine or a "
                  "wrapper reaches stalls the host until the card drains; "
                  "the loop allows one a round (RPR010)",
        escapes="inline suppression with its reason: the one sanctioned "
                "sync a round (`bool(state.alive.any())`), once-a-solve "
                "set-up; the def line for host-stepped loops",
        check=_check_host_sync,
    ),
    Rule(
        id="RPT011", name="reproducibility", severity=Severity.ERROR,
        summary="draws without generator=, stdlib random/time, np.random, "
                "print, global writes on the hot path",
        rationale="a solve is a function of its inputs and the generator its "
                  "caller gives; eager torch has no trace-time freeze, so "
                  "this is the port's form of trace purity (RPR011)",
        escapes="suppress on the def line for host-stepped loops",
        check=_check_reproducibility,
    ),
    Rule(
        id="RPT012", name="dtype-discipline", severity=Severity.ERROR,
        summary="int64/float64 dtypes, .long()/.double(), int64-default "
                "constructors on the hot path",
        rationale="64-bit state doubles the bytes a memory-bound round "
                  "moves; carried state and tiles stay 32-bit (RPR012)",
        escapes="a cast written in the index position of an op that takes "
                "int64 only (index_copy_, scatter*, gather) or inside a "
                "subscript; inline suppression with its reason",
        check=_check_dtype,
    ),
    Rule(
        id="RPT013", name="loop-carry-hygiene", severity=Severity.ERROR,
        summary="torch.cat/stack, np.concatenate, list.append inside a "
                "seeded round loop",
        rationale="round state keeps fixed shapes and is preallocated; a "
                  "growing carry allocates and copies every round (RPR013)",
        escapes="none — preallocate and write in place",
        check=_check_loop_carry,
    ),
    Rule(
        id="RPT014", name="deprecated-shim", severity=Severity.ERROR,
        summary="internal use of the deprecated engine spellings "
                "'ref'/'pallas'",
        rationale="the port's only shims are get_engine's aliases, which "
                  "warn; internal callers spell the registered name "
                  "(RPR014)",
        escapes="core/engine.py (the alias table) and tests",
        check=_check_deprecation,
    ),
    Rule(
        id="RPT015", name="kernel-wrapper-hygiene", severity=Severity.ERROR,
        summary="*_plain outside `if on_cpu(...)`, in a _launch*, or a "
                "launch/load/build inside try/except",
        rationale="a wrapper launches its kernel on CUDA tensors or raises; "
                  "it runs the plain version only because its tensors lie "
                  "on the CPU (the device rule made static; RPR015)",
        escapes="*_plain bodies; try/finally (no handler)",
        check=_check_wrapper_hygiene,
    ),
    Rule(
        id="RPT016", name="hot-densify", severity=Severity.ERROR,
        summary="frontier unpack / to_storage anywhere hot",
        rationale="the call-graph generalisation of RPT004: a densify "
                  "smuggled in via any module still lands in the round if "
                  "the hot path reaches it (RPR016)",
        escapes="core/tiling.py (the substrate), *_plain/*_oracle bodies, "
                "the RPT004 seams",
        check=_check_hot_densify,
    ),
)

_BY_ID = {r.id: r for r in ALL_RULES}


def get_rules(ids: Optional[Sequence[str]] = None) -> List[Rule]:
    if not ids:
        return list(ALL_RULES)
    unknown = [i for i in ids if i not in _BY_ID]
    if unknown:
        raise KeyError(f"unknown rule id(s): {', '.join(unknown)}")
    return [_BY_ID[i] for i in ids]


def run_rules(
    ctx: LintContext, rules: Optional[Iterable[Rule]] = None
) -> List[Finding]:
    """Run the catalog and apply inline suppressions.  Baseline matching is
    the caller's job (repro_torch.lint.cli) — rules stay baseline-agnostic."""
    import dataclasses

    from repro_torch.lint.model import sort_findings

    out: List[Finding] = []
    for rule in rules if rules is not None else ALL_RULES:
        for f in rule.run(ctx):
            mi = ctx.modules.get(f.module)
            if mi is not None:
                disabled = mi.disabled_rules(f.line)
                if f.rule in disabled or "all" in disabled:
                    f = dataclasses.replace(f, suppressed=True)
            out.append(f)
    return sort_findings(out)
