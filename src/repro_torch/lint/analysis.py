"""AST universe loader: modules, functions, classes, imports, suppressions
(counterpart of `repro.lint.analysis`).

One parse pass per file builds everything the rules and the call graph need:

  * `FunctionInfo` per function/method (nested defs included, qualnames like
    `Outer.<locals>.inner` collapsed to `Outer.inner` for readability) with
    the calls made *directly* in its body (nested defs own their calls);
  * an import table mapping every local alias to the module or symbol it
    names — call resolution and the impurity/deprecation rules key off it;
  * inline suppression spans (`# repro-lint: disable=RPT0xx <reason>` on a
    flagged line, on a `def` signature line to cover the whole function, or
    `disable-file=` for the module);
  * the port's eager loops: every `while` statement of a function
    (`FunctionInfo.whiles`; the call graph keeps those of seeded
    functions as round loops), and every call in the true branch of an
    `if on_cpu(...)` test marked `cpu_only` (the plain-torch versions a
    kernel wrapper runs on CPU tensors alone; the call graph draws no edge
    for them).

Everything is syntactic — nothing is imported or executed, so the linter
runs on any tree (tmp-dir test fixtures included) without torch present.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable(?P<file>-file)?="
    r"(?P<rules>[A-Za-z0-9_,\s]*?)(?:\s+(?P<reason>\S.*))?$"
)

LOOP_CALLS = {"while_loop": 1, "fori_loop": 2, "scan": 0}  # name -> body arg pos
LOOP_BODY_KWARGS = {"while_loop": "body_fun", "fori_loop": "body_fun", "scan": "f"}
# the device test of a kernel wrapper (`repro_torch.hopper.launch.on_cpu`)
CPU_TEST = "on_cpu"


def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """`a.b.c` -> ("a", "b", "c"); None when the root is not a plain Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


@dataclasses.dataclass
class CallInfo:
    """One call site: the node, the dotted chain of its callee (when the
    callee is a Name/Attribute), and the enclosing-function name stack —
    the module-scoped rules predicate on `*_plain`/`*_oracle` stack
    membership.  `cpu_only` marks a call in the true branch of an
    `if on_cpu(...)` test."""

    node: ast.Call
    chain: Optional[Tuple[str, ...]]
    stack: Tuple[str, ...]
    arg_chains: Tuple[Tuple[str, ...], ...]
    cpu_only: bool = False

    @property
    def name(self) -> Optional[str]:
        return self.chain[-1] if self.chain else None


@dataclasses.dataclass
class FunctionInfo:
    module: str
    qualname: str
    name: str
    node: ast.AST                      # FunctionDef | AsyncFunctionDef
    lineno: int
    end_lineno: int
    body_lineno: int                   # first statement — end of the signature
    class_name: Optional[str]          # innermost enclosing class
    parent: Optional[str]              # enclosing function key, for nested defs
    calls: List[CallInfo] = dataclasses.field(default_factory=list)
    nested: List[str] = dataclasses.field(default_factory=list)
    global_decls: List[int] = dataclasses.field(default_factory=list)
    loop_lambdas: List[ast.Lambda] = dataclasses.field(default_factory=list)
    whiles: List[ast.While] = dataclasses.field(default_factory=list)
    is_loop_body: bool = False

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclasses.dataclass
class ClassInfo:
    module: str
    name: str
    bases: List[Tuple[str, ...]]
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)  # name -> fn key


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: pathlib.Path
    rel: str                            # root-relative posix path
    tree: ast.Module
    source: str
    imports: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    calls: List[CallInfo] = dataclasses.field(default_factory=list)  # all, any depth
    file_disables: Set[str] = dataclasses.field(default_factory=set)
    line_disables: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    span_disables: List[Tuple[int, int, Set[str]]] = dataclasses.field(
        default_factory=list
    )

    def disabled_rules(self, line: int) -> Set[str]:
        out = set(self.file_disables)
        out |= self.line_disables.get(line, set())
        for lo, hi, rules in self.span_disables:
            if lo <= line <= hi:
                out |= rules
        return out


def _module_name(root: pathlib.Path, path: pathlib.Path) -> str:
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else path.stem


def _resolve_relative(package: str, module: Optional[str], level: int) -> str:
    """`from ..x import y` inside `package` -> absolute dotted module."""
    if level == 0:
        return module or ""
    parts = package.split(".") if package else []
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    base = ".".join(parts)
    if module:
        return f"{base}.{module}" if base else module
    return base


class _Collector(ast.NodeVisitor):
    def __init__(self, mi: ModuleInfo, package: str):
        self.mi = mi
        self.package = package
        self.fn_stack: List[FunctionInfo] = []
        self.class_stack: List[ClassInfo] = []
        self.cpu_depth = 0

    # -- imports ------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname:
                self.mi.imports[a.asname] = ("module", a.name)
            else:
                # `import x.y` binds `x`; attribute chains re-join the rest
                self.mi.imports[a.name.split(".")[0]] = (
                    "module",
                    a.name.split(".")[0],
                )
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        src = _resolve_relative(self.package, node.module, node.level)
        for a in node.names:
            alias = a.asname or a.name
            if a.name == "*":
                continue
            self.mi.imports[alias] = ("symbol", src, a.name)
        self.generic_visit(node)

    # -- scopes -------------------------------------------------------------
    def _qualname(self, name: str) -> str:
        parts = [c.name for c in self.class_stack]
        parts += [f.name for f in self.fn_stack]
        parts.append(name)
        return ".".join(parts)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        ci = ClassInfo(
            module=self.mi.name,
            name=self._qualname(node.name),
            bases=[c for c in (attr_chain(b) for b in node.bases) if c],
        )
        self.mi.classes[ci.name] = ci
        self.class_stack.append(ci)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_fn(self, node) -> None:
        fi = FunctionInfo(
            module=self.mi.name,
            qualname=self._qualname(node.name),
            name=node.name,
            node=node,
            lineno=node.lineno,
            end_lineno=getattr(node, "end_lineno", node.lineno),
            body_lineno=node.body[0].lineno if node.body else node.lineno,
            class_name=self.class_stack[-1].name if self.class_stack else None,
            parent=self.fn_stack[-1].key if self.fn_stack else None,
        )
        self.mi.functions[fi.qualname] = fi
        if self.fn_stack:
            self.fn_stack[-1].nested.append(fi.key)
        elif self.class_stack:
            self.class_stack[-1].methods[node.name] = fi.key
        self.fn_stack.append(fi)
        self.generic_visit(node)
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _visit_global(self, node) -> None:
        if self.fn_stack:
            self.fn_stack[-1].global_decls.append(node.lineno)

    visit_Global = _visit_global
    visit_Nonlocal = _visit_global

    # -- the port's eager control flow ---------------------------------------
    def visit_While(self, node: ast.While) -> None:
        if self.fn_stack:
            self.fn_stack[-1].whiles.append(node)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        test = node.test
        chain = attr_chain(test.func) if isinstance(test, ast.Call) else None
        if not (chain and chain[-1] == CPU_TEST):
            self.generic_visit(node)
            return
        self.visit(test)
        self.cpu_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self.cpu_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        chain = attr_chain(node.func)
        args = tuple(
            c for c in (attr_chain(a) for a in node.args) if c is not None
        )
        info = CallInfo(
            node=node,
            chain=chain,
            stack=tuple(f.name for f in self.fn_stack),
            arg_chains=args,
            cpu_only=self.cpu_depth > 0,
        )
        self.mi.calls.append(info)
        if self.fn_stack:
            self.fn_stack[-1].calls.append(info)
            # loop-body marking: `lax.while_loop(cond, body, ...)` — record
            # lambda bodies here; Name bodies resolve in the call graph pass
            if chain and chain[-1] in LOOP_CALLS:
                pos = LOOP_CALLS[chain[-1]]
                body_arg = None
                if len(node.args) > pos:
                    body_arg = node.args[pos]
                else:
                    kw = LOOP_BODY_KWARGS[chain[-1]]
                    for k in node.keywords:
                        if k.arg == kw:
                            body_arg = k.value
                if isinstance(body_arg, ast.Lambda):
                    self.fn_stack[-1].loop_lambdas.append(body_arg)
        self.generic_visit(node)


def _scan_suppressions(mi: ModuleInfo) -> None:
    for lineno, line in enumerate(mi.source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        if not rules:
            continue
        if m.group("file"):
            mi.file_disables |= rules
            continue
        mi.line_disables.setdefault(lineno, set()).update(rules)
        # a disable on a `def` signature line covers the whole function body
        for fi in mi.functions.values():
            if fi.lineno <= lineno < max(fi.body_lineno, fi.lineno + 1):
                mi.span_disables.append((fi.lineno, fi.end_lineno, set(rules)))


def parse_module(
    root: pathlib.Path, path: pathlib.Path
) -> Optional[ModuleInfo]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    name = _module_name(root, path)
    mi = ModuleInfo(
        name=name,
        path=path,
        rel=path.relative_to(root).as_posix(),
        tree=tree,
        source=source,
    )
    package = name if path.name == "__init__.py" else name.rsplit(".", 1)[0]
    if "." not in name and path.name != "__init__.py":
        package = ""
    _Collector(mi, package).visit(tree)
    _scan_suppressions(mi)
    return mi


def find_root(path: pathlib.Path) -> pathlib.Path:
    """Package root for module naming: the nearest ancestor named `src`
    (so `src/repro/...` parses as `repro.*` wherever the command is run
    from), else the directory itself (tmp fixture trees, `benchmarks/`)."""
    p = path.resolve()
    start = p if p.is_dir() else p.parent
    for d in (start, *start.parents):
        if d.name == "src":
            return d
    return start


@dataclasses.dataclass
class LintContext:
    """Everything a rule sees: the parsed universe + the call graph."""

    modules: Dict[str, ModuleInfo]
    report: Set[str]                  # module names findings are kept for
    graph: "object" = None            # CallGraph, attached by load_universe

    def report_modules(self) -> List[ModuleInfo]:
        return [
            self.modules[n] for n in sorted(self.modules) if n in self.report
        ]

    def function_module(self, key: str) -> Optional[ModuleInfo]:
        return self.modules.get(key.split(":", 1)[0])

    def function(self, key: str) -> Optional[FunctionInfo]:
        mi = self.function_module(key)
        if mi is None:
            return None
        return mi.functions.get(key.split(":", 1)[1])


def load_universe(
    paths: Sequence[pathlib.Path], seeds=None
) -> LintContext:
    """Parse every .py under `paths` into one universe and build the call
    graph.  Files under a path are both analysed and reported; when a path
    sits inside a `src` tree, the rest of its top-level package is pulled
    into the universe so cross-module reachability sees every edge even
    when only a subtree is being reported.  Only that package: where the
    reference's loader pulls the whole `src` tree, the port's lint of
    `src/repro_torch` reads nothing of `src/repro`.

    `seeds` is a seed spec (`callgraph.DEFAULT_SEEDS` when None)."""
    from repro_torch.lint.callgraph import CallGraph

    modules: Dict[str, ModuleInfo] = {}
    report: Set[str] = set()

    def add(root: pathlib.Path, file: pathlib.Path, reported: bool) -> None:
        mi = parse_module(root, file)
        if mi is None:
            return
        if mi.name not in modules or reported:
            modules[mi.name] = mi
        if reported:
            report.add(mi.name)

    for raw in paths:
        p = pathlib.Path(raw).resolve()
        root = find_root(p)
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            add(root, f, reported=True)
        if root != p and root.name == "src":
            top = _module_name(root, p).split(".")[0]
            for f in sorted(root.rglob("*.py")):
                mi_name = _module_name(root, f)
                if mi_name.split(".")[0] == top and mi_name not in modules:
                    add(root, f, reported=False)

    ctx = LintContext(modules=modules, report=report)
    ctx.graph = CallGraph.build(ctx, seeds=seeds)
    return ctx
