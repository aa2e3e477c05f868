"""A guard over the whole port: every number the port draws where the
reference draws under a `jax.random` key goes through
`repro_torch.core.prng` under that key.  This file parses
`src/repro_torch` and `examples/torch_*.py` and fails on any
`torch.Generator`, torch draw (`torch.rand*`, `randn*`, `randint*`,
`randperm`, `normal`, `multinomial`, `bernoulli`, `poisson`) or in-place
draw (`x.normal_()`, `x.uniform_()`, ...) outside `ALLOWED`.  The names
are the port lint's (RPT011, which holds the hot path alone to the same
rule)."""
import ast
import pathlib

import pytest

from repro_torch.lint.rules import TENSOR_DRAWS, TORCH_DRAWS, TORCH_LIKE_DRAWS

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (file under the repo, enclosing function) -> why it may draw from torch
ALLOWED = {
    ("src/repro_torch/configs/gnn_cells.py", "products_inputs"):
        "ogb_products' stand-in graph's features and labels: the reference has "
        "no such inputs (its cell takes them as arguments), so no key to follow",
}


def _sources():
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    yield from sorted((ROOT / "examples").glob("torch_*.py"))


def _draws(path: pathlib.Path):
    """(line, enclosing function, what) of every torch draw in a file."""
    tree = ast.parse(path.read_text())
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            name = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Attribute):
                base = child.value
                if isinstance(base, ast.Name) and base.id == "torch":
                    if child.attr == "Generator" or child.attr in TORCH_DRAWS \
                            or child.attr in TORCH_LIKE_DRAWS:
                        found.append((child.lineno, func, f"torch.{child.attr}"))
                elif child.attr in TENSOR_DRAWS or child.attr == "multinomial":
                    found.append((child.lineno, func, f".{child.attr}"))
            if isinstance(child, ast.ImportFrom) and child.module == "torch":
                for alias in child.names:
                    if alias.name == "Generator" or alias.name in TORCH_DRAWS:
                        found.append((child.lineno, func, f"from torch import {alias.name}"))
            visit(child, name)

    visit(tree, None)
    return found


def test_the_port_draws_only_through_core_prng():
    offenders = []
    for path in _sources():
        rel = str(path.relative_to(ROOT))
        for line, func, what in _draws(path):
            if (rel, func) not in ALLOWED:
                offenders.append(f"{rel}:{line} ({func}): {what}")
    assert not offenders, "torch draws outside core.prng:\n" + "\n".join(offenders)


def test_every_allowed_site_still_draws():
    """An allow-list entry whose code no longer draws is stale."""
    seen = {(str(p.relative_to(ROOT)), func) for p in _sources() for _, func, _ in _draws(p)}
    assert set(ALLOWED) <= seen, sorted(set(ALLOWED) - seen)


@pytest.mark.parametrize("code, hits", [
    ("g = torch.Generator()", 1),
    ("x = torch.randn(3)", 1),
    ("x = torch.rand_like(y)", 1),
    ("x = torch.multinomial(p, 1)", 1),
    ("y.normal_()", 1),
    ("p.multinomial(1)", 1),
    ("from torch import randint", 1),
    ("x = prng.normal(k, 3, 'cpu')", 0),
    ("x = torch.zeros(3)", 0),
])
def test_the_guard_sees_each_kind_of_draw(tmp_path, code, hits):
    f = tmp_path / "m.py"
    f.write_text(f"def f():\n    {code}\n")
    assert len(_draws(f)) == hits
