"""The port's hot-path lint (`repro_torch.lint`) against the reference's
(`repro.lint`): the same engine on the reference's tree, the same baseline
and output formats, every RPT rule on a fixture it flags and one it
passes, mutations of the port itself, the self-check, and phase 18's site
classifier (`repro_torch.lint.audit`) on synthetic records.

Fixtures are tmp-dir `src/` trees laid out under the port's module names,
so the default seeds (keys such as `repro_torch.core.tc_mis:_converge`)
apply to them as to the port.  Everything is syntactic: no card, no jax.
"""
import dataclasses
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import textwrap
import warnings

import pytest

from repro.lint import analysis as ref_analysis
from repro.lint import baseline as ref_baseline
from repro.lint import callgraph as ref_callgraph
from repro.lint import emit as ref_emit
from repro.lint import rules as ref_rules
from repro_torch.lint import audit
from repro_torch.lint.analysis import load_universe
from repro_torch.lint.baseline import Baseline
from repro_torch.lint.callgraph import SEED_KEYS
from repro_torch.lint.cli import main
from repro_torch.lint.emit import emit_json, emit_sarif, emit_text
from repro_torch.lint.model import Finding
from repro_torch.lint.rules import ALL_RULES, get_rules, run_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "src"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}


def build(tmp_path, files):
    root = tmp_path / "src"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def lint(tmp_path, files, rules=None):
    ctx = load_universe([build(tmp_path, files)])
    return ctx, run_rules(ctx, get_rules(rules))


def active(findings, rule=None):
    return [f for f in findings if f.active and (rule is None or f.rule == rule)]


def hot_loop(body, helpers=""):
    """A fixture round loop: `_converge` (a seed key) runs `body`."""
    return {
        "repro_torch/core/tc_mis.py": (
            "import random\nimport time\nimport numpy as np\nimport torch\n"
            + textwrap.dedent(helpers)
            + "def _converge(engine, ctx, pri, state, config, buf=None):\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
            + "    return state\n"
        ),
    }


# --------------------------------------------------------------------------
# 1. engine parity: the port's engine on the reference's tree
# --------------------------------------------------------------------------
REF_SEEDS = dict(ref_callgraph.DEFAULT_SEEDS, engine_base="RoundEngine")


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    """src/repro alone under a `src` of its own, so both loaders read the
    same universe (the reference's pulls a whole `src` tree)."""
    root = tmp_path_factory.mktemp("ref") / "src"
    shutil.copytree(SRC / "repro", root / "repro",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


@pytest.mark.parametrize("reported", ["repro", "repro/core"])
def test_engine_parity_on_the_reference(reference_tree, reported):
    """With the reference's seeds and `RoundEngine` as the base, the port's
    loader and call graph give exactly the reference's modules, reports,
    hot set, seeds, engine classes, loop bodies and edges on src/repro,
    reporting the package or a subtree of it."""
    path = reference_tree / reported
    ref = ref_analysis.load_universe([path])
    ctx = load_universe([path], seeds=REF_SEEDS)
    assert set(ctx.modules) == set(ref.modules) and ctx.report == ref.report
    graph, want = ctx.graph, ref.graph
    assert len(want.hot) > 100 and len(want.edges) > 300 and want.loop_bodies
    assert graph.hot == want.hot
    assert graph.seeds == want.seeds
    assert graph.engine_classes == want.engine_classes
    assert graph.loop_bodies == want.loop_bodies
    assert graph.edges == want.edges
    assert not graph.round_loops - graph.seeds


def test_reference_seeds_none_of_the_port():
    """The port's names stay off the reference's seed list: linted with the
    reference's engine, `src` (both packages) has no port function hot."""
    graph = ref_analysis.load_universe([SRC]).graph
    assert not [k for k in graph.hot if k.startswith("repro_torch")]
    assert not [k for k in graph.seeds if k.startswith("repro_torch")]


def test_rule_ids_number_after_the_reference():
    ref_ids = {r.id for r in ref_rules.ALL_RULES}
    for r in ALL_RULES:
        assert r.id.startswith("RPT") and "RPR" + r.id[3:] in ref_ids, r.id
        assert r.summary and r.rationale and r.escapes
    assert len({r.id for r in ALL_RULES}) == len(ALL_RULES) == 12


# --------------------------------------------------------------------------
# 2. baseline and output parity
# --------------------------------------------------------------------------
def _findings(cls, rule="RPT010"):
    return [
        cls(rule=rule, severity="error", path="repro_torch/core/a.py", line=3,
            col=5, module="repro_torch.core.a", symbol="f", message="m one"),
        cls(rule=rule, severity="error", path="repro_torch/core/a.py", line=9,
            col=1, module="repro_torch.core.a", symbol="f", message="m one"),
        cls(rule="RPT012", severity="error", path="repro_torch/core/b.py", line=1,
            col=1, module="repro_torch.core.b", symbol="<module>", message="m two",
            suppressed=True),
    ]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baseline_loads_in_the_other_package(tmp_path, writer):
    path = tmp_path / "baseline.json"
    if writer == "port":
        Baseline.from_findings(_findings(Finding)).save(path)
        loaded = ref_baseline.Baseline.load(path)
        applied = loaded.apply(_findings(ref_analysis_finding()))
    else:
        ref_baseline.Baseline.from_findings(_findings(ref_analysis_finding())).save(path)
        loaded = Baseline.load(path)
        applied = loaded.apply(_findings(Finding))
    assert len(loaded) == 2
    assert [f.baselined for f in applied] == [True, True, False]
    assert json.loads(path.read_text())["version"] == 1


def ref_analysis_finding():
    from repro.lint.model import Finding as RefFinding

    return RefFinding


@pytest.mark.parametrize("rule", ["RPT010", "RPR010"])
def test_text_and_json_output_equal(rule):
    """The same findings print the same text and JSON from either package,
    but for the rule names: each package names its own catalog's, "?"
    another's."""
    port_fs, ref_fs = _findings(Finding, rule), _findings(ref_analysis_finding(), rule)
    assert emit_json(port_fs) == ref_emit.emit_json(ref_fs)

    def unnamed(text, catalog):
        for r in catalog:
            text = text.replace(f"{r.id}[{r.name}]", f"{r.id}[?]")
        return text

    text, ref_text = emit_text(port_fs), ref_emit.emit_text(ref_fs)
    assert unnamed(text, ALL_RULES) == unnamed(ref_text, ref_rules.ALL_RULES)
    assert text != ref_text and "[?]" in text + ref_text
    assert "2 error(s), 1 suppressed, 0 baselined" in text


def test_sarif_names_the_port_tool():
    doc = json.loads(emit_sarif(_findings(Finding), ALL_RULES))
    driver = doc["runs"][0]["tool"]["driver"]
    assert driver["name"] == "repro-torch-lint" and doc["version"] == "2.1.0"
    assert [r["id"] for r in driver["rules"]] == [r.id for r in ALL_RULES]
    assert all(r["help"]["text"] for r in driver["rules"])
    assert doc["runs"][0]["results"][2]["suppressions"][0]["kind"] == "inSource"


# --------------------------------------------------------------------------
# 3. each RPT rule: a fixture it flags and one it passes
# --------------------------------------------------------------------------
KERNEL_MODULE = "repro_torch/hopper/ops.py"


@pytest.mark.parametrize("rule,call", [
    ("RPT001", "unpack_tile_bits(t)"), ("RPT001", "unpack_tile_mask(t)"),
    ("RPT002", "dense_tiles(t)"), ("RPT002", "dense_tile_mask(t)"),
    ("RPT002", "to_storage(t)"),
])
@pytest.mark.parametrize("where", ["_launch", "ops_wrapper", "ops_plain"])
def test_rpt001_002_kernel_modules_keep_tiles_stored(tmp_path, rule, call, where):
    _, fs = lint(tmp_path, {KERNEL_MODULE: f"""
        def {where}(t):
            return {call}
        def _launch_other(t):
            return t
    """})
    hits = active(fs, rule)
    assert len(hits) == (0 if where.endswith("_plain") else 1)


@pytest.mark.parametrize("fn,flagged", [("apply_delta", True), ("apply_oracle", False),
                                        ("apply_plain", False)])
def test_rpt003_dyngraph_densify(tmp_path, fn, flagged):
    _, fs = lint(tmp_path, {"repro_torch/dyngraph/patch.py": f"""
        from repro_torch.core.tiling import dense_tile_mask
        def {fn}(t):
            return dense_tile_mask(t)
    """})
    assert len(active(fs, "RPT003")) == int(flagged)


@pytest.mark.parametrize("module,fn,flagged", [
    ("repro_torch/serve_mis/x.py", "respond", True),
    ("repro_torch/core/tc_mis.py", "_result", False),
    ("repro_torch/core/distributed.py", "gather_bool", False),
    ("repro_torch/core/engine.py", "_nbr_max_oracle", False),
    ("repro_torch/core/tiling.py", "sorted_words", False),
])
def test_rpt004_frontier_unpack_seams(tmp_path, module, fn, flagged):
    _, fs = lint(tmp_path, {module: f"""
        from repro_torch.core.tiling import unpack_frontier_words
        def {fn}(w):
            return unpack_frontier_words(w, 16)
    """})
    assert len(active(fs, "RPT004")) == int(flagged)


@pytest.mark.parametrize("stmt", ["torch.cuda.synchronize()", "stream.synchronize()",
                                  "done.synchronize()", "torch.cuda.current_stream().synchronize()",
                                  "print(x)"])
@pytest.mark.parametrize("module,suppress,flagged", [
    ("repro_torch/core/loop.py", "", True),
    ("repro_torch/hopper/k.py", "", True),
    ("repro_torch/core/loop.py",
     "  # repro-lint: disable=RPT005 host-stepped profiler twin", False),
    ("repro_torch/api/solver.py", "", False),
])
def test_rpt005_explicit_waits_and_prints(tmp_path, stmt, module, suppress, flagged):
    _, fs = lint(tmp_path, {module: f"""
        import torch
        def tick(x, stream, done):{suppress}
            {stmt}
            return x
    """})
    assert len(active(fs, "RPT005")) == int(flagged)


@pytest.mark.parametrize("expr", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")',
    'x.to(device="cpu")', 'x.to(torch.device("cpu"))', "torch.nonzero(x)",
    "x.nonzero()", "torch.argwhere(x)", "torch.unique(x)", "x.unique()",
    "torch.masked_select(x, m)", "torch.bincount(x)", "torch.where(m)",
    "torch.repeat_interleave(x, r)", "int(x.sum())", "float(torch.max(x))",
    "bool(state.alive.any())", "int(x.max()[0])", "np.asarray(x)", "(x & m).tolist()",
])
def test_rpt010_host_syncs_flagged(tmp_path, expr):
    _, fs = lint(tmp_path, hot_loop(f"y = {expr}\n"))
    hits = active(fs, "RPT010")
    assert len(hits) == 1 and hits[0].symbol == "_converge", hits


@pytest.mark.parametrize("stmt", ["if x.any():\n    pass\n",
                                  "while state.alive.any():\n    pass\n",
                                  "if not torch.equal(x, m):\n    pass\n",
                                  "y = 1 if m.all() else 0\n"])
def test_rpt010_branch_on_a_tensor_flagged(tmp_path, stmt):
    _, fs = lint(tmp_path, hot_loop(stmt))
    assert len(active(fs, "RPT010")) == 1


@pytest.mark.parametrize("stmt", [
    "y = torch.repeat_interleave(x, r, output_size=n)\n", "y = int(config.max_rounds)\n",
    "y = int(T // 32)\n", "y = x.to(torch.int32)\n", "if t.is_contiguous():\n    pass\n",
    "if x.numel():\n    pass\n", "if torch.is_grad_enabled():\n    pass\n",
    "y = x.repeat_interleave(16)\n",
    "y = bool(state.alive.any())  # repro-lint: disable=RPT010 the one sanctioned sync a round\n",
])
def test_rpt010_passes(tmp_path, stmt):
    _, fs = lint(tmp_path, hot_loop(stmt))
    assert not active(fs, "RPT010")


def test_rpt010_only_on_the_hot_path(tmp_path):
    """A sync in a function no seed reaches is none of the round's."""
    _, fs = lint(tmp_path, hot_loop("state = helper(state)\n", helpers="""
        def helper(s):
            return s
        def epilogue(x):
            return x.cpu()
    """))
    assert not active(fs, "RPT010")


def test_rpt010_transitive_through_an_engine(tmp_path):
    _, fs = lint(tmp_path, {
        "repro_torch/core/engine.py": """
            from repro_torch.core.helpers import count
            class TorchRoundEngine:
                def step(self, ctx, pri, state):
                    return self._half(state)
            class TorchTiledEngine(TorchRoundEngine):
                def _half(self, state):
                    return count(state)
        """,
        "repro_torch/core/helpers.py": """
            def count(state):
                return state.sum().item()
        """,
    })
    hits = active(fs, "RPT010")
    assert [(f.module, f.symbol) for f in hits] == [("repro_torch.core.helpers", "count")]


@pytest.mark.parametrize("expr,flagged", [
    ("torch.rand(n)", True), ("torch.randn(n, device=d)", True),
    ("torch.randint(0, 9, (n,), dtype=torch.int32)", True), ("torch.randperm(n, dtype=torch.int32)", True),
    ("torch.rand_like(x)", True), ("x.bernoulli_()", True), ("x.uniform_()", True),
    ("random.random()", True), ("time.perf_counter()", True), ("np.random.rand(n)", True),
    ("print(x)", True),
    ("torch.rand(n, generator=gen)", True), ("torch.randperm(n, generator=gen, dtype=torch.int32)", True),
    ("x.uniform_(generator=gen)", True), ("torch.zeros(n)", False),
    ("prng.uniform(prng.key(0), n, d)", False),
])
def test_rpt011_reproducibility(tmp_path, expr, flagged):
    _, fs = lint(tmp_path, hot_loop(f"y = {expr}\n"))
    assert len(active(fs, "RPT011")) == int(flagged)


def test_rpt011_global_write_and_def_line_escape(tmp_path):
    files = hot_loop("state = bump(state)\n", helpers="""
        COUNT = 0
        def bump(s):
            global COUNT
            COUNT += 1
            return s
    """)
    _, fs = lint(tmp_path / "a", files)
    assert [f.symbol for f in active(fs, "RPT011")] == ["bump"]
    files["repro_torch/core/tc_mis.py"] = files["repro_torch/core/tc_mis.py"].replace(
        "def bump(s):", "def bump(s):  # repro-lint: disable=RPT011 a host-side counter")
    _, fs = lint(tmp_path / "b", files)
    assert not active(fs, "RPT011")


@pytest.mark.parametrize("stmt", [
    "y = torch.zeros(n, dtype=torch.int64)\n", "y = torch.zeros(n, dtype=torch.long)\n",
    "y = torch.zeros(n, dtype=torch.float64)\n", "y = torch.zeros(n, dtype=int)\n",
    "y = x.double()\n", "y = x.to(torch.int64)\n", "y = x.type(torch.long)\n",
    "y = torch.arange(n)\n", "y = torch.arange(n, device=d)\n", "y = torch.tensor([1, 2])\n",
    "y = torch.full((n,), 0)\n", "y = torch.full((n,), -1, device=d)\n",
    # a stored cast, then handed to the op that needs it: not the escape
    "idx = rows.long()\nout.scatter_(0, idx, v)\n",
    "cols = tile_cols.long()\ny = x[cols]\n",
    "out.index_add_(0, rows.long(), v)\n",
])
def test_rpt012_64bit_creep_flagged(tmp_path, stmt):
    _, fs = lint(tmp_path, hot_loop(stmt))
    assert len(active(fs, "RPT012")) == 1, fs


@pytest.mark.parametrize("stmt", [
    'out.scatter_reduce_(0, rows.long()[:, None].expand(-1, T), v, "amax")\n',
    "y = x[cols.long()]\n", "buf.index_copy_(0, at.reshape(1).long(), row[None])\n",
    "y = torch.gather(p, 1, first.clamp(max=7).long())\n", "y = p.gather(1, idx.long())\n",
    "out.scatter_add_(0, index=rows.long(), src=v)\n",
    "y = torch.arange(n, dtype=torch.int32)\n", "y = torch.tensor([1, 2], dtype=torch.int32)\n",
    "y = torch.full((n,), 0, dtype=torch.int32)\n", "y = torch.full((n,), 0.5)\n",
    "y = torch.tensor(x)\n", "y = x.to(torch.int32)\n", "y = x.long  # an attribute\n",
])
def test_rpt012_passes(tmp_path, stmt):
    _, fs = lint(tmp_path, hot_loop(stmt))
    assert not active(fs, "RPT012"), fs


@pytest.mark.parametrize("growth,flagged", [
    ("parts = torch.cat([parts, x])", True), ("parts = torch.stack([a, b])", True),
    ("parts = np.concatenate([parts, x])", True), ("hist.append(x)", True),
    ("buf.index_copy_(0, at.reshape(1).long(), x[None])", False),
    ("state = engine.step(ctx, pri, state)", False),
])
def test_rpt013_round_loop_carry(tmp_path, growth, flagged):
    body = (f"while rounds < config.max_rounds:\n    {growth}\n    rounds += 1\n")
    _, fs = lint(tmp_path, hot_loop(body))
    assert len(active(fs, "RPT013")) == int(flagged)


def test_rpt013_only_seeded_loops(tmp_path):
    """A `while` in a function that is not a seed is no round loop, and a
    growth outside the loop of a seeded one is set-up."""
    _, fs = lint(tmp_path, hot_loop(
        "hist = torch.cat([a, b])\nstate = drain(state)\n", helpers="""
        def drain(s):
            out = []
            while s:
                out.append(s)
            return out
    """))
    assert not active(fs, "RPT013")


@pytest.mark.parametrize("module,call,flagged", [
    ("repro_torch/api/solver.py", 'get_engine("ref")', True),
    ("repro_torch/api/solver.py", 'SolveOptions(engine="pallas")', True),
    ("repro_torch/api/solver.py", 'get_engine("tiled_ref")', False),
    ("repro_torch/api/solver.py", 'SolveOptions(engine="fused_pallas")', False),
    ("repro_torch/core/engine.py", 'get_engine("ref")', False),
])
def test_rpt014_deprecated_engine_spellings(tmp_path, module, call, flagged):
    _, fs = lint(tmp_path, {module: f"""
        def make():
            return {call}
    """})
    assert len(active(fs, "RPT014")) == int(flagged)


WRAPPER = """
    from repro_torch.hopper.build import library
    from repro_torch.hopper.launch import on_cpu
    def k_plain(x):
        return x
    def _launch(x):
        {launch}
        return x
    def k(x):
        {wrapper}
"""


@pytest.mark.parametrize("launch,wrapper,flagged", [
    ("pass", "if on_cpu(x):\n            return k_plain(x)\n        return _launch(x)", 0),
    ("pass", "return k_plain(x)", 1),
    ("pass", "if x.is_cuda:\n            return _launch(x)\n        return k_plain(x)", 1),
    ("return k_plain(x)", "return _launch(x)", 1),
    ("pass", "try:\n            return _launch(x)\n        except RuntimeError:\n"
             "            return x", 1),
    ("pass", "try:\n            return _launch(x)\n        except RuntimeError:\n"
             "            return k_plain(x)", 2),
    ("pass", "try:\n            return _launch(x)\n        finally:\n            pass", 0),
    ("try:\n            library('k')\n        except OSError:\n            pass",
     "return _launch(x)", 1),
])
def test_rpt015_wrapper_hygiene(tmp_path, launch, wrapper, flagged):
    src = WRAPPER.replace("{launch}", launch).replace("{wrapper}", wrapper)
    _, fs = lint(tmp_path, {KERNEL_MODULE: src})
    assert len(active(fs, "RPT015")) == flagged, fs


def test_on_cpu_branch_draws_no_edge(tmp_path):
    """A wrapper's plain version is hot only where something else on the
    hot path calls it."""
    ctx, _ = lint(tmp_path, {KERNEL_MODULE: WRAPPER.replace("{launch}", "pass").replace(
        "{wrapper}", "if on_cpu(x):\n            return k_plain(x)\n        return _launch(x)")})
    hot = ctx.graph.hot
    assert "repro_torch.hopper.ops:k" in hot and "repro_torch.hopper.ops:_launch" in hot
    assert "repro_torch.hopper.ops:k_plain" not in hot


@pytest.mark.parametrize("fn,flagged", [("helper", True), ("helper_oracle", False)])
def test_rpt016_hot_densify_anywhere(tmp_path, fn, flagged):
    files = hot_loop(f"state = {fn}(state)\n")
    files["repro_torch/serve_mis/x.py"] = "\n"
    files["repro_torch/core/tc_mis.py"] = files["repro_torch/core/tc_mis.py"].replace(
        "import torch\n", f"import torch\nfrom repro_torch.core.words import {fn}\n")
    files["repro_torch/core/words.py"] = f"""
from repro_torch.core.tiling import unpack_frontier_words
def {fn}(w):
    return unpack_frontier_words(w, 16)
"""
    _, fs = lint(tmp_path, files)
    hits = active(fs, "RPT016")
    assert len(hits) == int(flagged)
    if flagged:
        assert hits[0].symbol == fn


def test_suppressions_never_cross_packages(tmp_path):
    """An RPR suppression does not silence the port's rule, nor an RPT one
    the reference's."""
    _, fs = lint(tmp_path / "port", hot_loop(
        "y = x.item()  # repro-lint: disable=RPR010 the reference's id\n"))
    assert len(active(fs, "RPT010")) == 1
    root = build(tmp_path / "ref", {"repro/core/tc_mis.py": """
        def _tc_mis_impl(x):
            return x.item()  # repro-lint: disable=RPT010 the port's id
    """})
    ctx = ref_analysis.load_universe([root])
    hits = [f for f in ref_rules.run_rules(ctx) if f.active and f.rule == "RPR010"]
    assert len(hits) == 1


# --------------------------------------------------------------------------
# 4. mutations of the port, on a copy
# --------------------------------------------------------------------------
@pytest.fixture
def port_copy(tmp_path):
    root = tmp_path / "src"
    shutil.copytree(SRC / "repro_torch", root / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _edit(root, rel, old, new):
    p = root / "repro_torch" / rel
    text = p.read_text()
    assert old in text, (rel, old)
    p.write_text(text.replace(old, new, 1))


def _lint_copy(root):
    ctx = load_universe([root / "repro_torch"])
    return ctx, run_rules(ctx)


def test_mutation_clean_copy(port_copy):
    _, fs = _lint_copy(port_copy)
    assert not active(fs)


def test_mutation_item_in_a_helper_of_another_module(port_copy):
    _edit(port_copy, "core/spmv.py", "def _check_backend(",
          "def _probe_rounds(x):\n    return x.item()\n\n\ndef _check_backend(")
    _edit(port_copy, "core/engine.py",
          '        """Active block-column flags straight from the words."""\n',
          '        """Active block-column flags straight from the words."""\n'
          '        from repro_torch.core.spmv import _probe_rounds\n'
          '        _probe_rounds(cand_words)\n')
    _, fs = _lint_copy(port_copy)
    hits = active(fs)
    assert [(f.rule, f.module, f.symbol) for f in hits] == [
        ("RPT010", "repro_torch.core.spmv", "_probe_rounds")]


def test_mutation_arange_in_a_hot_function(port_copy):
    _edit(port_copy, "core/engine.py",
          "    return x.reshape(-1, tile_size).to(torch.bool)",
          "    _ = torch.arange(x.shape[0])\n    return x.reshape(-1, tile_size).to(torch.bool)")
    _, fs = _lint_copy(port_copy)
    hits = active(fs)
    assert [(f.rule, f.symbol) for f in hits] == [("RPT012", "block_col_flags")]


def test_mutation_fallback_from_launch_to_plain(port_copy):
    _edit(port_copy, "hopper/tc_spmv.py",
          "    out = _launch(tiled, rhs, col_flags, None)\n",
          "    try:\n        out = _launch(tiled, rhs, col_flags, None)\n"
          "    except RuntimeError:\n"
          "        out = tc_spmv_plain(tiled, rhs, col_flags=col_flags)\n")
    _, fs = _lint_copy(port_copy)
    hits = active(fs)
    assert {(f.rule, f.symbol) for f in hits} == {("RPT015", "tc_spmv")} and len(hits) == 2
    assert any("_launch" in f.message for f in hits)
    assert any("tc_spmv_plain" in f.message for f in hits)


# --------------------------------------------------------------------------
# 5. the self-check
# --------------------------------------------------------------------------
def test_port_lints_clean():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.lint", "src/repro_torch"],
                          cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s)" in proc.stdout


def test_default_path_is_the_port(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out and "repro/core" not in out


@pytest.fixture(scope="module")
def port_ctx():
    return load_universe([SRC / "repro_torch"])


def test_hot_set_holds_every_seed(port_ctx):
    graph = port_ctx.graph
    for key in SEED_KEYS:
        assert key in graph.seeds, key
    engines = {"TorchRoundEngine", "TorchSegmentEngine", "TorchTiledEngine",
               "TorchTiledRefEngine", "HopperSpmvEngine", "HopperFusedEngine"}
    assert {k.split(":")[1] for k in graph.engine_classes} == engines
    for key in ("repro_torch.core.engine:TorchRoundEngine.step",
                "repro_torch.core.engine:TorchTiledEngine.step_bits_hybrid",
                "repro_torch.core.engine:HopperFusedEngine.fused_step_bits"):
        assert key in graph.seeds, key
    for mod, names in (("tc_spmv", ("_launch", "_launch_bits", "tc_spmv", "tc_spmv_fused",
                                    "tc_spmv_bits", "tc_spmv_fused_bits")),
                       ("tc_neighbor_max", ("_launch", "_launch_bits", "tc_neighbor_max",
                                            "tc_neighbor_max_bits")),
                       ("embedding_bag", ("_launch", "_launch_backward", "embedding_bag",
                                          "embedding_bag_backward", "sort_slots"))):
        for name in names:
            assert f"repro_torch.hopper.{mod}:{name}" in graph.seeds, (mod, name)
    assert graph.round_loops == {"repro_torch.core.tc_mis:_converge",
                                 "repro_torch.core.tc_mis:run_phases",
                                 "repro_torch.core.distributed:build_distributed_mis.run"}
    assert not [k for k in graph.hot if not k.startswith("repro_torch.")]
    assert not [k for k in graph.hot if k.startswith("repro_torch.lint")]
    assert "repro_torch.core.tc_mis:_result" in graph.hot   # via repair_solution


def test_every_suppression_gives_its_reason(port_ctx):
    """The suppressions are the account of each hot-path sync and cast:
    every `repro-lint: disable=` in the port names a rule and a reason."""
    n = 0
    for mi in port_ctx.modules.values():
        for line in mi.source.splitlines():
            m = ref_analysis._SUPPRESS_RE.search(line)
            if m and not line.lstrip().startswith(('"', "`")) and "disable=RPT0xx" not in line:
                n += 1
                assert m.group("rules").startswith("RPT"), line
                assert m.group("reason") and len(m.group("reason").split()) >= 3, line
    assert n >= 4


def test_shipped_baseline_is_empty():
    data = json.loads((REPO / "tools" / "torch_lint_baseline.json").read_text())
    assert data == {"version": 1, "entries": []}


def test_cli(tmp_path, capsys):
    root = build(tmp_path, hot_loop("y = x.item()\n"))
    assert main([str(root), "--no-baseline"]) == 1
    assert "RPT010[hot-host-sync]" in capsys.readouterr().out
    assert main([str(root), "--rules", "RPT012", "--no-baseline"]) == 0
    assert main([str(root), "--rules", "RPX999"]) == 2
    assert main([str(tmp_path / "nowhere")]) == 2
    base = tmp_path / "base.json"
    assert main([str(root), "--update-baseline", "--baseline", str(base)]) == 0
    assert main([str(root), "--baseline", str(base)]) == 0
    out = tmp_path / "out.sarif"
    assert main([str(root), "--no-baseline", "--format", "sarif", "-o", str(out)]) == 1
    doc = json.loads(out.read_text())
    assert doc["runs"][0]["results"][0]["ruleId"] == "RPT010"
    assert main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    assert all(r.id in listing for r in ALL_RULES)
    assert main([str(root), "--no-baseline", "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["findings"][0]["symbol"] == "_converge"


# --------------------------------------------------------------------------
# 6. phase 18's classifier
# --------------------------------------------------------------------------
CLASSIFY = {
    "repro_torch/core/tc_mis.py": """
        import torch
        def _converge(engine, ctx, pri, state, config):
            rounds = 0
            while bool(state.alive.any()):  # repro-lint: disable=RPT010 the one sanctioned sync a round
                state = engine.step(ctx, pri, state)
                n = state.rnd.sum()
                rounds += 1
            return state
        def run_tc_mis(g):
            out = torch.zeros(3)
            return out.cpu()
        def run_phases(g):  # repro-lint: disable=RPT005,RPT010 host-stepped profiler twin
            torch.cuda.synchronize()
            return g
    """,
}


@pytest.fixture
def classify_ctx(tmp_path):
    ctx = load_universe([build(tmp_path, CLASSIFY)])
    return ctx, tmp_path / "src" / "repro_torch" / "core" / "tc_mis.py"


@pytest.mark.parametrize("line,group", [
    (5, audit.SANCTIONED),      # the while test, suppressed
    (7, audit.UNACCOUNTED),     # hot, neither flagged nor suppressed
    (6, audit.UNACCOUNTED),
    (12, audit.OUTSIDE),        # run_tc_mis: no seed reaches it here
    (14, audit.SANCTIONED),     # run_phases, a seed suppressed on its def line
    (1, audit.OUTSIDE),         # module level
])
def test_classify_site(classify_ctx, line, group):
    ctx, path = classify_ctx
    assert audit.classify_site(ctx, path, line) == group
    assert audit.classify_site(ctx, "repro_torch/core/tc_mis.py", line) == group


def test_classify_sites_counts_and_unknown_files(classify_ctx):
    ctx, path = classify_ctx
    sites = [(str(path), 5)] * 6 + [(str(path), 12)] * 3 + [("/elsewhere/torch/x.py", 3),
                                                             (str(path), 7)]
    groups = audit.classify_sites(ctx, sites)
    assert groups[audit.SANCTIONED] == {(str(path), 5): 6}
    assert groups[audit.OUTSIDE] == {(str(path), 12): 3, ("/elsewhere/torch/x.py", 3): 1}
    assert groups[audit.UNACCOUNTED] == {(str(path), 7): 1}


def test_classify_a_wrapped_statement(tmp_path):
    """A sync raised from a continuation line meets the comment on the
    statement's first line."""
    ctx = load_universe([build(tmp_path, {"repro_torch/core/tc_mis.py": """
        def _converge(state, config):
            while (config.go  # repro-lint: disable=RPT010 the one sanctioned sync a round
                   and bool(state.alive.any())):
                state = state
            return state
    """})])
    path = tmp_path / "src" / "repro_torch" / "core" / "tc_mis.py"
    assert audit.classify_site(ctx, path, 4) == audit.SANCTIONED
    assert audit.classify_site(ctx, path, 5) == audit.UNACCOUNTED


def test_sync_recorder_finds_the_port_frame(tmp_path):
    """The recorder keeps the innermost frame under the root, past frames
    outside it (torch's Python between the port and the sync)."""
    root = build(tmp_path, {
        "repro_torch/core/loop.py": """
            def run(outside):
                return outside()
        """,
        "elsewhere/torchish.py": """
            import warnings
            def op():
                warnings.warn("called a synchronizing CUDA operation")
                warnings.warn("something else")
        """,
    })
    mods = {}
    for name, rel in (("loop", "repro_torch/core/loop.py"), ("torchish", "elsewhere/torchish.py")):
        spec = importlib.util.spec_from_file_location(f"_lintfx_{name}", root / rel)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    rec = audit.SyncRecorder(root / "repro_torch", skip=(root / "repro_torch" / "lint",))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = rec
        mods["loop"].run(mods["torchish"].op)
    assert rec.sites == [(str((root / "repro_torch/core/loop.py").resolve()), 3)]
    assert rec.others == ["something else"]


def test_finding_is_the_reference_shape():
    """The port's Finding carries the reference's fields, so emitters and
    baselines of either package take the other's findings."""
    from repro.lint.model import Finding as RefFinding

    assert [f.name for f in dataclasses.fields(Finding)] == [
        f.name for f in dataclasses.fields(RefFinding)]
