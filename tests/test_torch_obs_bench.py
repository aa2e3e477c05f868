"""`repro_torch.obs.bench` against `repro.obs.bench`: the reference's
bench-history cases (tests/test_obs.py, §17) on the port; the history
records of one stamped document record for record (but the environment
fields, which each package stamps its own); `diff` reports equal on
`tools/bench_baseline.jsonl` and perturbed copies of it; the `bench-diff`
CLI's stdout and exit code byte-equal to the reference's for exit codes
0, 1 and 2, with and without `--json`, through `bench.main` and through
the `report` front door; the port's stamp (no `jax_version`: torch, CUDA,
the card's name and power limit), cached once per process, made with no
JAX imported."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.obs import bench as ref_bench
from repro_torch.obs import bench
from repro_torch.obs import report

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASELINE = os.path.join(ROOT, "tools", "bench_baseline.jsonl")
PORT_ENV = {"git_sha", "timestamp", "backend", "torch_version", "cuda_version", "device_name",
            "power_limit"}


def _bench_records(value_us, metric="us_per_call", key="bench=t op=a", k=1):
    return [dict(schema=1, bench="t", key=key, metric=metric,
                 value_us=v) for v in ([value_us] * k)]


def _write(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


# --------------------------------------------------------------------------
# the reference's cases, on the port
# --------------------------------------------------------------------------

def test_write_bench_stamps_and_appends_history(tmp_path):
    hist = str(tmp_path / "hist")
    doc = dict(bench="t", backend="fake", results=[
        dict(op="a", n=4, us_per_call=5.0, rounds=3),
        dict(op="b", n=4, solve_ms=2.0, mis_size=7),
    ])
    out = bench.write_bench(doc, str(tmp_path / "snap.json"), history_dir=hist)
    # stamp fills the header but never overwrites the bench's own fields
    assert out["schema_version"] == 1 and out["backend"] == "fake"
    assert out["git_sha"] and out["timestamp"] and out["torch_version"]
    assert "jax_version" not in out
    snap = json.loads((tmp_path / "snap.json").read_text())
    assert snap["bench"] == "t" and snap["git_sha"] == out["git_sha"]
    recs = bench.load_records(hist)
    assert len(recs) == 2
    by_metric = {r["metric"]: r for r in recs}
    # values normalised to µs; outcome fields stay out of the identity key
    assert by_metric["us_per_call"]["value_us"] == 5.0
    assert by_metric["solve_ms"]["value_us"] == 2000.0
    assert "rounds" not in by_metric["us_per_call"]["key"]
    assert "op=a" in by_metric["us_per_call"]["key"]
    # append-only: a second write grows the file
    bench.write_bench(doc, str(tmp_path / "snap.json"), history_dir=hist)
    assert len(bench.load_records(hist)) == 4
    # empty history dir string disables the append, snapshot still written
    bench.write_bench(doc, str(tmp_path / "snap2.json"), history_dir="")
    assert (tmp_path / "snap2.json").exists()


def test_bench_diff_verdicts_and_bars():
    base = _bench_records(1000.0)
    # small drift: inside both bars -> same
    assert bench.diff(base, _bench_records(1100.0))["status"] == "ok"
    # 2.5x slowdown: both bars trip -> regression
    rep = bench.diff(base, _bench_records(2500.0))
    assert rep["status"] == "regression"
    assert rep["regressions"][0]["ratio"] == 2.5
    # mirrored improvement: reported, never failing
    rep = bench.diff(base, _bench_records(300.0))
    assert rep["status"] == "ok" and len(rep["improvements"]) == 1
    # micro-kernel jitter: 1.9x relative but under the 200us floor -> same
    rep = bench.diff(_bench_records(100.0), _bench_records(190.0))
    assert rep["status"] == "ok" and not rep["regressions"]
    # slow op drifting a few percent: over the floor, under the bar -> same
    rep = bench.diff(_bench_records(100000.0), _bench_records(110000.0))
    assert rep["status"] == "ok" and not rep["regressions"]
    # median-of-k: one noisy outlier run must not gate
    noisy = _bench_records(1000.0) + _bench_records(1000.0) + _bench_records(5000.0)
    rep = bench.diff(noisy, _bench_records(1010.0))
    assert rep["status"] == "ok"
    assert rep["rows"][0]["base_us"] == 1000.0      # the median, not the max
    # disjoint keys must fail loudly, not pass vacuously
    rep = bench.diff(base, _bench_records(1000.0, key="bench=t op=OTHER"))
    assert rep["status"] == "no-overlap"


def test_bench_diff_cli_exit_codes(tmp_path, capsys):
    base = _write(tmp_path / "base.jsonl", _bench_records(1000.0))
    same = _write(tmp_path / "same.jsonl", _bench_records(1050.0))
    slow = _write(tmp_path / "slow.jsonl", _bench_records(2000.0))
    other = _write(tmp_path / "other.jsonl", _bench_records(1000.0, key="bench=u op=z"))
    assert bench.main([base, same]) == 0
    assert bench.main([base, slow]) == 1           # synthetic 2x slowdown
    assert bench.main([base, other]) == 2          # mis-pointed baseline
    # the report CLI front door dispatches the subcommand too
    assert report.main(["bench-diff", base, same]) == 0
    assert report.main(["bench-diff", base, slow, "--json"]) == 1
    out = capsys.readouterr().out
    assert '"status": "regression"' in out
    # raising the relative bar clears the 2x verdict
    assert bench.main([base, slow, "--rel-bar", "1.5"]) == 0


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def _doc():
    return dict(bench="core", quick=True, results=[
        dict(op="spmv", n=2048, storage="int8", tile_size=64, us_per_call=14386.8, rounds=3,
             extra=[1, 2]),
        dict(op="solve", n=4096, engine="segment", solve_ms=2.5, mis_size=7, ok=True),
        dict(op="repair", n=4096, repair_ms=0.75, cold_ms=3.125, warm_s=0.5, cold_s=1.25),
        dict(op="flag", n=1, us_per_call=True),        # a bool is not a metric
        "not a row",
    ])


def test_history_records_equal_the_references_but_the_environment():
    doc = dict(_doc(), git_sha="abc", timestamp="t0", backend="cpu")
    env = PORT_ENV | {"jax_version"}
    got = bench.history_records(bench.stamp(doc))
    want = ref_bench.history_records(ref_bench.stamp(doc))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in env} == \
            {k: v for k, v in w.items() if k not in env}
        assert set(g) - set(w) == PORT_ENV - {"git_sha", "timestamp", "backend"}
        assert set(w) - set(g) == {"jax_version"}


def _perturbed(records, factors):
    """The records with the i-th key's values scaled by factors[i % n]."""
    keys = sorted({(r["key"], r["metric"]) for r in records})
    scale = {k: factors[i % len(factors)] for i, k in enumerate(keys)}
    return [dict(r, value_us=r["value_us"] * scale[(r["key"], r["metric"])]) for r in records]


@pytest.mark.parametrize("factors", [(1.0,), (1.05, 0.95), (2.5, 1.0, 0.3), (1.7, 0.5)])
def test_diff_reports_equal_the_references(factors):
    base = bench.load_records(BASELINE)
    assert base == ref_bench.load_records(BASELINE) and len(base) == 48
    head = _perturbed(base, factors) + base[:5]         # a second draw of some keys
    for kw in ({}, dict(rel_bar=1.5), dict(abs_floor_us=10.0)):
        rep = bench.diff(base, head, **kw)
        assert rep == ref_bench.diff(base, head, **kw)
        assert bench.render_diff(rep) == ref_bench.render_diff(rep)


@pytest.mark.parametrize("flag", [[], ["--json"]])
@pytest.mark.parametrize("head, rc", [("same", 0), ("slow", 1), ("other", 2), ("baseline", 0),
                                      ("missing", 2)])
def test_bench_diff_output_is_byte_equal_to_the_references(tmp_path, capsys, head, rc, flag):
    base = bench.load_records(BASELINE)
    files = {
        "same": _write(tmp_path / "same.jsonl", _perturbed(base, (1.05, 0.9))),
        "slow": _write(tmp_path / "slow.jsonl", _perturbed(base, (3.0, 1.0, 0.2))),
        "other": _write(tmp_path / "other.jsonl", _bench_records(1000.0, key="bench=u op=z")),
        "baseline": BASELINE,
        "missing": str(tmp_path / "missing.jsonl"),
    }
    argv = [BASELINE, files[head]] + flag
    assert bench.main(argv) == rc
    got = capsys.readouterr()
    assert report.main(["bench-diff"] + argv) == rc
    front = capsys.readouterr()
    assert ref_bench.main(argv) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err) == (front.out, front.err)
    assert got.out or got.err


def test_the_committed_baseline_against_itself_exits_0():
    for main in (bench.main, ref_bench.main):
        assert main([BASELINE, BASELINE]) == 0
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.obs", "bench-diff", BASELINE,
                          BASELINE], capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.endswith("verdict: ok\n")


# --------------------------------------------------------------------------
# the port's stamp
# --------------------------------------------------------------------------

def test_bench_env_stamps_torch_cuda_and_the_card_once_a_process(monkeypatch):
    import torch

    monkeypatch.setattr(bench, "_ENV_CACHE", None)
    env = bench.bench_env()
    assert set(env) == PORT_ENV
    assert env["torch_version"] == torch.__version__
    assert env["cuda_version"] == (torch.version.cuda or "none")
    assert env["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    if shutil.which("nvidia-smi") is None:
        assert env["device_name"] == env["power_limit"] == "none"
    calls = []
    monkeypatch.setattr(bench, "_card", lambda: calls.append(1) or ("card", "1.00 W"))
    assert bench.bench_env() == env and not calls      # cached: no second query
    monkeypatch.setattr(bench, "_ENV_CACHE", None)
    assert bench.bench_env()["device_name"] == "card" and calls == [1]


def test_card_reads_nvidia_smis_first_line(monkeypatch):
    class Done:
        returncode = 0
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: Done())
    assert bench._card() == ("NVIDIA H100 80GB HBM3", "700.00 W")
    Done.returncode = 9
    assert bench._card() == ("none", "none")

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench.subprocess, "run", missing)
    assert bench._card() == ("none", "none")


def test_the_stamp_imports_no_jax():
    code = ("import sys; from repro_torch.obs import bench; e = bench.bench_env(); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules, "
            "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(sorted(e))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == str(sorted(PORT_ENV))
