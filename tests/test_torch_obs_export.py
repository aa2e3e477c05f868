"""The port's telemetry export against the JAX reference: Prometheus text
(`obs.promtext`), the JSONL report (`obs.report`, `python -m
repro_torch.obs`) and the trace records they read (`Trace.note`,
`JsonlWriter.write_metrics`).

Both packages render the same inputs; the text must be byte-identical,
the JSON digests equal and the exit codes the same."""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.obs import metrics as ref_metrics
from repro.obs import report as ref_report
from repro.obs.promtext import metric_name as ref_metric_name
from repro.obs.promtext import to_promtext as ref_to_promtext
from repro.obs.rounds import RoundTrace as RefRoundTrace
from repro.obs.trace import JsonlWriter as RefJsonlWriter
from repro.obs.trace import Trace as RefTrace
from repro_torch.obs import (
    JsonlWriter,
    MetricsRegistry,
    RoundTrace,
    Trace,
    metric_name,
    to_promtext,
    write_promtext,
)
from repro_torch.obs import report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snapshot(registry_cls, seed):
    """A snapshot with counters, gauges, an empty and a filled histogram,
    and names that need sanitising."""
    rng = np.random.default_rng(seed)
    reg = registry_cls("t")
    reg.counter("service.requests").inc(int(rng.integers(1, 100)))
    reg.counter("weird-name/with spaces").inc(3)
    reg.counter("zero.count")
    reg.gauge("service.queue_depth").set(float(rng.integers(0, 9)))
    reg.gauge("perf.roofline_error_pct").set(float(rng.normal()))
    reg.histogram("service.latency_ms.batched")
    h = reg.histogram("service.latency_ms.update")
    for v in rng.lognormal(1.0, 2.0, size=int(rng.integers(1, 50))):
        h.observe(float(v))
    snap = reg.snapshot()
    snap["flag.bool"] = True
    snap["name.not.numeric"] = "skipped"
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_promtext_is_byte_identical_to_reference(seed):
    snap = _snapshot(MetricsRegistry, seed)
    assert snap == _snapshot(ref_metrics.MetricsRegistry, seed)
    text = to_promtext(snap)
    assert text == ref_to_promtext(snap)
    assert to_promtext(snap, prefix="") == ref_to_promtext(snap, prefix="")
    assert "repro_service_requests_total" in text
    assert 'repro_service_latency_ms_batched_bucket{le="+Inf"} 0' in text
    assert "repro_weird_name_with_spaces_total 3" in text
    assert "skipped" not in text
    assert to_promtext({}) == ref_to_promtext({}) == ""


@pytest.mark.parametrize("name, prefix", [("a.b", "repro_"), ("9lives", ""),
                                          ("x-y z", "repro_"), ("_ok", "")])
def test_metric_name_equals_reference(name, prefix):
    assert metric_name(name, prefix) == ref_metric_name(name, prefix)


def test_write_promtext_is_atomic(tmp_path):
    snap = _snapshot(MetricsRegistry, 3)
    path = tmp_path / "metrics.prom"
    write_promtext(snap, str(path))
    write_promtext(snap, str(path))          # replaces, byte-identical
    assert path.read_text() == ref_to_promtext(snap)
    assert list(tmp_path.iterdir()) == [path]


def test_trace_note_and_metrics_record_equal_reference(tmp_path):
    port, ref = Trace("r"), RefTrace("r")
    for tr in (port, ref):
        with tr.span("outer"):
            tr.note("queue.wait", 2.5, id=7, skip=None)
    (p_note,) = [s for s in port.spans if s.name == "queue.wait"]
    (r_note,) = [s for s in ref.spans if s.name == "queue.wait"]
    assert (p_note.dur_ms, p_note.depth, p_note.meta) == (r_note.dur_ms, r_note.depth, r_note.meta)
    assert p_note.start_ms <= port.spans[-1].start_ms + port.spans[-1].dur_ms
    snap = _snapshot(MetricsRegistry, 4)
    JsonlWriter(str(tmp_path / "p.jsonl")).write_metrics(snap)
    RefJsonlWriter(str(tmp_path / "r.jsonl")).write_metrics(snap)
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "r.jsonl").read_text()


def _mixed_jsonl(path, bad_rounds=False):
    """One file with every record kind the report reads, plus bad lines;
    `bad_rounds` adds a rounds record whose summary fails (the text
    renderer raises on it in both packages, the digest keeps it bare)."""
    tr = Trace("step-0")
    with tr.span("service.step", size=2):
        with tr.span("service.batch", size=2):
            pass
        tr.note("service.validate", 0.25, id=1)
    rounds = RoundTrace(rounds=3, alive=[9, 4, 1], frontier=[9, 3, 1], selected=[3, 2, 1],
                        tiles_skipped=[0, 1, 2], tiles_dense=[2, 2, 2], tiles_sparse=[1, 1, 1],
                        tiles_total=4, meta={"scope": "batch"})
    empty = RoundTrace(rounds=0, alive=[], frontier=[], selected=[], tiles_skipped=[])
    w = JsonlWriter(str(path))
    w.write_trace(tr)
    w.write_rounds(rounds)
    w.write_rounds(empty)
    w.write_metrics(_snapshot(MetricsRegistry, 5))
    w.write_line(json.dumps({"key": "core/solve", "metric": "median", "value_us": 812.5,
                             "git_sha": "abc", "timestamp": "t"}))
    w.write_line("{not json")
    w.write_line("[1, 2]")
    w.write_line(json.dumps({"kind": "mystery"}))
    if bad_rounds:
        w.write_line(json.dumps({"kind": "rounds", "rounds": "x"}))
    w.write_line("")
    w.close()
    # the port's rounds records read back through the reference's class too
    assert RefRoundTrace.from_jsonl_line(rounds.to_jsonl_line()).summary() == rounds.summary()


def test_report_and_digest_equal_reference(tmp_path):
    path = tmp_path / "mixed.jsonl"
    _mixed_jsonl(path)
    got, want = io.StringIO(), io.StringIO()
    assert report.report(str(path), got) == ref_report.report(str(path), want) == 5
    assert got.getvalue() == want.getvalue()
    assert "bad JSON" in got.getvalue() and "unknown kind 'mystery'" in got.getvalue()


def test_report_json_equals_reference_with_a_bad_rounds_record(tmp_path):
    path = tmp_path / "mixed.jsonl"
    _mixed_jsonl(path, bad_rounds=True)
    doc = report.report_json(str(path))
    assert doc == ref_report.report_json(str(path))
    assert doc["counts"] == {"trace": 1, "rounds": 3, "metrics": 1, "bench": 1}


@pytest.mark.parametrize("flag", [[], ["--json"]])
def test_report_cli_exit_codes_and_output_equal_reference(tmp_path, capsys, flag):
    path = tmp_path / "mixed.jsonl"
    _mixed_jsonl(path)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    for target, rc in ((path, 0), (empty, 2)):
        assert report.main(["report", str(target)] + flag) == rc
        got = capsys.readouterr()
        assert ref_report.main(["report", str(target)] + flag) == rc
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err)


def test_report_dispatches_bench_diff(tmp_path, capsys):
    base = tmp_path / "base.jsonl"
    base.write_text(json.dumps(dict(schema=1, bench="t", key="bench=t op=a",
                                    metric="us_per_call", value_us=1000.0)) + "\n")
    assert report.main(["bench-diff", str(base), str(base)]) == 0
    assert capsys.readouterr().out.endswith("verdict: ok\n")
    assert report.main(["bench-diff", str(base), str(tmp_path / "missing.jsonl")]) == 2
    assert "cannot read history" in capsys.readouterr().err


def test_obs_module_cli_runs_as_a_program(tmp_path):
    path = tmp_path / "mixed.jsonl"
    _mixed_jsonl(path)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report", "--json",
                           str(path)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["counts"]["trace"] == 1
