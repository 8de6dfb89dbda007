"""A run of the harness on the CPU at a tiny size: the result's line, its
metrics and units, and the comparison failing where the timed path is
broken underneath (each fault a map-stage job can have) or the control is
put in the program's place."""

import dataclasses
import json

import pytest

from portbench import control, harness
from portbench.tests.common import tiny_run

BENCH = harness.load_benchmark()
UNITS = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}


def _line(run, trace):
    harness.run_window(run, 0.5, trace, 0.0)
    failed, checks = harness.check(run, harness.reference_lines(run))
    out = harness.result(run, BENCH, trace, failed, checks, {"platform": "cpu"})
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_result_line(workload, trace, monkeypatch):
    if workload.startswith("dmel"):
        from muchsalsa_tpu_torch.pipeline import mapper_torch

        monkeypatch.setattr(mapper_torch, "build_device_tables", lambda *a, **k: None)
    out = _line(tiny_run(workload), bool(trace))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"]["lines_wrong"] == {"value": 0, "limit": 0}
    for name, m in out["metrics"].items():
        assert m["unit"] == UNITS[name] and m["value"] >= 0
    wanted = {m["name"] for m in harness.cell_metrics(BENCH, workload, bool(trace))}
    assert set(out["metrics"]) <= wanted
    if not trace:
        assert {"reads_s", "setup_s"} <= set(out["metrics"])   # card_peak_bytes needs a card
    else:
        assert "map.map_s" in out["metrics"] and "breakdown" in out


def _drop_half(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        return [(rid, maps if i % 2 else []) for i, (rid, maps) in enumerate(out)]
    return broken


def _alter_one(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        rid, maps = next((r, m) for r, m in out if m)
        maps[0] = dataclasses.replace(maps[0], t_end=maps[0].t_end + 1)
        return out
    return broken


def _alter_matches(fn):
    def broken(per_read, *args, **kw):
        fn(per_read, *args, **kw)
        maps = next(m for _r, m in per_read if m)
        maps[-1].matches -= 1
    return broken


FAULTS = {
    "half_the_reads_left_out": ("ecoli.map", "map_all_with_device", _drop_half),
    "a_mapping_altered": ("ecoli.map", "map_all_with_device", _alter_one),
    "refinement_returns_its_input": ("ecoli.map_refine", "refine_mappings",
                                     lambda fn: lambda *a, **k: None),
    "a_refined_match_altered": ("ecoli.map_refine", "refine_mappings", _alter_matches),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from muchsalsa_tpu_torch.pipeline import mapper_torch

    workload, target, wrap = FAULTS[fault]
    monkeypatch.setattr(mapper_torch, target, wrap(getattr(mapper_torch, target)))
    out = _line(tiny_run(workload), False)
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert out["checks"]["lines_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", ["ecoli.map", "ecoli.map_refine"])
def test_the_control_is_not_correct(workload):
    run = tiny_run(workload, genome_length=2_000_000, job_reads=150, read_length=3_000)
    checks = control.control_checks(run)
    assert checks["lines_wrong"]["value"] > checks["lines_wrong"]["limit"]


def test_trace_reading_labels_gaps_by_span():
    from torch.profiler import ProfilerActivity, profile

    import torch

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            with torch.profiler.record_function("job.map_all"):
                torch.ones(1000).cumsum(0)
    trace = harness.read_trace(prof)
    assert trace.busy_s == 0 and trace.window_s > 0
    assert trace.idle_gaps and trace.idle_gaps[0][0] in ("job.map_all", "window")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    run = tiny_run("ecoli.map")
    run.device = card
    out = _line(run, False)
    assert out["correct"] is True and out["metrics"]["card_peak_bytes"]["value"] > 0


def _finished(run, capsys):
    from portbench import run as bench_run

    harness.run_window(run, 0.5, False, 0.0)
    with pytest.raises(SystemExit) as stop:
        bench_run.finish(run, BENCH, False)
        raise SystemExit(0)
    out, err = capsys.readouterr()
    return stop.value.code, out, err


def test_finish_prints_the_result_last(capsys):
    code, out, err = _finished(tiny_run("ecoli.map"), capsys)
    assert code == 0 and json.loads(out.splitlines()[-1])["correct"] is True
    assert err.splitlines()[-1].startswith("check ")


def test_a_forbidden_module_loaded_by_a_reader_stops_the_run(monkeypatch, capsys):
    import sys
    import types

    real = harness.result

    def planting(*args, **kw):   # as a metric reader importing JAX would
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*args, **kw)

    monkeypatch.setattr(harness, "result", planting)
    code, out, err = _finished(tiny_run("ecoli.map"), capsys)
    assert code == 1 and out == "" and "['jax']" in err


def test_a_refined_job_is_checked_on_a_sample(monkeypatch):
    monkeypatch.setattr(harness, "REFINE_SAMPLE", 5)
    run = tiny_run("ecoli.map_refine")
    harness.run_window(run, 0.5, False, 0.0)
    ref = harness.reference_lines(run)
    sampled = [i for i, line in enumerate(ref) if line.split("\t")[9] != "*"]
    assert len(sampled) == 5 and len(ref) > 20
    assert harness.check(run, ref)[1]["lines_wrong"]["value"] == 0
    for i in (sampled[0], next(i for i in range(len(ref)) if i not in sampled)):
        job = run.jobs[0]
        fields = job.lines[i].split("\t")
        fields[9] = str(int(fields[9]) - 1)
        saved, job.lines[i] = job.lines[i], "\t".join(fields)
        wrong = harness.check(run, ref)[1]["lines_wrong"]["value"]
        job.lines[i] = saved
        assert wrong == (1 if i in sampled else 0)
