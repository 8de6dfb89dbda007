"""The spans of the port's map stage (``utils/timing.py::StageTimer``,
``SPANS``) on CPU tensors: the span totals ``map_all`` puts into its stats
on the v2 path and, with the v2 tables refused, on the v1 path; how the
spans nest; the walls they make up; and that tracing changes no PAF line
and enters the profiler only while a profiler runs."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome, simulate
from muchsalsa_tpu_torch.utils import timing
from muchsalsa_tpu_torch.utils.timing import SPANS, StageTimer

BATCH = ("map.read_pack", "map.dispatch", "map.wait", "map.collect")
REFINE = ("refine.pairs", "refine.pad", "refine.copy", "refine.distance", "refine.writeback")
EXPECTED = {
    "v2": {"map.v2_tables", "map.tier1", *BATCH, "map.paf", *REFINE},
    "v1": {"map.v2_tables", "map.v1_tables", *BATCH, "map.paf", *REFINE},
}


def sim_inputs(seed=61, genome_length=12_000, coverage=3.0, read_length=1_500):
    rng = np.random.default_rng(seed)
    sim = simulate(rng, genome_length=genome_length, coverage=coverage, read_length=read_length)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.05))
    cfg = MapperConfig(refine=True)
    return port_mapper.MinimizerIndex.build(unitigs, cfg), unitigs, reads, cfg


def repeat_inputs(seed=52, copies=6, rep_len=300):
    """Unitigs sharing one repeat, reads of the bare repeat (past a cap of
    2 entries a minimizer) and unique reads."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, rep_len)
    unitigs = SequenceStore()
    for i in range(copies):
        g = random_genome(rng, 1200)
        unitigs.add(f"u{i}", g[:200] + rep + g[200:])
    reads = SequenceStore()
    for i in range(4):
        reads.add(f"rep{i}", add_noise(rng, rep, 0.02))
    for i in range(copies):
        reads.add(f"uniq{i}", unitigs.sequence(i)[600:1400])
    cfg = MapperConfig()
    return port_mapper.MinimizerIndex.build(unitigs, cfg), reads, cfg


def run_map_all(inputs, stats=None):
    """``map_all`` on a fresh store of the reads, as a map stage runs it:
    a store keeps its packed batches, so a second call would pack none."""
    index, unitigs, reads, cfg = inputs
    fresh = SequenceStore()
    for rid, seq in reads.items():
        fresh.add(reads.registry.name(rid), seq)
    return mt.map_all(index, fresh, cfg, unitigs=unitigs, device=True, torch_device="cpu",
                      stats=stats)


@pytest.fixture(scope="module")
def inputs():
    return sim_inputs()


@pytest.fixture(params=["v2", "v1"])
def path(request, monkeypatch):
    if request.param == "v1":
        monkeypatch.setattr(mt, "build_device_tables", lambda *a, **k: None)
    return request.param


def span_names(stats):
    return {k[:-2] for k in stats if k.endswith("_n")}


def test_map_all_fills_every_span_of_its_path(inputs, path):
    stats: dict = {}
    run_map_all(inputs, stats)
    assert mt.DEVICE_MAP_STATS["v2"] is (path == "v2")
    assert span_names(stats) == EXPECTED[path] and EXPECTED[path] <= set(SPANS)
    for name in EXPECTED[path]:
        assert stats[f"{name}_s"] >= 0 and stats[f"{name}_n"] >= 1
    # one of each batch span a batch
    assert len({stats[f"{name}_n"] for name in BATCH}) == 1
    for key in ("map_s", "refine_s", "pack_s", "distance_s", "problems", "M", "N", "packed"):
        assert key in stats
    if path == "v1":
        assert mt.DEVICE_MAP_STATS["v1_setup_s"] == stats["map.v1_tables_s"]


def test_span_sums_stay_inside_the_walls(inputs, path):
    stats: dict = {}
    run_map_all(inputs, stats)
    top = [n for n in EXPECTED[path] if n.startswith("map.") and n not in
           ("map.paf", "map.wait", "map.tier1")]   # map.tier1 holds the batch spans
    assert sum(stats[f"{n}_s"] for n in top) <= stats["map_s"]
    assert stats["map.wait_s"] <= stats["map.collect_s"]
    assert sum(stats[f"{n}_s"] for n in REFINE) <= stats["refine_s"]
    assert stats["pack_s"] == (stats["refine.pairs_s"] + stats["refine.pad_s"]
                               + stats["refine.copy_s"])
    assert stats["distance_s"] == stats["refine.distance_s"]


def test_tier2_repull_and_host_spans_nest_as_documented(monkeypatch):
    index, reads, cfg = repeat_inputs()

    def spans(tier2, **kw):
        monkeypatch.setenv("MS_TPU_MAP_TIER2", tier2)
        timer = StageTimer(verbose=False)
        mt.map_all_with_device(index, reads, cfg, max_pos=1024, max_per_hit=2, device="cpu",
                               timer=timer, **kw)
        assert set(timer.stages) <= set(SPANS)
        return timer

    timer = spans("16")
    assert mt.DEVICE_MAP_STATS["tier2_reads"] >= 1 and timer.calls["map.tier2"] == 1
    assert timer.calls["map.tier1"] == 1 and timer.parents["map.tier1"] == {""}
    assert timer.parents["map.v2_tables"] == {""} and timer.parents["map.tier2"] == {""}
    for name in ("map.read_pack", "map.dispatch", "map.collect"):
        assert timer.parents[name] == {"map.tier1", "map.tier2"}, name
    assert timer.parents["map.wait"] == {"map.collect"}

    timer = spans("16", hit_budget=2)
    assert mt.DEVICE_MAP_STATS["dense_repulls"] == timer.calls["map.repull"] >= 1
    assert timer.parents["map.repull"] == {"map.collect"}

    timer = spans("0")
    assert mt.DEVICE_MAP_STATS["overflow_reads"] >= 1 and "map.tier2" not in timer.stages
    assert timer.parents["map.host"] == {""} and timer.calls["map.host"] == 1
    assert mt.DEVICE_MAP_STATS["host_map_s"] == timer.stages["map.host"]


def test_no_profiler_range_is_entered_without_a_profiler(inputs, path, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a profiler range was entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    stats: dict = {}
    assert run_map_all(inputs, stats)
    assert span_names(stats) == EXPECTED[path]


def test_spans_are_profiler_ranges_inside_the_caller(inputs, path):
    stats: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            run_map_all(inputs, stats)
    rows = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if "CPU" in str(e.device_type())]
    (c0, c1), = [(s, e) for n, s, e in rows if n == "caller"]
    ranges: dict = {}
    for n, s, e in rows:
        if n in SPANS:
            assert c0 <= s <= e <= c1, n
            ranges[n] = ranges.get(n, 0) + 1
    assert set(ranges) == EXPECTED[path]
    assert all(ranges[n] == stats[f"{n}_n"] for n in ranges)


def test_paf_lines_do_not_depend_on_the_timer_or_a_profiler(inputs, path):
    plain = run_map_all(inputs)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run_map_all(inputs, {})
    assert "\n".join(traced).encode() == "\n".join(plain).encode() and len(plain) > 10


def test_trace_prints_one_line_a_map_all(inputs, monkeypatch, capsys):
    monkeypatch.setenv("MS_TPU_TRACE", "1")
    stats: dict = {}
    run_map_all(inputs, stats)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[ms-tpu]")]
    assert len(lines) == 1 and lines[0].startswith("[ms-tpu] map_all: ")
    assert f"map.dispatch {stats['map.dispatch_s']:.3f}s/{stats['map.dispatch_n']}" in lines[0]


def test_stage_timer_sums_counts_and_parents(monkeypatch, capsys):
    timer = StageTimer(verbose=True)
    for _ in range(3):
        with timer.stage("outer") as outer:
            with timer.stage("inner"):
                pass
    assert outer.seconds >= 0 and timer.calls == {"inner": 3, "outer": 3}
    assert timer.parents == {"outer": {""}, "inner": {"outer"}}
    assert timer.totals() == {"outer_s": timer.stages["outer"], "outer_n": 3,
                              "inner_s": timer.stages["inner"], "inner_n": 3}
    assert timer.stages["inner"] <= timer.stages["outer"]
    assert capsys.readouterr().err.count("[ms-tpu] inner: ") == 3
    with pytest.raises(ValueError), timer.stage("failing"):
        raise ValueError
    assert timer.calls["failing"] == 1 and timer._open == []
    assert not hasattr(StageTimer, "dump") and not hasattr(timing, "memory_stats")
