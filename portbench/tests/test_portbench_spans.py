"""The program's spans as the benchmark reads them (``portbench/spans.py``):
the card's idle time put down to the innermost span on synthetic trace rows,
and the readers of the span metrics on jobs of a program with spans and of
one from before them."""

import pytest

from portbench import harness, spans

BENCH = harness.load_benchmark()
PROGRAM = ("map.dispatch", "map.collect", "map.wait")
SPAN_METRICS = sorted(m["name"] for m in BENCH["per_layer"]
                      if "job_mean" in harness.metric_reader(m["name"]).__globals__)


def rows(cpu=(), cuda=()):
    """Trace rows (name, device type, start, end) in ns: a window of 0-100
    and the given CPU ranges and card events."""
    out = [("window", "DeviceType.CPU", 0, 100)]
    out += [(n, "DeviceType.CPU", s, e) for n, s, e in cpu]
    out += [(n, "DeviceType.CUDA", s, e) for n, s, e in cuda]
    return out


def test_a_mirrored_program_span_is_no_card_work():
    cpu = [("job.map_all", 10, 90), ("map.dispatch", 20, 30)]
    kernels = [("kernel", 25, 35)]
    plain = spans.attribute(rows(cpu, kernels), PROGRAM)
    mirrored = spans.attribute(rows(cpu, kernels + [("map.dispatch", 25, 60),
                                                    ("job.map_all", 25, 60)]), PROGRAM)
    assert plain["busy_s"] == mirrored["busy_s"] == pytest.approx(10e-9)
    assert mirrored["device_idle"] == pytest.approx(90.0)


def test_a_gap_is_named_by_its_innermost_span():
    cpu = [("job.map_all", 0, 100), ("map.collect", 40, 80), ("map.wait", 50, 70)]
    out = spans.attribute(rows(cpu, [("kernel", 0, 50), ("kernel", 70, 100)]), PROGRAM)
    assert out["idle_gaps"] == [["map.wait", pytest.approx(20e-9)]]
    assert out["idle_by_span"] == {"map.wait": pytest.approx(20e-9)}
    assert out["idle_unlabelled"] == 0


def test_a_gap_across_spans_is_split_at_their_ends():
    cpu = [("job.map_all", 10, 100), ("map.dispatch", 20, 45), ("map.collect", 45, 80),
           ("map.wait", 50, 70)]
    out = spans.attribute(rows(cpu, [("kernel", 0, 30), ("kernel", 75, 100)]), PROGRAM)
    assert out["idle_by_span"] == pytest.approx(
        {"map.dispatch": 15e-9, "map.collect": 10e-9, "map.wait": 20e-9})
    assert out["idle_gaps"] == [["map.wait", pytest.approx(45e-9)]]   # its middle, 52.5
    assert sum(out["idle_by_span"].values()) == pytest.approx(100e-9 - out["busy_s"])


@pytest.mark.parametrize("covered", [True, False])
def test_idle_unlabelled_reads_what_no_program_span_covers(covered):
    cpu = [("job.store", 0, 10), ("job.map_all", 10, 100)]
    if covered:
        cpu += [("map.dispatch", 10, 55), ("map.collect", 55, 100)]
    out = spans.attribute(rows(cpu, [("kernel", 30, 40)]), PROGRAM)
    assert out["idle_unlabelled"] == (0.0 if covered else 100.0)
    assert sum(out["idle_by_span"].values()) == pytest.approx(90e-9)
    assert out["idle_by_span"]["job.store"] == pytest.approx(10e-9)


def test_innermost_pieces_tile_the_window():
    got = spans.innermost([(10, 90, "a"), (20, 40, "b"), (30, 35, "c"), (40, 60, "d"),
                           (80, 120, "e")], 0, 100)
    assert got == [(0, 10, "window"), (10, 20, "a"), (20, 30, "b"), (30, 35, "c"),
                   (35, 40, "b"), (40, 60, "d"), (60, 80, "a"), (80, 90, "e"),
                   (90, 100, "window")]


def _run(*jobs):
    return harness.Run({}, {}, {}, 0, "cpu", jobs=[
        harness.Job(10, 1.0, stats, map_stats, []) for stats, map_stats in jobs])


def test_span_readers_read_the_jobs_means():
    v2 = {"map.v2_tables_s": 0.5, "map.v2_tables_n": 1, "map.dispatch_s": 1.0,
          "map.dispatch_n": 4, "map.collect_s": 2.0, "map.collect_n": 4, "map.wait_s": 0.5,
          "map.wait_n": 4, "map.repull_s": 0.25, "map.repull_n": 1, "map.tier2_s": 1.5,
          "map.tier2_n": 1}
    v1 = {"map.v2_tables_s": 0.25, "map.v2_tables_n": 1, "map.v1_tables_s": 1.25,
          "map.v1_tables_n": 1, "map.dispatch_s": 3.0, "map.dispatch_n": 4}
    both = _run((v2, {"v2": True}), (v1, {"v2": False}))
    read = harness.metric_reader
    assert read("map.tables_s")(both) == pytest.approx(1.0)
    assert read("map.dispatch_s")(both) == pytest.approx(2.0)
    assert read("map.collect_s")(both) == pytest.approx(1.25)
    assert read("map.tier2_s")(both) == pytest.approx(1.5)
    no_tier2 = dict(v2)
    del no_tier2["map.tier2_s"], no_tier2["map.tier2_n"]
    assert read("map.tier2_s")(_run((v2, {"v2": True}), (no_tier2, {"v2": True}))) == 0.75
    assert read("map.tier2_s")(_run((v1, {"v2": False}))) is None
    assert read("refine.pad_s")(both) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_reader_reads_nothing_from_a_program_without_spans(name):
    before = _run(({"map_s": 3.0, "pack_s": 1.0, "distance_s": 0.1, "refine_s": 1.2},
                   {"v2": True, "total_reads": 10}))
    assert harness.metric_reader(name)(before) is None
