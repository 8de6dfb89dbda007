"""``yeast.map`` on the CPU at a tiny size: the port's PAF lines against the
plain reference on the host mapper, on the v2 path, and with the first
pass's ``max_pos`` cut so that reads go through tier 2 and on from there to
the host, with the shares of ``map.tier2_share`` and ``map.host_read_share``
read off those runs; and the reader of ``map.tier1_s`` on v1 jobs and on
jobs of a program without its span."""

import functools

import pytest

from portbench import harness, sim
from portbench.tests.common import TINY
from portbench.tests.test_portbench_reference import _program_lines

# first-pass candidate widths under the ~1,000 minimizers of TINY's 3-kb
# reads: at 256 tier 2 (twice the width) holds the reads, at 128 it sends
# them on to the host
CUTS = {"tier2": 256, "tier2_to_host": 128}


@pytest.fixture(scope="module")
def cell():
    _cell, config, traffic = harness.cell_parts(harness.load_benchmark(), "yeast.map")
    inputs = sim.make_inputs(dict(config, **TINY), 2**31 + 9, "cpu")
    run = harness.Run({}, config, traffic, 0, "cpu", inputs=inputs)
    want = harness.reference_lines(run)
    assert len(want) > 50
    return inputs, traffic, want


@pytest.mark.parametrize("device_map", [False, True], ids=["host", "v2"])
def test_yeast_reference_equals_the_port(cell, device_map):
    inputs, traffic, want = cell
    assert _program_lines(inputs, traffic, device_map) == want


@pytest.mark.parametrize("route", sorted(CUTS))
def test_yeast_reference_equals_the_port_through_tier2(cell, route, monkeypatch):
    from muchsalsa_tpu_torch.pipeline import mapper_torch

    inputs, traffic, want = cell
    monkeypatch.setattr(mapper_torch, "map_all_with_device", functools.partial(
        mapper_torch.map_all_with_device, max_pos=CUTS[route]))
    assert _program_lines(inputs, traffic, True) == want
    counts = mapper_torch.DEVICE_MAP_STATS
    assert counts["tier2_width_reads"] >= inputs.n_reads // 2
    assert counts["tier2_width_reads"] + counts["tier2_hot_reads"] >= counts["tier2_reads"]
    if route == "tier2_to_host":
        assert counts["tier2_host_reads"] >= inputs.n_reads // 2
    else:
        assert counts["tier2_host_reads"] == 0
    assert counts["tier2_host_reads"] <= counts["overflow_reads"]
    run = harness.Run({}, {}, {}, 0, "cpu", jobs=[harness.Job(inputs.n_reads, 1.0, {},
                                                               dict(counts), [])])
    for name, key in (("map.tier2_share", "tier2_reads"),
                      ("map.host_read_share", "overflow_reads")):
        want_share = 100.0 * counts[key] / inputs.n_reads
        assert harness.metric_reader(name)(run) == pytest.approx(want_share)


def _run(*jobs):
    return harness.Run({}, {}, {}, 0, "cpu", jobs=[
        harness.Job(10, 1.0, stats, map_stats, []) for stats, map_stats in jobs])


V1 = ({"map.v1_tables_s": 1.0, "map.v1_tables_n": 1, "map.dispatch_s": 0.3,
       "map.dispatch_n": 2}, {"v2": False, "total_reads": 10})
JOBS_WITHOUT_TIER1 = {
    "v1": V1,
    "parent": ({"map.dispatch_s": 0.2, "map.dispatch_n": 2},
               {"v2": True, "total_reads": 10, "tier2_reads": 6, "overflow_reads": 1}),
    "no_spans": ({"map_s": 3.0}, {"v2": True, "total_reads": 10}),
}


@pytest.mark.parametrize("job", sorted(JOBS_WITHOUT_TIER1))
def test_tier1_reader_reads_nothing_without_the_span(job):
    assert harness.metric_reader("map.tier1_s")(_run(JOBS_WITHOUT_TIER1[job])) is None


def test_tier1_reader_is_the_mean_of_the_v2_jobs():
    v2 = ({"map.tier1_s": 0.5, "map.tier1_n": 1, "map.dispatch_s": 0.2, "map.dispatch_n": 2},
          {"v2": True, "total_reads": 10, "tier2_reads": 4})
    v2_slow = ({"map.tier1_s": 1.5, "map.tier1_n": 1}, {"v2": True, "total_reads": 10})
    assert harness.metric_reader("map.tier1_s")(_run(v2, V1, v2_slow)) == pytest.approx(1.0)
