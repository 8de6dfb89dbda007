"""Each configuration's sizes and read counts, worked out from its fields,
and BENCHMARK.json against the benchmark's contract."""

import json
import re

import numpy as np
import pytest

from portbench import harness, sim

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _config(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    return entry, json.loads((harness.ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_unitig_count_follows_the_layout(name):
    _entry, cfg = _config(name)
    starts, lengths = sim.unitig_layout(cfg)
    assert len(starts) == cfg["unitigs"] and lengths.min() >= cfg["unitig_min_length"]
    assert np.all(starts[1:] >= starts[:-1] + lengths[:-1])      # gaps, no overlaps
    assert starts[-1] + lengths[-1] <= cfg["genome_length"]
    assert abs(lengths.mean() / cfg["unitig_mean_length"] - 1) < 0.1
    covered = lengths.sum() / cfg["genome_length"]
    step = cfg["unitig_mean_length"] + cfg["unitig_gap_mean"]
    assert abs(covered - cfg["unitig_mean_length"] / step) < 0.02
    assert np.array_equal(lengths, sim.unitig_layout(cfg)[1])


@pytest.mark.parametrize("name", CONFIGS)
def test_read_count_follows_the_coverage(name):
    entry, cfg = _config(name)
    stage = int(cfg["coverage"] * cfg["genome_length"] / cfg["read_length"])
    if "job_reads" in entry["reduced"]:
        assert cfg["stage_reads"] == stage and cfg["job_reads"] < stage
    else:
        assert cfg["job_reads"] == stage


@pytest.mark.parametrize("name", CONFIGS)
def test_reduced_keys_are_explained(name):
    entry, cfg = _config(name)
    assert sorted(entry["reduced"]) == sorted(cfg.get("reduced", {}))


@pytest.mark.parametrize("name", CONFIGS)
def test_read_shapes_are_the_same_for_every_seed(name):
    _entry, cfg = _config(name)
    body, tail, _front = sim.read_shapes(cfg)
    assert len(body) == cfg["job_reads"]
    assert body.min() >= cfg["read_length"] - cfg["read_length_jitter"]
    assert body.max() < cfg["read_length"] + cfg["read_length_jitter"]
    tailed = tail > 0
    assert abs(tailed.mean() - cfg["tail_fraction"]) < 0.02
    assert tail[tailed].min() >= cfg["tail_min"] and tail.max() < cfg["tail_max"]
    assert np.array_equal(body, sim.read_shapes(cfg)[0])


def test_inputs_follow_the_seed_and_keep_the_sizes():
    cfg = dict(_config("ecoli_k12")[1], genome_length=40_000, job_reads=12, read_length=2_000)
    a = sim.make_inputs(cfg, 2**31 + 5, "cpu")
    b = sim.make_inputs(cfg, 2**31 + 5, "cpu")
    c = sim.make_inputs(cfg, 2**31 + 6, "cpu")
    assert np.array_equal(a.read_codes, b.read_codes)
    assert not np.array_equal(a.unitig_codes, c.unitig_codes)
    assert sorted(np.diff(a.read_offsets)) == sorted(np.diff(c.read_offsets))
    assert a.read_codes.max() < 4 and a.unitig_codes.max() < 4
    assert a.n_unitigs == len(sim.unitig_layout(cfg)[0])
    assert np.array_equal(a.unitig_offsets, c.unitig_offsets)


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("portbench/") and NAME.match(entry["name"])
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and w["config"] in CONFIGS
        harness.load_traffic(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= set(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for name in names:   # every cell reports setup_s, another end-to-end metric and a layer's
        assert len(harness.cell_metrics(BENCH, name, False)) >= 2
        assert harness.cell_metrics(BENCH, name, True)
