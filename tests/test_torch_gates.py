"""The port's placement gates and its driver's two environment switches, on
the CPU.

- ``driver._on_device`` equals a transcription of the JAX driver's rule
  (``muchsalsa_tpu/assemble/driver.py:492-497``, ``:522-527``; no link in
  the port, so its probe passes) in every row of a table of counts,
  thresholds, device types and ``use_device``, and makes no CUDA call;
- on the golden input the port's ``edges_on_device`` and
  ``chaining_on_device`` equal the JAX driver's, at the default config and
  with both gates at 10^9 (the CPU opens them in both packages);
- a gate that closes runs the host oracle: the golden bytes, the same as
  the ``use_device``-unset run, no device chaining counter;
- ``MS_TPU_PROFILE`` writes a trace file and ``MS_TPU_DEBUG`` prints the
  stage lines of the timer the driver makes and leaves a caller's timer as
  it was, the golden bytes unchanged under each.

Tolerance: identical output bytes and equal counters.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from muchsalsa_tpu.assemble.driver import assemble as jax_assemble
from muchsalsa_tpu.config import Config as JaxConfig
from muchsalsa_tpu_torch.assemble import driver
from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.config import Config
from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation
from tests.test_golden import GOLDEN

torch.set_num_threads(1)

OUTPUTS = ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")
PLACEMENT = ("edges_on_device", "chaining_on_device")


def jax_rule(use_device: bool, backend_is_cpu: bool, n: int, threshold: int) -> bool:
    """The JAX driver's gate, transcribed; ``_link_allows_device`` is True
    (an attached card has no link to probe)."""
    link_allows = True
    return use_device and (backend_is_cpu or threshold == 0
                           or (n >= threshold and link_allows))


def with_device(cfg, **fields):
    return dataclasses.replace(cfg, device=dataclasses.replace(cfg.device, **fields))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The dataset of tests/test_golden.py::run_fixed_assembly."""
    sim = simulate(np.random.default_rng(20260817), genome_length=60_000,
                   unitig_length=1_100, unitig_gap=300, read_length=6_000,
                   coverage=9.0, both_strands=True)
    paths = write_simulation(sim, tmp_path_factory.mktemp("golden") / "data")
    return paths["paf"], paths["unitigs"], paths["reads"]


def hashes(out):
    return {n: hashlib.sha256((out / n).read_bytes()).hexdigest() for n in GOLDEN}


def counters(out):
    return json.loads((out / "assembly_stats.json").read_text())["counters"]


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("dev_type", ["cpu", "cuda"])
@pytest.mark.parametrize("threshold", [0, 1, 200_000])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_gate_rule_equals_the_jax_rule(monkeypatch, use_device, dev_type, threshold, offset):
    def no_cuda(*a, **k):
        raise AssertionError("the gate made a CUDA call")

    for name in ("is_available", "current_device", "device_count", "synchronize",
                 "_lazy_init", "init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    n = threshold + offset
    cfg = with_device(Config(), use_device=use_device)
    got = driver._on_device(cfg, n, threshold, torch.device(dev_type))
    assert got == jax_rule(use_device, dev_type == "cpu", n, threshold)


@pytest.mark.parametrize("thresholds", [None, 10**9])
def test_placement_counters_equal_the_jax_driver(golden, tmp_path, thresholds):
    port_cfg, jax_cfg = Config(), JaxConfig()
    if thresholds is not None:
        gates = dict(edges_device_min_rows=thresholds, chain_device_min_problems=thresholds)
        port_cfg, jax_cfg = with_device(port_cfg, **gates), with_device(jax_cfg, **gates)
    assemble(*golden, tmp_path / "port", port_cfg, device="cpu")
    jax_assemble(*golden, tmp_path / "jax", jax_cfg)
    port, jax = counters(tmp_path / "port"), counters(tmp_path / "jax")
    assert {k: port[k] for k in PLACEMENT} == {k: jax[k] for k in PLACEMENT} == {
        k: 1 for k in PLACEMENT}
    assert hashes(tmp_path / "port") == GOLDEN


def test_closed_gates_run_the_host_oracle(golden, tmp_path, monkeypatch):
    unset = tmp_path / "unset"
    assemble(*golden, unset, with_device(Config(), use_device=False), device="cpu")
    seen = []

    def closed(config, n, threshold, dev):
        seen.append((n, threshold))
        return False

    monkeypatch.setattr(driver, "_on_device", closed)
    gated = tmp_path / "gated"
    assemble(*golden, gated, device="cpu")
    assert hashes(gated) == GOLDEN
    for name in OUTPUTS:
        assert (gated / name).read_bytes() == (unset / name).read_bytes(), name
    c = counters(gated)
    assert {k: c[k] for k in PLACEMENT} == {k: 0 for k in PLACEMENT}
    assert "chain_device_problems" not in c
    # phase ② on the match rows, phase ③ on twice the graph's edges
    dcfg = Config().device
    assert seen == [(c["match_rows"], dcfg.edges_device_min_rows),
                    (2 * c["graph_size"], dcfg.chain_device_min_problems)]


def test_profile_switch_writes_a_trace(golden, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MS_TPU_PROFILE", str(trace_dir))
    assemble(*golden, tmp_path / "out", device="cpu")
    assert hashes(tmp_path / "out") == GOLDEN
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_debug_switch_prints_the_stage_lines(golden, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MS_TPU_DEBUG", "1")
    monkeypatch.delenv("MS_TPU_TRACE", raising=False)
    assemble(*golden, tmp_path / "out", device="cpu")
    assert hashes(tmp_path / "out") == GOLDEN
    err = capsys.readouterr().err
    for stage in ("ingest", "edges", "chaining", "assembly"):
        assert f"[ms-tpu] {stage}: " in err, stage
    assert "[ms-tpu] chaining_on_device = 1" in err


def test_debug_switch_leaves_a_callers_timer(golden, tmp_path, monkeypatch, capsys):
    from muchsalsa_tpu_torch.utils.timing import StageTimer

    monkeypatch.setenv("MS_TPU_DEBUG", "1")
    monkeypatch.delenv("MS_TPU_TRACE", raising=False)
    timer = StageTimer()
    assemble(*golden, tmp_path / "out", timer=timer, device="cpu")
    assert hashes(tmp_path / "out") == GOLDEN
    assert not timer.verbose
    assert "[ms-tpu] chaining: " not in capsys.readouterr().err
