"""The port's core assembly end to end, on the CPU.

- ``assemble(device="cpu")`` reproduces the golden sha256 values of
  tests/test_golden.py, on the device path and on the host-oracle path
  (``use_device`` unset), and is byte-equal to the JAX package's ``assemble``
  on a second dataset (tolerance: identical bytes);
- the port's CLI runs ``core --device cpu`` in a subprocess;
- a whole port assembly never loads JAX;
- ``"cuda"`` without a card raises: nothing falls back to the CPU.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from muchsalsa_tpu.assemble.driver import assemble as jax_assemble
from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.config import Config
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.ops.chain_scan import chain_scan
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.pipeline.cli import main
from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation
from tests.test_golden import GOLDEN

REPO = Path(__file__).resolve().parent.parent
OUTPUTS = ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")


def _golden_data(tmp_path):
    """The dataset of tests/test_golden.py::run_fixed_assembly."""
    rng = np.random.default_rng(20260817)
    sim = simulate(rng, genome_length=60_000, unitig_length=1_100, unitig_gap=300,
                   read_length=6_000, coverage=9.0, both_strands=True)
    return write_simulation(sim, tmp_path / "data")


def _small_data(tmp_path, seed, glen):
    sim = simulate(np.random.default_rng(seed), genome_length=glen, coverage=8.0,
                   both_strands=True)
    return write_simulation(sim, tmp_path / "data")


# min_device_batch=1 sends every bucket through chain_scan
@pytest.mark.parametrize("min_device_batch", [32, 1])
def test_port_reproduces_golden(tmp_path, min_device_batch):
    paths = _golden_data(tmp_path)
    out = tmp_path / "out"
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, device=dataclasses.replace(cfg.device, min_device_batch=min_device_batch))
    result = assemble(paths["paf"], paths["unitigs"], paths["reads"], out, cfg,
                      device="cpu")
    got = {n: hashlib.sha256((out / n).read_bytes()).hexdigest() for n in GOLDEN}
    assert got == GOLDEN
    stats = json.loads((out / "assembly_stats.json").read_text())
    assert stats["counters"]["chaining_on_device"] == 1
    assert stats["counters"]["edges_on_device"] == 1
    assert stats["memory"]["host_peak_rss_bytes"] > 0
    assert stats["counters"]["chain_device_problems"] > 0
    if min_device_batch == 1:
        assert stats["counters"]["chain_host_problems"] == 0
    assert result["paths"] == stats["counters"]["paths"]


def test_port_host_oracle_branch_reproduces_golden(tmp_path):
    """``use_device`` unset: host edges and chaining, nothing on the device."""
    paths = _golden_data(tmp_path)
    out = tmp_path / "out"
    cfg = Config()
    cfg = dataclasses.replace(cfg, device=dataclasses.replace(cfg.device, use_device=False))
    before = chain_scan.launches
    assemble(paths["paf"], paths["unitigs"], paths["reads"], out, cfg, device="cpu")
    got = {n: hashlib.sha256((out / n).read_bytes()).hexdigest() for n in GOLDEN}
    assert got == GOLDEN
    counters = json.loads((out / "assembly_stats.json").read_text())["counters"]
    assert counters["chaining_on_device"] == 0 and counters["edges_on_device"] == 0
    assert "chain_device_problems" not in counters
    assert chain_scan.launches == before


def test_port_matches_jax_assemble(tmp_path, monkeypatch):
    paths = _small_data(tmp_path, seed=21, glen=30_000)
    args = (paths["paf"], paths["unitigs"], paths["reads"])
    # the JAX driver meshes its device phases over the 8 virtual devices of
    # tests/conftest.py: the port's over 8 CPU shards, so that every shared
    # counter (mesh_devices and chain_batch_k* too) compares
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 8)
    r_port = assemble(*args, tmp_path / "port", device="cpu")
    r_jax = jax_assemble(*args, tmp_path / "jax")
    for name in OUTPUTS:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert set(r_port["timer"].stages) == set(r_jax["timer"].stages)
    shared = set(r_port["timer"].counters) & set(r_jax["timer"].counters)
    assert {k: r_port["timer"].counters[k] for k in shared} == {
        k: r_jax["timer"].counters[k] for k in shared}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_cli_core_cpu(tmp_path):
    paths = _small_data(tmp_path, seed=3, glen=20_000)
    outdir = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "muchsalsa_tpu_torch.pipeline.cli", "core",
         str(paths["paf"]), str(paths["unitigs"]), str(paths["reads"]), str(outdir),
         "1", "300", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Finished assembly" in proc.stdout
    assert "components=" in proc.stdout
    assert (outdir / "temp_1.target.fa").stat().st_size > 0


def test_port_cli_missing_input(tmp_path, capsys):
    rc = main(["core", str(tmp_path / "nope.paf"), str(tmp_path / "u.fa"),
               str(tmp_path / "r.fa"), str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 1
    assert "missing" in capsys.readouterr().err


_NO_JAX = """
import sys
from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation
import numpy as np
sim = simulate(np.random.default_rng(5), genome_length=15_000, coverage=6.0)
paths = write_simulation(sim, sys.argv[1] + "/data")
r = assemble(paths["paf"], paths["unitigs"], paths["reads"], sys.argv[1] + "/out",
             device="cpu")
assert r["timer"].counters["chain_device_problems"] > 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NO_JAX_OK")
"""


def test_port_assembly_never_loads_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # the CLI's default device is cuda: it raises rather than run on the CPU
    paths = _small_data(tmp_path, seed=3, glen=20_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["core", str(paths["paf"]), str(paths["unitigs"]), str(paths["reads"]),
              str(tmp_path / "out")])
