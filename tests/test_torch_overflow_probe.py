"""The port's overflow probe (``scripts/torch_overflow_probe.py``) against
the JAX package's ``scripts/overflow_probe.py`` on the CPU.

Both scripts run at a small repeat-rich genome in subprocesses; the
device budgets do not depend on the device, so the per-budget breakdown
(the index, the shares of hot minimizers, the overflow count and the
counters both packages keep in ``DEVICE_MAP_STATS``) must be equal.
Tolerance: exact.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# 12 reads of which 4 overflow to the host and 5 go through tier 2: the
# smallest size found that reaches both budgets
ARGS = ("0.2", "0.15", "12")


@pytest.fixture(scope="module")
def lines():
    # the scripts as a user runs them: one CPU device, not the eight that
    # tests/conftest.py makes for the JAX package's mesh tests
    xla = os.environ.get("XLA_FLAGS", "").replace("--xla_force_host_platform_device_count=8", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", XLA_FLAGS=xla.strip(),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / script), *ARGS, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, script, extra in (("jax", "overflow_probe.py", ()),
                                    ("torch", "torch_overflow_probe.py", ("--device", "cpu")))}
    result = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
        result[name] = out.splitlines()
    return result


def breakdown(lines: list[str]) -> dict:
    """The figures of the ``[overflow]`` lines, timings left out."""
    got = {}
    for ln in lines:
        if m := re.match(r"\[overflow\] index: (\d+) hashes, (\d+) entries", ln):
            got["index"] = m.groups()
        elif m := re.match(r"\[overflow\] minimizers with >(\d+) entries: (\S+)%", ln):
            got[f"hot_{m.group(1)}"] = m.group(2)
        elif m := re.match(r"\[overflow\] device-path map of (\d+) reads: \S+; "
                           r"overflow (\d+)/(\d+) = (\S+)% \(stats=(\{.*\})\)", ln):
            got["overflow"] = m.groups()[:4]
            got["stats"] = ast.literal_eval(m.group(5))
    return got


def test_overflow_breakdown_equals_the_jax_scripts(lines):
    jax, port = breakdown(lines["jax"]), breakdown(lines["torch"])
    assert set(jax) == {"index", "hot_4", "hot_8", "hot_16", "overflow", "stats"}
    shared = set(jax["stats"]) & set(port["stats"])
    assert shared >= {"total_reads", "overflow_reads", "tier2_reads", "dense_repulls", "v2",
                      "batch_reads", "meshed", "n_devices"}
    assert {k: port["stats"][k] for k in shared} == {k: jax["stats"][k] for k in shared}
    assert {k: v for k, v in port.items() if k != "stats"} == {
        k: v for k, v in jax.items() if k != "stats"}
    assert port["stats"]["device"] == "cpu"
    # both budgets acted at this size
    assert jax["stats"]["tier2_reads"] > 0 and jax["stats"]["overflow_reads"] > 0


def test_overflow_json_line_holds_the_printed_figures(lines):
    record = json.loads(lines["torch"][-1])
    printed = breakdown(lines["torch"])
    assert (str(record["hashes"]), str(record["entries"])) == printed["index"]
    assert record["stats"] == printed["stats"]
    assert record["overflow_reads"] == printed["stats"]["overflow_reads"]
    assert record["card"] is None and record["device"] == "cpu"
