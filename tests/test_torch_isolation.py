"""The port stands alone: it imports nothing of the JAX package and no JAX.

- In a process of its own, with an import hook that refuses ``jax``,
  ``muchsalsa_tpu``, ``bench`` and ``__graft_entry__`` (and every submodule
  of each), every module of ``muchsalsa_tpu_torch`` imports, and the port's
  ``assemble`` on the CPU reproduces the golden sha256 values of
  tests/test_golden.py.
- No source file of the port, no ``scripts/torch_*.py`` and not
  ``chip_smoke.py`` holds an ``import`` or ``from`` of any of those.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_golden import GOLDEN

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "muchsalsa_tpu_torch"
# the JAX package, JAX, and the JAX package's benchmark and driver entry at the root
REFUSED = ("jax", "muchsalsa_tpu", "bench", "__graft_entry__")

_BLOCKED_RUN = r"""
import hashlib
import importlib
import importlib.abc
import json
import sys
from pathlib import Path

REFUSED = tuple(json.loads(sys.argv[3]))


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())

port = Path(sys.argv[1]) / "muchsalsa_tpu_torch"
modules = []
for path in sorted(port.rglob("*.py")):
    parts = path.relative_to(port.parent).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    modules.append(".".join(parts))
for name in modules:
    importlib.import_module(name)

import numpy as np

from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

work = Path(sys.argv[2])
sim = simulate(np.random.default_rng(20260817), genome_length=60_000, unitig_length=1_100,
               unitig_gap=300, read_length=6_000, coverage=9.0, both_strands=True)
paths = write_simulation(sim, work / "data")
assemble(paths["paf"], paths["unitigs"], paths["reads"], work / "out", device="cpu")
loaded = sorted(m for m in sys.modules if any(m == r or m.startswith(r + ".") for r in REFUSED))
assert not loaded, loaded
print(json.dumps({"modules": len(modules), "sha256": {
    n: hashlib.sha256((work / "out" / n).read_bytes()).hexdigest()
    for n in ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")}}))
"""


def test_port_imports_and_assembles_with_the_reference_refused(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(REPO), str(tmp_path), json.dumps(REFUSED)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["modules"] > 40
    assert result["sha256"] == GOLDEN


def _port_sources():
    return [*sorted(PORT.rglob("*.py")), *sorted((REPO / "scripts").glob("torch_*.py")),
            REPO / "chip_smoke.py"]


def _imports_of(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_of_the_port_imports_the_reference(path):
    bad = [n for n in _imports_of(path) if any(n == r or n.startswith(r + ".") for r in REFUSED)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
