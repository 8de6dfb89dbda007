"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "muchsalsa_tpu"}


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"muchsalsa_tpu_torch", "muchsalsa_tpu"}


def test_reference_loads_no_program_module():
    code = ("import sys, portbench.reference, portbench.sim; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'muchsalsa_tpu_torch', 'muchsalsa_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "muchsalsa_tpu_torch.pipeline", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "muchsalsa_tpu"})
    monkeypatch.setitem(sys.modules, "muchsalsa_tpu.ops", sys)
    assert "muchsalsa_tpu" in harness.forbidden_modules()
