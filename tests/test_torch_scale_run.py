"""The port's scale run (``scripts/torch_scale_run.py``,
``muchsalsa_tpu_torch/testing/scale.py``) against the JAX package's
``scripts/scale_run.py``.

At 0.25 Mb the two scripts run side by side in subprocesses with every leg
on the host (``--host``; the port with ``--device cpu``): the same seed,
the same arguments.  Tolerance: exact bytes for the three inputs and the
assembly, exact text for the contig line, exact equality for the parsed
arguments and the recorded row.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from muchsalsa_tpu_torch.testing.scale import (
    ASSEMBLY, INPUTS, SCALE_ROWS, contig_stats, scale_row, sha256, stats_line)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: its tensors are
    small, and an op's thread pool slows it many times over when test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_script(name: str):
    """``scripts/{name}.py`` as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(f"_scale_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts at 0.25 Mb, 12x, 30x Illumina, legs on the host, run at
    once; their output directories and standard outputs."""
    base = tmp_path_factory.mktemp("scale_run")
    # the scripts as a user runs them: one CPU device, not the eight that
    # tests/conftest.py makes for the JAX package's mesh tests
    xla = os.environ.get("XLA_FLAGS", "").replace("--xla_force_host_platform_device_count=8", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", XLA_FLAGS=xla.strip(),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    args = ["0.25", "12", None, "30", "--host"]
    procs = {}
    for name, script, extra in (("jax", "scale_run.py", []),
                                ("torch", "torch_scale_run.py", ["--device", "cpu"])):
        argv = [a if a is not None else str(base / name) for a in args]
        procs[name] = subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / script), *argv, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=base)
    result = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
        result[name] = (base / name, out.splitlines())
    return result


@pytest.mark.parametrize("name", (*INPUTS, ASSEMBLY))
def test_inputs_and_assembly_are_the_jax_scripts_bytes(runs, name):
    rel = name if name in INPUTS else f"full_out/{name}"
    jax_bytes = (runs["jax"][0] / rel).read_bytes()
    assert jax_bytes
    assert (runs["torch"][0] / rel).read_bytes() == jax_bytes


def test_contig_lines_match(runs):
    def contig_line(lines):
        found = [ln for ln in lines if ln.startswith("[scale_run] contigs=")]
        assert len(found) == 1, lines
        return found[0]

    assert contig_line(runs["torch"][1]) == contig_line(runs["jax"][1])
    assert contig_line(runs["jax"][1]) == "[scale_run] " + stats_line(SCALE_ROWS[0.25]["stats"])


def test_recorded_row_is_the_live_jax_run(runs):
    jax_dir = runs["jax"][0]
    row = SCALE_ROWS[0.25]
    got = {name: sha256(jax_dir / name) for name in INPUTS}
    got[ASSEMBLY] = sha256(jax_dir / "full_out" / ASSEMBLY)
    assert got == row["sha256"]
    assert contig_stats(jax_dir / "full_out" / ASSEMBLY) == row["stats"]


@pytest.mark.parametrize("mb", sorted(SCALE_ROWS))
def test_every_row_holds_the_jax_scripts_hashes_and_stats(mb):
    """Each row, 140 Mb included, is a run of the JAX script with
    ``--host`` on the CPU: four sha256 values, the contig statistics, and
    ``made_by`` naming that command at the row's size."""
    row = SCALE_ROWS[mb]
    assert set(row) == {"coverage", "illu_cov", "stats", "sha256", "made_by"}
    assert set(row["sha256"]) == {*INPUTS, ASSEMBLY}
    assert all(len(h) == 64 and int(h, 16) >= 0 for h in row["sha256"].values())
    assert set(row["stats"]) == {"contigs", "total", "n50", "longest"}
    assert row["stats"]["contigs"] >= 1
    assert row["stats"]["longest"] >= row["stats"]["n50"]
    assert row["stats"]["total"] >= row["stats"]["longest"]
    assert f"scripts/scale_run.py {mb:g} 12 OUT 30 --host" in row["made_by"]
    assert scale_row(mb, 12, 30) is row
    assert scale_row(mb, 15, 30) is None and scale_row(mb, 12, 25) is None


def test_140_mb_row_is_the_statistics_baseline_printed():
    """The 140 Mb row's statistics print as BASELINE.md's flagship line."""
    assert stats_line(SCALE_ROWS[140.0]["stats"]) == (
        "contigs=79 total=140.65Mb N50=3.10Mb longest=8.48Mb")


def test_twin_reports_its_row_equal(runs):
    record = json.loads(runs["torch"][1][-1])
    assert record["row"] is True
    assert record["equal"] == {**{n: True for n in (*INPUTS, ASSEMBLY)}, "stats": True}
    assert record["device"] == "cpu" and record["card"] is None
    assert record["placement"] == dict.fromkeys(
        ("device_map", "device_kmer", "device_scrub", "device_dbg"), False)
    assert record["reference_loaded"] == []
    assert set(record["stages_s"]) == {
        "kmer_filter", "unitigs", "map_unitigs", "unitig_filter", "map_corrected", "scrub",
        "map_scrubbed", "core_assembly"}
    assert record["chain"]["chain_device_problems"] > 0
    assert record["map"] == {} and record["peak_rss_bytes"] > 0


@pytest.mark.parametrize("text,want", [
    ("", {"contigs": 0, "total": 0, "n50": 0, "longest": 0}),
    (">c1\nACGTA\nCG\n", {"contigs": 1, "total": 7, "n50": 7, "longest": 7}),
    # 6 + 4 + 2 = 12: the running sum reaches half at the first contig
    (">a\nAAAA\n>b\nCCCCCC\n>c\nGG\n", {"contigs": 3, "total": 12, "n50": 6, "longest": 6}),
    # 5 + 5: an even split, half reached exactly at the first
    (">a\nAAAAA\n>b\nCCCCC\n", {"contigs": 2, "total": 10, "n50": 5, "longest": 5}),
    # blank lines add nothing, and a record of no bases is no contig
    ("\n>a\nAAA\n\nAA\n>empty\n\n>b\nCCC\n\n", {"contigs": 2, "total": 8, "n50": 5,
                                                "longest": 5}),
], ids=["empty", "one", "three", "even_split", "blank_lines"])
def test_contig_stats_by_hand(tmp_path, text, want):
    path = tmp_path / "a.fa"
    path.write_text(text)
    assert contig_stats(path) == want


@pytest.mark.parametrize("argv", [
    ["--host"],
    ["twelve"],
    ["12", "12", "OUT", "--host"],
    ["0.25", "12", "OUT", "thirty", "--host"],
    ["12", "--device-map"],
], ids=["flag_first", "genome_not_a_number", "flag_in_illu_cov", "illu_cov_not_a_number",
        "flag_in_coverage"])
def test_argument_parsing_rejects_what_the_jax_script_rejects(monkeypatch, argv):
    jax_script = load_script("scale_run")
    twin = load_script("torch_scale_run")
    monkeypatch.setattr(sys, "argv", ["scale_run.py", *argv])
    with pytest.raises(ValueError):
        jax_script.main()
    with pytest.raises(ValueError):
        twin.parse_args(["torch_scale_run.py", *argv])


def test_argument_parsing_reads_places_and_flags():
    twin = load_script("torch_scale_run")
    got = twin.parse_args(["x", "0.25", "12", "OUT", "30", "--host", "--device", "cpu"])
    assert got == {"genome_mb": 0.25, "coverage": 12.0, "out": Path("OUT"), "illu_cov": 30.0,
                   "host": True, "device_map": False, "device": "cpu",
                   "chain_batches": False}
    assert twin.parse_args(["x"])["genome_mb"] == 12.0
    assert twin.parse_args(["x"])["device"] == "cuda"
    with pytest.raises(ValueError, match="--device"):
        twin.parse_args(["x", "1", "12", "OUT", "30", "--device", "tpu"])
    with pytest.raises(ValueError, match="--device"):
        twin.parse_args(["x", "1", "12", "OUT", "30", "--device"])


def test_twin_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    twin = load_script("torch_scale_run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["x", "0.25", "12", str(tmp_path), "30"])
    assert not any(tmp_path.iterdir())
