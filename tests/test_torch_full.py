"""The port's ``full`` pipeline and CLI against the JAX package's.

Raw Illumina pairs and long reads are simulated (numpy, from a seed) by
``tests/test_full_pipeline.py::make_inputs``.  The port runs on CPU tensors
with device mapping on, in one case with the k-mer, DBG and scrub device
legs on too and in one with every map stage on the v1 join; the JAX
package runs its all-host pipeline.
Tolerance: byte-equal assembly, PAFs and intermediate FASTA files.
"""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from muchsalsa_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from muchsalsa_tpu.ops import mapping_jax
from muchsalsa_tpu.pipeline import cli as jax_cli
from muchsalsa_tpu.pipeline.full import run_full_pipeline as jax_full
from muchsalsa_tpu_torch.config import DEFAULT_CONFIG
from muchsalsa_tpu_torch.pipeline import cli
from muchsalsa_tpu_torch.pipeline import mapper_torch
from muchsalsa_tpu_torch.ops.dbg_torch import DBG_DEVICE_STATS
from muchsalsa_tpu_torch.ops.kmer_torch import KMER_DEVICE_STATS
from muchsalsa_tpu_torch.pipeline.full import run_full_pipeline
from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS
from tests.test_full_pipeline import make_inputs

PAFS = ("01_unitigs.paf", "01_contigs_corrected.paf", "02_contigs_corrected.scrubbed.paf")
FASTAS = ("01_illu_filtered.fa", "01_unitigs.fa", "02_scrubbed.fa")
STAGES = ("kmer_filter", "unitigs", "map_unitigs", "unitig_filter", "map_corrected", "scrub",
          "map_scrubbed", "core_assembly")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("full_inputs"), seed=321)


def with_refine(cfg):
    return dataclasses.replace(cfg, mapper=dataclasses.replace(cfg.mapper, refine=True))


REFINE = with_refine(DEFAULT_CONFIG)


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    _genome, illu1, illu2, nano = inputs
    out = tmp_path_factory.mktemp("jax_full")
    jax_full(illu1, illu2, nano, out, device_map=False)
    return out


@pytest.fixture(scope="module")
def jax_refined_run(inputs, tmp_path_factory):
    _genome, illu1, illu2, nano = inputs
    out = tmp_path_factory.mktemp("jax_full_refined")
    jax_full(illu1, illu2, nano, out, with_refine(JAX_DEFAULT_CONFIG), device_map=False)
    return out


@pytest.mark.parametrize("refine,legs,v1", [pytest.param(False, False, False, id="False"),
                                             pytest.param(True, False, False, id="True"),
                                             pytest.param(False, True, False, id="legs"),
                                             pytest.param(False, False, True, id="v1")])
def test_full_matches_jax(inputs, request, tmp_path, monkeypatch, refine, legs, v1):
    """With ``mapper.refine`` the three map stages also refine (the JAX
    package's exact Myers on the CPU against the port's plain version);
    with ``legs`` the k-mer counting, the DBG extension table and the
    scrub's all-vs-all run on CPU tensors too; with ``v1`` both packages'
    ``build_device_tables`` refuse, as for every genome from ~60 Mb up, so
    each map stage takes the v1 join."""
    _genome, illu1, illu2, nano = inputs
    jax_run = request.getfixturevalue("jax_refined_run" if refine else "jax_run")
    if v1:
        monkeypatch.setattr(mapping_jax, "build_device_tables", lambda *a, **k: None)
        monkeypatch.setattr(mapper_torch, "build_device_tables", lambda *a, **k: None)
    out = tmp_path / "port"
    final = run_full_pipeline(illu1, illu2, nano, out, REFINE if refine else DEFAULT_CONFIG,
                              device="cpu", device_map=True, device_kmer=legs,
                              device_dbg=legs, device_scrub=legs)
    assert final == out / "03.assembly.unpolished.fa"
    assert final.read_bytes() == (jax_run / final.name).read_bytes()
    assert final.read_bytes().count(b">") >= 1
    for name in PAFS + FASTAS:
        assert (out / name).read_bytes() == (jax_run / name).read_bytes(), name
    report = (out / "report.txt").read_text()
    for name in PAFS:
        assert f"device map {name}: " in report
        line = report.split(f"device map {name}: ")[1].splitlines()[0]
        assert f"v2={not v1}" in line, name
    assert "abundance threshold" in report
    assert mapper_torch.DEVICE_MAP_STATS["device"] == "cpu"
    assert f"kmer={legs} scrub={legs} dbg={legs} (torch device cpu)" in report
    for leg in ("kmer", "dbg", "scrub"):
        assert (f"device {leg}: " in report) == legs, leg
    if legs:
        assert KMER_DEVICE_STATS["chunks"] > 0 and DBG_DEVICE_STATS["rows"] > 0
        # these reads overlap deeply enough that the scrub's guard declines
        # (tests/test_torch_scrub.py maps subsets on the device)
        scrub = SCRUB_DEVICE_STATS
        assert scrub["subsets"] and scrub["on_device"] + scrub["declined"] == len(scrub["subsets"])


def test_full_host_mapping_matches_jax(inputs, jax_run, tmp_path):
    _genome, illu1, illu2, nano = inputs
    final = run_full_pipeline(illu1, illu2, nano, tmp_path, device="cpu", device_map=False)
    assert final.read_bytes() == (jax_run / final.name).read_bytes()
    assert "device map" not in (tmp_path / "report.txt").read_text()


def test_full_resume_skips_every_stage(inputs, tmp_path, capsys):
    _genome, illu1, illu2, nano = inputs
    run_full_pipeline(illu1, illu2, nano, tmp_path, device="cpu")
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert set(manifest) == set(STAGES)
    capsys.readouterr()
    run_full_pipeline(illu1, illu2, nano, tmp_path, device="cpu")
    log = capsys.readouterr().out
    assert json.loads((tmp_path / "manifest.json").read_text()) == manifest
    for stage in STAGES:
        assert f"{stage}: up to date, skipping" in log


def test_full_on_cuda_without_a_card_raises(inputs, tmp_path, monkeypatch):
    _genome, illu1, illu2, nano = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_full_pipeline(illu1, illu2, nano, tmp_path)


def test_map_cli_matches_jax(inputs, jax_run, tmp_path):
    """The port's ``map`` (device mapping on CPU tensors, and host mapping)
    writes the JAX ``map`` CLI's PAF."""
    _genome, _illu1, _illu2, nano = inputs
    unitigs = jax_run / "01_unitigs.fa"
    assert jax_cli.main(["map", str(unitigs), str(nano), str(tmp_path / "jax.paf")]) == 0
    want = (tmp_path / "jax.paf").read_bytes()
    assert cli.main(["map", str(unitigs), str(nano), str(tmp_path / "dev.paf"),
                     "--device", "cpu"]) == 0
    assert (tmp_path / "dev.paf").read_bytes() == want
    assert cli.main(["map", str(unitigs), str(nano), str(tmp_path / "host.paf"),
                     "--no-device-map"]) == 0
    assert (tmp_path / "host.paf").read_bytes() == want
    assert want.count(b"\n") > 10
    assert cli.main(["map", str(tmp_path / "absent.fa"), str(nano), str(tmp_path / "x.paf"),
                     "--device", "cpu"]) == 1


def test_full_and_config_cli(inputs, jax_run, tmp_path, capsys):
    _genome, illu1, illu2, nano = inputs
    assert cli.main(["full", "--illumina1", str(illu1), "--illumina2", str(illu2),
                     "--nanopore", str(nano), "--out", str(tmp_path / "out"),
                     "--device", "cpu", "--device-kmer", "--device-dbg", "--no-device-scrub"]) == 0
    final = tmp_path / "out" / "03.assembly.unpolished.fa"
    assert f"Assembly written to {final}" in capsys.readouterr().out
    assert final.read_bytes() == (jax_run / final.name).read_bytes()
    report = (tmp_path / "out" / "report.txt").read_text()
    assert "kmer=True scrub=False dbg=True (torch device cpu)" in report
    assert cli.main(["full", "--illumina1", str(tmp_path / "absent.fa"), "--nanopore",
                     str(nano), "--out", str(tmp_path / "x"), "--device", "cpu"]) == 1

    assert cli.main(["config"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(DEFAULT_CONFIG.to_json())
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"mapper": {"refine": True}}))
    assert cli.main(["--config", str(cfg_path), "config"]) == 0
    assert json.loads(capsys.readouterr().out)["mapper"]["refine"] is True


def test_port_full_and_cli_load_no_jax(inputs, tmp_path):
    """In a process of its own, importing the port's ``full`` and CLI and
    running ``map`` and ``full`` on the CPU loads no jax and no module of
    the JAX package."""
    _genome, illu1, illu2, nano = inputs
    code = "\n".join([
        "import sys",
        "import muchsalsa_tpu_torch.pipeline.full",
        "from muchsalsa_tpu_torch.pipeline import cli",
        "def reference_modules():",
        "    return sorted(m for m in sys.modules",
        "                  if m == 'muchsalsa_tpu' or m.startswith('muchsalsa_tpu.'))",
        "assert 'jax' not in sys.modules, 'import loaded jax'",
        "assert not reference_modules(), reference_modules()",
        f"assert cli.main(['full', '--illumina1', {str(illu1)!r}, '--nanopore', {str(nano)!r},"
        f" '--out', {str(tmp_path / 'out')!r}, '--device', 'cpu']) == 0",
        f"assert cli.main(['map', {str(tmp_path / 'out' / '01_unitigs.fa')!r}, {str(nano)!r},"
        f" {str(tmp_path / 'm.paf')!r}, '--device', 'cpu']) == 0",
        "assert 'jax' not in sys.modules, 'running full or map loaded jax'",
        "assert not reference_modules(), reference_modules()",
    ])
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600)
    assert (tmp_path / "out" / "03.assembly.unpolished.fa").exists()
