"""The port's multi-process paths: ``scripts/torch_distributed_{core,scrub,
segment}.py`` in 2 or 4 processes of one gloo process group on the CPU
(``--device cpu``), against single-process runs.

The fixtures are those of tests/test_distributed_{core,scrub,segment}.py.
Each child runs a script with ``sys.executable``, so it never imports this
directory's conftest (which imports JAX), on a free localhost port, under a
timeout.  Tolerance: identical bytes.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from muchsalsa_tpu.assemble.driver import assemble as jax_assemble
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore, write_fasta
from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, map_all, write_paf
from muchsalsa_tpu_torch.pipeline.scrubber import scrub_reads, torch_record_allgather
from tests.test_distributed_core import OUT_FILES, _free_port, _simulated_inputs
from tests.test_distributed_segment import OUT_FILES as SEGMENT_FILES
from tests.test_distributed_segment import _fixture as segment_fixture

REPO = Path(__file__).resolve().parent.parent
SENTINEL = "__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: its shards are
    small, and an op's thread pool slows it many times over when test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_group(script: str, n: int, args_of, timeout: float) -> list[str]:
    """``n`` processes of ``scripts/{script}`` in one process group on the
    CPU; ``args_of(pid)`` gives a process's arguments after the
    coordinator.  Returns their standard outputs; fails unless each exits 0."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # one thread a child, as one_torch_thread
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / script), str(pid), str(n), coordinator,
         *map(str, args_of(pid)), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so}\n{se[-3000:]}"
    return [so for so, _se in outs]


def test_two_process_core_matches_single_and_jax(tmp_path):
    paf, unitigs_fa, reads_fa = _simulated_inputs(tmp_path)
    single = assemble(paf, unitigs_fa, reads_fa, tmp_path / "single", workers=1, device="cpu")
    assert single["components"] >= 2 and single["paths"] >= 2
    jax_assemble(paf, unitigs_fa, reads_fa, tmp_path / "jax", workers=1)

    outdirs = [tmp_path / f"proc{pid}" for pid in range(2)]
    stdout = run_group("torch_distributed_core.py", 2,
                       lambda pid: (paf, unitigs_fa, reads_fa, outdirs[pid]), timeout=300)
    assert all(f"components={single['components']} paths={single['paths']}" in so
               for so in stdout)
    for name in OUT_FILES:
        want = (tmp_path / "single" / name).read_bytes()
        assert (tmp_path / "jax" / name).read_bytes() == want, name
        for pid in range(2):
            assert (outdirs[pid] / name).read_bytes() == want, (name, pid)


def scrub_fixture(tmp_path):
    """tests/test_distributed_scrub.py's reads, unitigs and anchor PAF,
    mapped by the port's host mapper."""
    rng = np.random.default_rng(77)
    genome = random_genome(rng, 40_000)
    reads, unitigs = SequenceStore(), SequenceStore()
    for i in range(10):
        reads.add(f"r{i}", genome[i * 3600 : i * 3600 + 7000])
    for i in range(9):
        unitigs.add(f"u{i}", genome[i * 3600 + 3000 : i * 3600 + 4200])
    mcfg = MapperConfig()
    paf = map_all(MinimizerIndex.build(unitigs, mcfg), reads, mcfg, device=False)
    reads_fa = tmp_path / "reads.fa"
    write_fasta(reads_fa, ((reads.registry.name(rid), seq) for rid, seq in reads.items()))
    paf_path = tmp_path / "mapped.paf"
    paf_path.write_text("\n".join(paf) + "\n")
    return reads_fa, paf_path, paf, mcfg


def test_two_process_scrub_matches_single(tmp_path):
    reads_fa, paf_path, paf, mcfg = scrub_fixture(tmp_path)
    reads = SequenceStore()
    reads.load(reads_fa)
    single = scrub_reads(paf, reads, ScrubConfig(subset_size=3), mcfg)
    # one process with an allgather keeps the single-process branch
    assert single == scrub_reads(paf, reads, ScrubConfig(subset_size=3), mcfg,
                                 allgather=torch_record_allgather)

    out_fa = tmp_path / "scrubbed.fa"
    run_group("torch_distributed_scrub.py", 2,
              lambda pid: (reads_fa, paf_path, out_fa, 3), timeout=240)
    expected = tmp_path / "expected.fa"
    write_fasta(expected, single)
    assert out_fa.read_bytes() == expected.read_bytes()


def test_four_process_segment_matches_single(tmp_path):
    reads_fa, anchors_paf, unitigs_fa, _jax_cfg = segment_fixture(tmp_path)
    subset_size = 4  # several BFS subsets across the processes

    single = tmp_path / "single"
    single.mkdir()
    mcfg = MapperConfig()
    reads = SequenceStore()
    reads.load(reads_fa)
    scrubbed = scrub_reads(anchors_paf.read_text().splitlines(), reads,
                           dataclasses.replace(ScrubConfig(), subset_size=subset_size), mcfg)
    assert scrubbed
    write_fasta(single / "scrubbed.fa", scrubbed)
    unitigs = SequenceStore()
    unitigs.load(unitigs_fa)
    sreads = SequenceStore()
    sreads.load(single / "scrubbed.fa")
    paf = map_all(MinimizerIndex.build(unitigs, mcfg), sreads, mcfg,
                  unitig_names=unitigs.registry.name, read_names=sreads.registry.name,
                  device=False)
    write_paf(paf + [SENTINEL], single / "scrubbed.paf")
    summary = assemble(single / "scrubbed.paf", unitigs_fa, single / "scrubbed.fa", single,
                       device="cpu")
    assert summary["components"] >= 3

    outdirs = [tmp_path / f"proc{pid}" for pid in range(4)]
    run_group("torch_distributed_segment.py", 4,
              lambda pid: (reads_fa, anchors_paf, unitigs_fa, outdirs[pid], subset_size),
              timeout=600)
    for name in SEGMENT_FILES:
        want = (single / name).read_bytes()
        for pid in range(4):
            assert (outdirs[pid] / name).read_bytes() == want, (name, pid)
