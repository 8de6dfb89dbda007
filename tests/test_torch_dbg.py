"""The port's DBG device leg against the JAX package's.

Reads are made from numpy seeds; the port builds its extension table on CPU
tensors (its plain torch path), the JAX package on the CPU.  Tolerance:
exact equality of every table entry, and byte-equal unitig lists in order.
"""

import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.dbg_jax import ext_indices_device as jax_ext_indices_device
from muchsalsa_tpu.pipeline.dbg import UnitigBuilder as JaxUnitigBuilder
from muchsalsa_tpu.pipeline.dbg import build_unitigs as jax_build_unitigs
from muchsalsa_tpu.pipeline.kmer import count_kmers
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu_torch import native
from muchsalsa_tpu_torch.ops.dbg_torch import DBG_DEVICE_STATS, _revcomp, ext_indices_device
from muchsalsa_tpu_torch.pipeline import dbg
from muchsalsa_tpu_torch.pipeline.dbg import _revcomp_val, build_unitigs


def _reads(rng, genome, n, L=120):
    G = len(genome)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, max(G - L, 1)))
        out.append(genome[s : s + L])
    return out


@pytest.mark.parametrize("k", [15, 17, 31])
def test_ext_indices_match_jax(k):
    """The extension table equals the JAX package's at 2k < 32, > 32 and
    == 62, in small chunks on both sides."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 3_000)
    b = JaxUnitigBuilder(_reads(rng, genome, 400), k=k, min_count=2)
    vals = np.ascontiguousarray(b._kmers_sorted, dtype=np.uint64)
    want = jax_ext_indices_device(vals, k, chunk=1024)
    got = ext_indices_device(vals, k, chunk=1000, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(vals), 8)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > len(vals)  # the walk has edges
    assert DBG_DEVICE_STATS == {"device": "cpu", "rows": len(vals), "chunks": 3}


def test_ext_indices_match_jax_rank_table():
    """At k = 31 and more than 65,536 k-mers the JAX package searches
    through its rank table; the indices are the same."""
    genome = random_genome(np.random.default_rng(8), 70_000)
    vals, _counts = count_kmers([genome], 31)
    assert len(vals) > 1 << 16
    want = jax_ext_indices_device(vals, 31, chunk=1 << 15)
    got = ext_indices_device(vals, 31, chunk=1 << 15, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() >= len(vals)


def test_revcomp_matches_the_host():
    rng = np.random.default_rng(2)
    for k in (1, 15, 16, 17, 31):
        v = rng.integers(0, 1 << (2 * k), 50, dtype=np.int64)
        got = _revcomp(torch.from_numpy(v), k).tolist()
        assert got == [_revcomp_val(int(x), k) for x in v], k


def repeat_genome_reads():
    """test_dbg_device.py's repeat-rich genome and its reads."""
    rng = np.random.default_rng(6)
    rep = random_genome(rng, 300)
    genome = (random_genome(rng, 4_000) + rep + random_genome(rng, 2_000)
              + rep + random_genome(rng, 4_000))
    return _reads(rng, genome, 3_000)


def test_device_build_matches_jax():
    """build_unitigs(device="cpu") emits the JAX package's unitig list (order
    and bytes), on its device leg and on its default walker."""
    reads = repeat_genome_reads()
    got = build_unitigs(reads, k=31, min_count=2, min_length=100, device="cpu")
    assert got == jax_build_unitigs(reads, k=31, min_count=2, min_length=100, device=True)
    assert got == jax_build_unitigs(reads, k=31, min_count=2, min_length=100)
    assert got == build_unitigs(reads, k=31, min_count=2, min_length=100)
    assert len(got) >= 2  # the repeat breaks the walk
    assert DBG_DEVICE_STATS["rows"] > 0


def test_device_build_matches_jax_without_native(monkeypatch):
    """The same with the python stitch (native disabled), against the JAX
    package's python walker."""
    from muchsalsa_tpu import native as jax_native

    rng = np.random.default_rng(7)
    genome = random_genome(rng, 5_000)
    reads = _reads(rng, genome, 1_500)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    got = build_unitigs(reads, k=15, min_count=2, min_length=80, device="cpu")
    assert got == jax_build_unitigs(reads, k=15, min_count=2, min_length=80, device=True)
    assert got == jax_build_unitigs(reads, k=15, min_count=2, min_length=80)
    assert got


def test_device_leg_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError):
        ext_indices_device(np.zeros(3, dtype=np.uint64), 32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dbg.UnitigBuilder(repeat_genome_reads()[:200], k=31).build(100, device="cuda")
