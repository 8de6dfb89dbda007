"""The port's device k-mer counter against the JAX package's and the host's.

Reads are made from numpy seeds and fed to both packages; the port runs on
CPU tensors (its wrappers' plain torch path), the JAX package on the CPU.
Tolerance: exact equality of every value, count and flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.kmer_jax import count_kmers_device as jax_count_kmers_device
from muchsalsa_tpu.ops.kmer_jax import kmer_hi_lo_batch, sort_count_chunk as jax_sort_count_chunk
from muchsalsa_tpu.pipeline.kmer import count_kmers
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu.utils.seq import encode_2bit
from muchsalsa_tpu_torch.ops.kmer_torch import (
    KMER_DEVICE_STATS, SENTINEL, count_kmers_device, kmer_values_batch, sort_count_chunk)


def read_batch(seed, R=6, L=300):
    """(R, L) codes with an N base in row 1 and short lens (the codes past a
    row's length are real bases, not padding), and the lens."""
    rng = np.random.default_rng(seed)
    codes = np.stack([encode_2bit(random_genome(rng, L)) for _ in range(R)])
    codes[1, 57] = 4
    codes[3, 10:20] = 4
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    lens[0], lens[1] = L, L
    return codes, lens


def jax_values(codes, lens, k):
    hi, lo, valid = kmer_hi_lo_batch(jnp.asarray(codes), jnp.asarray(lens), k)
    vals = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return vals, np.asarray(valid)


@pytest.mark.parametrize("k", (15, 25, 31))
def test_kmer_values_batch_matches_jax(k):
    codes, lens = read_batch(k)
    want, want_valid = jax_values(codes, lens, k)
    vals, valid = kmer_values_batch(torch.from_numpy(codes), torch.from_numpy(lens), k)
    assert vals.dtype == torch.int64 and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert not want_valid[1].all() and want_valid[0].all()
    # every position, valid or not: the int64 holds hi << 32 | lo
    np.testing.assert_array_equal(vals.numpy().astype(np.uint64), want)
    assert int(vals.max()) < 1 << (2 * k)


def test_sort_count_chunk_matches_jax():
    codes, lens = read_batch(3, R=8, L=200)
    codes[4] = codes[2]  # repeated k-mers: runs longer than one
    lens[4] = lens[2]
    k = 15
    want_vals, want_valid = jax_values(codes, lens, k)
    hi, lo, valid = kmer_hi_lo_batch(jnp.asarray(codes), jnp.asarray(lens), k)
    hi_s, lo_s, w_counts, w_first, w_n = (np.asarray(x) for x in jax_sort_count_chunk(hi, lo, valid))
    vals, valid = kmer_values_batch(torch.from_numpy(codes), torch.from_numpy(lens), k)
    s, counts, first, n = sort_count_chunk(vals, valid)
    n = int(n)
    assert n == int(w_n) == int(want_valid.sum())
    sorted_want = (hi_s.astype(np.uint64) << np.uint64(32)) | lo_s.astype(np.uint64)
    np.testing.assert_array_equal(s.numpy()[:n].astype(np.uint64), sorted_want[:n])
    assert (s.numpy()[n:] == SENTINEL).all()
    np.testing.assert_array_equal(first.numpy()[:n], w_first[:n])
    np.testing.assert_array_equal(counts.numpy()[:n], w_counts[:n])
    assert counts.numpy()[:n].max() > 1


def mixed_reads():
    """test_kmer_jax.py's set: 60 random reads, a duplicate, a substring and
    a read shorter than k."""
    rng = np.random.default_rng(11)
    seqs = [random_genome(rng, int(rng.integers(40, 3000))) for _ in range(60)]
    seqs.append(seqs[0])
    seqs.append(seqs[1][10:900])
    seqs.append(b"ACG")
    return seqs


@pytest.mark.parametrize("chunk_bases,row_len", [(1 << 15, 1 << 10), (1 << 12, 1 << 9)])
def test_count_kmers_device_matches_jax_and_host(chunk_bases, row_len):
    seqs, k = mixed_reads(), 25
    host_u, host_c = count_kmers(seqs, k)
    jax_u, jax_c = jax_count_kmers_device(seqs, k, chunk_bases=chunk_bases, row_len=row_len)
    got_u, got_c = count_kmers_device(seqs, k, chunk_bases=chunk_bases, row_len=row_len,
                                      device="cpu")
    assert got_u.dtype == np.uint64 and got_c.dtype == np.int64
    np.testing.assert_array_equal(got_u, host_u)
    np.testing.assert_array_equal(got_c, host_c)
    np.testing.assert_array_equal(got_u, jax_u)
    np.testing.assert_array_equal(got_c, jax_c)
    stats = dict(KMER_DEVICE_STATS)
    assert stats["device"] == "cpu" and stats["chunks"] > 1
    assert stats["kmers"] == int(host_c.sum()) and stats["distinct"] == len(host_u)


def test_count_kmers_device_long_read_fragmentation():
    """A sequence longer than row_len fragments with k-1 overlap and still
    counts every k-mer exactly once."""
    seq = random_genome(np.random.default_rng(3), 5000)
    k = 21
    host_u, host_c = count_kmers([seq], k)
    got_u, got_c = count_kmers_device([seq], k, chunk_bases=1 << 12, row_len=512, device="cpu")
    np.testing.assert_array_equal(got_u, host_u)
    np.testing.assert_array_equal(got_c, host_c)
    jax_u, jax_c = jax_count_kmers_device([seq], k, chunk_bases=1 << 12, row_len=512)
    np.testing.assert_array_equal(got_u, jax_u)
    np.testing.assert_array_equal(got_c, jax_c)
    assert KMER_DEVICE_STATS["rows"] == 11  # ceil((5000 - 20) / (512 - 20))


@pytest.mark.parametrize("merge_elems", (1, 20_000, 1 << 26))
def test_count_kmers_device_merges_runs_in_groups(merge_elems):
    """Many small chunks whose runs merge in groups of at least
    ``merge_elems`` values and of the last merge's size (so a log number of
    merges; 1 << 26: none before the end) give ``count_kmers``'s values
    and counts exactly."""
    seqs, k = mixed_reads(), 25
    host_u, host_c = count_kmers(seqs, k)
    got_u, got_c = count_kmers_device(seqs, k, chunk_bases=1 << 11, row_len=1 << 9,
                                      device="cpu", merge_elems=merge_elems)
    np.testing.assert_array_equal(got_u, host_u)
    np.testing.assert_array_equal(got_c, host_c)
    stats = dict(KMER_DEVICE_STATS)
    assert stats["chunks"] > 40 and stats["distinct"] == len(host_u)
    if merge_elems < 1 << 26:
        assert 1 < stats["merges"] <= stats["chunks"].bit_length()
    else:
        assert stats["merges"] == 0


def test_count_kmers_device_empty():
    u, c = count_kmers_device([], 25, device="cpu")
    assert len(u) == 0 and len(c) == 0
    assert u.dtype == np.uint64 and c.dtype == np.int64
    assert KMER_DEVICE_STATS["chunks"] == 0


def test_count_kmers_device_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError):
        kmer_values_batch(torch.zeros((1, 40), dtype=torch.uint8),
                          torch.tensor([40], dtype=torch.int32), 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_kmers_device(mixed_reads(), 25)
