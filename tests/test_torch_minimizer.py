"""The port's minimizer sketch against the JAX package's.

Reads are random (numpy, from a seed) with Ns, short reads, heavy padding
and tied hashes; the same codes go through ``minimizer_jax`` (CPU) and
``minimizer_torch`` (CPU tensors).  Tolerance: exact equality of every
selected flag, hash and strand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.minimizer import minimizers
from muchsalsa_tpu.ops.minimizer_jax import fmix32_jnp
from muchsalsa_tpu.ops.minimizer_jax import minimizer_sketch as jax_sketch
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu.utils.seq import encode_2bit
from muchsalsa_tpu_torch.ops.minimizer_torch import fmix32, minimizer_sketch


def pad_batch(seqs, L=None):
    L = L or max(len(s) for s in seqs)
    codes = np.full((len(seqs), L), 4, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_2bit(s)
        lens[i] = len(s)
    return codes, lens


def both(codes, lens, k=15, w=5):
    want = [np.asarray(a) for a in jax_sketch(jnp.asarray(codes), jnp.asarray(lens), k, w)]
    got = [a.numpy() for a in minimizer_sketch(torch.from_numpy(codes), torch.from_numpy(lens),
                                               k, w)]
    return want, got


def assert_same(codes, lens, k=15, w=5):
    want, got = both(codes, lens, k, w)
    for name, a, b in zip(("selected", "hashes", "strands"), want, got):
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
    return got


def test_fmix32_edge_and_random_values():
    vals = np.concatenate([
        np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32),
        np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(fmix32_jnp(jnp.asarray(vals))).astype(np.int64)
    got = fmix32(torch.from_numpy(vals.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


def test_sketch_matches_jax_and_host_on_random_reads():
    rng = np.random.default_rng(0)
    seqs = [random_genome(rng, int(rng.integers(60, 400))) for _ in range(12)]
    codes, lens = pad_batch(seqs)
    selected, h, strand = assert_same(codes, lens)
    for i, s in enumerate(seqs):
        pos, hh, st = minimizers(s, 15, 5)
        np.testing.assert_array_equal(np.nonzero(selected[i])[0], pos)
        np.testing.assert_array_equal(h[i][pos], hh)
        np.testing.assert_array_equal(strand[i][pos], st)


def test_sketch_with_ns_padding_and_short_reads():
    """Ns inside reads, reads shorter than k (no position), reads with
    1..w positions (the single global minimum) and heavy padding."""
    rng = np.random.default_rng(1)
    seqs = []
    for n in (3, 14, 15, 16, 17, 18, 19, 20, 21, 40, 120, 300):
        s = bytearray(random_genome(rng, n))
        if n > 30:
            for p in rng.choice(n, size=n // 20, replace=False):
                s[p] = ord("N")
        seqs.append(bytes(s))
    codes, lens = pad_batch(seqs, L=512)
    selected, _, _ = assert_same(codes, lens)
    for i, s in enumerate(seqs):
        pos, _, _ = minimizers(s, 15, 5)
        np.testing.assert_array_equal(np.nonzero(selected[i])[0], pos, err_msg=f"read {i}")
    assert selected[0].sum() == 0 and selected[1].sum() == 0  # shorter than k
    assert selected[2].sum() == 1 and selected[3].sum() == 1  # 1-2 positions


@pytest.mark.parametrize("L", (15, 17, 19))
def test_sketch_lk_at_most_w(L):
    """A batch whose padded width gives Lk <= w takes the global minimum."""
    rng = np.random.default_rng(L)
    seqs = [random_genome(rng, n) for n in (L, L - 1, 14)]
    codes, lens = pad_batch(seqs, L=L)
    assert_same(codes, lens)


def test_sketch_tied_hashes_take_the_leftmost():
    """A homopolymer gives one k-mer at every position: each window's
    hashes tie, so only the leftmost minimum of each window is selected."""
    seqs = [b"A" * 64, b"ACGT" * 30, b"AC" * 40 + b"N" + b"T" * 40]
    codes, lens = pad_batch(seqs, L=160)
    selected, h, _ = assert_same(codes, lens)
    assert len(set(h[0][: 64 - 14].tolist())) == 1
    # 50 positions, windows of 5 starting at 0..45, each taking its first
    np.testing.assert_array_equal(np.nonzero(selected[0])[0], np.arange(0, 46))
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(np.nonzero(selected[i])[0], minimizers(s, 15, 5)[0])
