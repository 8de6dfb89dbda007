"""Minimizer extraction — the seeding primitive of the on-TPU mapper.

The reference delegates all base-level anchoring to external ``minimap2``
calls (``pipeline/pipeline.sh:163,169,175`` with ``-k15 -w5``); this
module provides the native equivalent: canonical k-mer minimizers
computed with vectorised integer ops, available both as a numpy host
path and a jnp device path (identical results — 32-bit arithmetic only,
since k=15 packs into 30 bits).

Scheme:
- bases encoded A,C,G,T -> 0..3 (others -> 4, k-mers containing them
  are skipped);
- k-mer packed big-endian into uint32; reverse complement packed the
  same way; canonical value = min(fwd, rc), strand = (fwd <= rc);
- hash = murmur3 fmix32 finalizer of the canonical value (invertible,
  avoids poly-A windows all hashing low);
- window minimum over w consecutive k-mer hashes; the *leftmost*
  minimal position in each window is the minimizer (deterministic
  tie-break; minimap2 keeps all ties — a deliberate simplification,
  noted for parity: anchors are a superset filter upstream of chaining).
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.utils.seq import encode_2bit

MASK32 = np.uint32(0xFFFFFFFF)


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer (vectorised, numpy uint32)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)) & MASK32
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)) & MASK32
    x ^= x >> np.uint32(16)
    return x


def kmer_values(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed forward/rc values for every k-mer start position.

    Returns (fwd, rc, valid) of length ``len(codes) - k + 1``; ``valid``
    is False where the window contains a non-ACGT base.
    """
    n = len(codes)
    if n < k:
        z = np.zeros(0, dtype=np.uint32)
        return z, z, np.zeros(0, dtype=bool)

    L = n - k + 1
    fwd = np.zeros(L, dtype=np.uint32)
    rc = np.zeros(L, dtype=np.uint32)
    bad = np.zeros(L, dtype=np.int32)

    c = codes.astype(np.uint32)
    comp = np.uint32(3) - c  # complement for ACGT; invalid handled via mask
    invalid = (codes >= 4).astype(np.int32)

    for j in range(k):
        col = c[j : j + L]
        fwd = ((fwd << np.uint32(2)) | (col & np.uint32(3))) & MASK32
        # rc: base at offset j lands at rc position k-1-j, complemented
        rc = rc | (((comp[j : j + L] & np.uint32(3)) << np.uint32(2 * j)))
        bad += invalid[j : j + L]

    return fwd, rc, bad == 0


def minimizers(
    seq: bytes | np.ndarray, k: int = 15, w: int = 5
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimizer sketch of one sequence.

    Returns (positions, hashes, strands): unique window minima with
    ``positions`` the k-mer start, ``strands`` True where the canonical
    k-mer is the forward orientation.
    """
    codes = encode_2bit(seq) if not isinstance(seq, np.ndarray) else seq
    fwd, rc, valid = kmer_values(codes, k)
    L = len(fwd)
    if L == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=bool)

    canonical = np.minimum(fwd, rc)
    strand = fwd <= rc
    h = fmix32(canonical)
    h = np.where(valid, h, MASK32)  # invalid k-mers never win a window

    if L <= w:
        pos = np.array([int(np.argmin(h))], dtype=np.int64)
    else:
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        local = np.argmin(win, axis=1)  # leftmost minimum per window
        pos = np.unique(local + np.arange(len(local)))

    pos = pos[valid[pos]]
    return pos, h[pos], strand[pos]
