"""Batched minimizer sketch on a torch device.

Port of ``muchsalsa_tpu/ops/minimizer_jax.py::fmix32_jnp`` (:21),
``minimizer_sketch`` (:32-88), ``build_hash_bitmap`` (:96-109),
``anchor_counts_bitmap`` (:112) and ``anchor_counts`` (:133): canonical
k-mer packing, fmix32 hashing and leftmost-minimum window selection over a
padded ``(R, L)`` read batch, the seeding stage of device mapping; the
occupancy bitmap of the v1 join; and per-read anchor counts against an
index, the lookup that ``parallel/sharded.py::sharded_anchor_counts`` runs.

The JAX function carries hashes as uint32.  Here they are int64 holding
values in ``[0, 2**32)``: every shift and sum is masked to 32 bits, and
fmix32's multiplies are split into 16-bit halves of the constant, so no
product reaches 2**48 and nothing relies on signed wrap-around.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
BITMAP_LOG2_BITS = 28  # a 32 MB bitmap; false-positive rate = |index| / 2^28


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` and a 32-bit
    constant ``c``, with every product below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in ``[0, 2**32)``."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _one_hot_argmin(h: torch.Tensor) -> torch.Tensor:
    """(R, Lk) bool: the first minimal position of each row (a comparison,
    not a scatter of a host scalar, so that a CUDA graph can capture it)."""
    amin = torch.argmin(h, dim=1)
    return torch.arange(h.shape[1], device=h.device)[None, :] == amin[:, None]


def minimizer_sketch(codes: torch.Tensor, lens: torch.Tensor, k: int = 15, w: int = 5):
    """Minimizer sketch of a padded read batch.

    ``codes``: (R, L) integer codes, pad = 4 (non-ACGT); ``lens``: (R,).
    Returns (selected, hashes, strands), each (R, L - k + 1): ``selected``
    marks k-mer start positions chosen as minimizers, ``hashes`` (int64,
    32-bit values; 0xFFFFFFFF at invalid positions) and ``strands`` are the
    per-position canonical values.
    """
    R, L = codes.shape
    Lk = L - k + 1
    dev = codes.device
    c = codes.to(torch.int64)
    lens = lens.to(dev, torch.int64)

    fwd = torch.zeros((R, Lk), dtype=torch.int64, device=dev)
    rc = torch.zeros((R, Lk), dtype=torch.int64, device=dev)
    bad = torch.zeros((R, Lk), dtype=torch.int64, device=dev)
    for j in range(k):
        col = c[:, j:j + Lk]
        fwd = ((fwd << 2) | (col & 3)) & MASK32
        rc = (rc | (((3 - col) & 3) << (2 * j))) & MASK32
        bad = bad + (col >= 4)

    pos = torch.arange(Lk, device=dev)[None, :]
    valid = (bad == 0) & (pos + k <= lens[:, None])

    canonical = torch.minimum(fwd, rc)
    strand = fwd <= rc
    h = torch.where(valid, fmix32(canonical), torch.full_like(canonical, MASK32))

    lk_real = lens - (k - 1)  # per-read number of k-mer positions

    if Lk <= w:
        selected = _one_hot_argmin(h)
    else:
        Wn = Lk - w + 1
        amin = torch.argmin(h.unfold(1, w, 1), dim=-1)  # leftmost min per window
        # only windows fully inside the real read exist on the host path
        win_ok = torch.arange(Wn, device=dev)[None, :] <= (lk_real[:, None] - w)
        selected = torch.zeros((R, Lk), dtype=torch.bool, device=dev)
        for j in range(w):
            selected[:, j:j + Wn] |= (amin == j) & win_ok
        # short reads (1 <= positions <= w): single leftmost global min
        small = (lk_real >= 1) & (lk_real <= w)
        selected |= _one_hot_argmin(h) & small[:, None]

    return selected & valid, h, strand


def build_hash_bitmap(index_hashes, log2_bits: int = BITMAP_LOG2_BITS, *, device):
    """Occupancy bitmap over the index's hashes folded to ``log2_bits``
    bits, for one-gather membership probes: bit ``f & 31`` of word ``f >>
    5`` is set for every folded hash ``f``.  Built on the host (scatter-OR)
    and placed on ``device`` as ``2**(log2_bits - 5)`` int32 words holding
    the JAX package's uint32 bits; an arithmetic shift followed by ``& 1``
    reads any bit."""
    h = np.asarray(index_hashes, dtype=np.uint32)
    folded = h & np.uint32((1 << log2_bits) - 1)
    word = (folded >> np.uint32(5)).astype(np.int64)
    bit = (folded & np.uint32(31)).astype(np.uint32)
    table = np.zeros(1 << (log2_bits - 5), dtype=np.uint32)
    np.bitwise_or.at(table, word, np.uint32(1) << bit)
    return torch.from_numpy(table.view(np.int32)).to(device)


def anchor_counts_bitmap(codes, lens, bitmap, k: int = 15, w: int = 5,
                         log2_bits: int = BITMAP_LOG2_BITS) -> torch.Tensor:
    """(R,) int32 counts of each read's minimizers whose folded hash is set
    in ``bitmap`` (``build_hash_bitmap``): an upper bound of
    ``anchor_counts`` (false positives: |index| / 2^log2_bits)."""
    selected, h, _ = minimizer_sketch(codes, lens, k, w)
    folded = h & ((1 << log2_bits) - 1)
    probe = (bitmap[folded >> 5].to(torch.int64) >> (folded & 31)) & 1
    return ((probe != 0) & selected).sum(dim=1).to(torch.int32)


def anchor_counts(codes, lens, index_hashes, k: int = 15, w: int = 5) -> torch.Tensor:
    """(R,) int32 counts of each read's minimizers found in the sorted
    ``index_hashes`` (int64, 32-bit values) by ``searchsorted``."""
    selected, h, _ = minimizer_sketch(codes, lens, k, w)
    if not index_hashes.numel():
        return torch.zeros(h.shape[0], dtype=torch.int32, device=h.device)
    pos = torch.clamp(torch.searchsorted(index_hashes, h), max=index_hashes.numel() - 1)
    return ((index_hashes[pos] == h) & selected).sum(dim=1).to(torch.int32)
