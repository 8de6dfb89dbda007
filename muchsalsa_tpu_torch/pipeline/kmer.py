"""K-mer counting, abundance thresholding, and read filtering.

Reference counterparts (``pipeline/pipeline.sh:136-151``):
- ``jellyfish count/histo/dump`` -> :func:`count_kmers` /
  :func:`histogram` (canonical counting via 64-bit packing + sort);
- ``setAbundanceThresholdFromHisto.py`` -> :func:`abundance_threshold`
  (same quartile walk over the non-unique histogram: threshold =
  Q3 + 2*IQR, ``setAbundanceThresholdFromHisto.py:14-36``);
- ``bbduk.sh ... hdist=0`` -> :func:`filter_read_pairs` (drop read
  pairs containing any over-abundant k-mer).

The port's copy of ``muchsalsa_tpu/pipeline/kmer.py``, which holds only
host paths (the device counter, ``ops/kmer_jax.py``, is ROADMAP.md §1
item 10).
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.utils.seq import encode_2bit

_MASK = {}


def kmer_values64(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical uint64 k-mer values, valid mask) for k <= 31."""
    assert k <= 31
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    L = n - k + 1
    fwd = np.zeros(L, dtype=np.uint64)
    rc = np.zeros(L, dtype=np.uint64)
    bad = np.zeros(L, dtype=np.int32)
    c = codes.astype(np.uint64)
    comp = (np.uint64(3) - c) & np.uint64(3)
    invalid = (codes >= 4).astype(np.int32)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | (c[j : j + L] & np.uint64(3))
        rc = rc | (comp[j : j + L] << np.uint64(2 * j))
        bad += invalid[j : j + L]
    return np.minimum(fwd, rc), bad == 0


def count_kmers(seqs, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counting over an iterable of byte sequences.

    Returns (sorted unique uint64 values, counts).  Uses the
    multithreaded native counter when available (jellyfish-count
    equivalent; identical output to the python path).
    """
    if k <= 31:
        from muchsalsa_tpu_torch import native

        if native.available():
            out = native.count_kmers_native(list(seqs), k)
            if out is not None:
                return out

    chunks = []
    for seq in seqs:
        vals, valid = kmer_values64(encode_2bit(seq), k)
        if len(vals):
            chunks.append(vals[valid])
    if not chunks:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    allv = np.concatenate(chunks)
    uniq, counts = np.unique(allv, return_counts=True)
    return uniq, counts.astype(np.int64)


def histogram(counts: np.ndarray) -> dict[int, int]:
    """abundance -> #distinct k-mers (jellyfish histo equivalent)."""
    if len(counts) == 0:
        return {}
    abundances, freqs = np.unique(counts, return_counts=True)
    return {int(a): int(f) for a, f in zip(abundances, freqs)}


def abundance_threshold(histo: dict[int, int]) -> int:
    """Quartile walk of setAbundanceThresholdFromHisto.py:14-36."""
    total_non_unique = sum(f for a, f in histo.items() if a != 1)
    q1_th = round((total_non_unique + 1) * 0.25)
    q3_th = round((total_non_unique + 1) * 0.75)
    q1 = q3 = 0
    current = 0
    for abundance in sorted(histo):
        if abundance <= 1:
            continue
        current += histo[abundance]
        if q1 == 0 and current >= q1_th:
            q1 = abundance
        elif q3 == 0 and current >= q3_th:
            q3 = abundance
            break
    iqr = q3 - q1
    return q3 + 2 * iqr


def high_abundance_kmers(
    uniq: np.ndarray, counts: np.ndarray, threshold: int
) -> np.ndarray:
    """jellyfish dump -L threshold: k-mers with count >= threshold."""
    return uniq[counts >= threshold]


def filter_read_pairs(
    pairs: list[tuple[bytes, bytes]], bad_kmers: np.ndarray, k: int
) -> list[tuple[bytes, bytes]]:
    """bbduk-equivalent: drop pairs where either mate contains a bad k-mer."""
    bad_sorted = np.sort(bad_kmers)

    if k <= 31:
        from muchsalsa_tpu_torch import native

        if native.available():
            keep = native.filter_pairs_native(pairs, bad_sorted, k)
            if keep is not None:
                return [p for p, ok in zip(pairs, keep) if ok]

    def is_clean(seq: bytes) -> bool:
        vals, valid = kmer_values64(encode_2bit(seq), k)
        vals = vals[valid]
        if len(vals) == 0 or len(bad_sorted) == 0:
            return True
        pos = np.searchsorted(bad_sorted, vals)
        pos = np.minimum(pos, len(bad_sorted) - 1)
        return not bool(np.any(bad_sorted[pos] == vals))

    return [(a, b) for a, b in pairs if is_clean(a) and is_clean(b)]
