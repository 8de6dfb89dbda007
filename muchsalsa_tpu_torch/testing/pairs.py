"""Random alignment problems for the edit-distance kernels' checks.

Host numpy only, from a seed: query/target byte pairs whose targets are the
queries mutated at 0-30 % (substitutions, insertions, deletions, ``N``s
among the bases), plus empty queries and targets of unrelated length.
``myers_bigint`` (the port's copy of the JAX package's host oracle, Python
big ints) is re-exported here; it counts ``N`` against ``N`` as a match,
unlike the kernels' PEq.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.ops.myers import myers_bigint

__all__ = ["mutate", "myers_bigint", "random_pairs", "random_seq"]

_ALPHABET = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_seq(rng: np.random.Generator, length: int, n_rate: float = 0.02) -> bytes:
    codes = rng.integers(0, 4, length)
    codes[rng.random(length) < n_rate] = 4
    return _ALPHABET[codes].tobytes()


def mutate(rng: np.random.Generator, seq: bytes, rate: float) -> bytes:
    """Equal parts deletion, substitution and insertion at ``rate`` per base;
    substituted and inserted bases include ``N``."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    n = len(arr)
    r = rng.random(n)
    deleted = r < rate / 3
    subbed = (r >= rate / 3) & (r < 2 * rate / 3)
    inserted = (r >= 2 * rate / 3) & (r < rate)
    sub = _ALPHABET[rng.integers(0, 5, n)]
    ins = _ALPHABET[rng.integers(0, 5, n)]
    counts = np.where(deleted, 0, np.where(inserted, 2, 1))
    offsets = np.cumsum(counts) - counts
    out = np.empty(int(counts.sum()), dtype=np.uint8)
    kept = ~deleted
    out[offsets[kept]] = np.where(subbed, sub, arr)[kept]
    out[offsets[inserted] + 1] = ins[inserted]
    return out.tobytes()


def random_pairs(
    rng: np.random.Generator, P: int, M: int, max_rate: float = 0.3,
    empty_share: float = 0.05, far_share: float = 0.1,
) -> list[tuple[bytes, bytes]]:
    """``P`` pairs whose longest query has exactly ``M`` bases (the first).
    Most targets are their query mutated at a rate drawn from
    [0, max_rate]; an ``empty_share`` of the queries are empty and a
    ``far_share`` of the targets are unrelated sequences of 0..2M bases."""
    pairs = []
    for i in range(P):
        m = M if i == 0 else int(rng.integers(0, M + 1))
        kind = rng.random()
        if i > 0 and kind < empty_share:
            m = 0
        q = random_seq(rng, m)
        if i > 0 and kind >= 1 - far_share:
            t = random_seq(rng, int(rng.integers(0, 2 * M + 1)))
        else:
            t = mutate(rng, q, float(rng.uniform(0, max_rate)))
        pairs.append((q, t))
    return pairs
