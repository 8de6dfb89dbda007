"""Random alignment problems for the edit-distance kernels' checks.

Host numpy only, from a seed: query/target byte pairs whose targets are the
queries mutated at 0-30 % (substitutions, insertions, deletions, ``N``s
among the bases), plus empty queries and targets of unrelated length, and
the banded wavefront's edge cases beside them (``band_edge_pairs``,
``scramble_past_lengths``).
``myers_bigint`` (the port's copy of the JAX package's host oracle, Python
big ints) is re-exported here; it counts ``N`` against ``N`` as a match,
unlike the kernels' PEq.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.ops.myers import myers_bigint

__all__ = ["band_edge_pairs", "mutate", "myers_bigint", "random_pairs", "random_seq",
           "scramble_past_lengths"]

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


def band_edge_pairs(rng: np.random.Generator, P: int, M: int, band: int
                    ) -> list[tuple[bytes, bytes]]:
    """``P`` >= 7 pairs of at most ``M`` query bases for the banded
    wavefront: ``random_pairs``, then |n - m| at band - 1 and band (both
    signs), a target shorter than the band, a query half of ``N``s, and
    ``N``s against ``N``s."""
    edges = []
    for d in (band - 1, band, -(band - 1), -band):
        m = int(rng.integers(min(band, M), M + 1))
        edges.append((random_seq(rng, m), random_seq(rng, max(m + d, 0))))
    edges += [(random_seq(rng, int(rng.integers(1, M + 1))),
               random_seq(rng, int(rng.integers(1, band)))),
              (random_seq(rng, M, n_rate=0.5), random_seq(rng, M)), (b"NNNA", b"NNNNA")]
    return random_pairs(rng, P - len(edges), M) + edges


def scramble_past_lengths(rng: np.random.Generator, t_codes: np.ndarray,
                          t_lens: np.ndarray) -> np.ndarray:
    """A copy of the (P, N) codes with every byte past a row's length set to
    a random base code 0-3 in place of the padding: bytes a kernel may read
    but must not let reach its result."""
    past = np.arange(t_codes.shape[1])[None, :] >= np.asarray(t_lens)[:, None]
    return np.where(past, rng.integers(0, 4, t_codes.shape, dtype=np.uint8), t_codes)
