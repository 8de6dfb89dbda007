"""Random alignment problems for the edit-distance kernels' checks.

Host numpy only, from a seed: query/target byte pairs whose targets are the
queries mutated at 0-30 % (substitutions, insertions, deletions, ``N``s
among the bases), plus empty queries and targets of unrelated length, and
the banded wavefront's edge cases beside them (``band_edge_pairs``,
``scramble_past_lengths``), and for ``gather_problems`` problems given as
coordinates into sequences (``gather_case``, ``gather_inputs``,
``sliced_pairs``, ``gather_scale_inputs``).
``myers_bigint`` (the port's copy of the JAX package's host oracle, Python
big ints) is re-exported here; it counts ``N`` against ``N`` as a match,
unlike the kernels' PEq.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.ops.align_torch import GatherArgs
from muchsalsa_tpu_torch.ops.myers import myers_bigint
from muchsalsa_tpu_torch.utils.seq import reverse_complement

__all__ = ["GATHER_CASES", "band_edge_pairs", "gather_case", "gather_inputs",
           "gather_scale_inputs", "mutate",
           "myers_bigint", "random_pairs", "random_seq", "scramble_past_lengths", "sliced_pairs"]

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


# a problem: (query, q_start, q_end, target, t_start, t_end, minus strand)
Problem = tuple[int, int, int, int, int, int, bool]

GATHER_CASES = ("lower_case", "iupac", "minus_strand", "past_the_end", "negative_index",
                "empty_range", "single", "none")
_GATHER_ALPHABETS = {"lower_case": b"ACGTacgt", "iupac": b"ACGTNRYKMSWBDHVnrykmswbdhv-*."}


def gather_case(name: str, seed: int, n_seqs: int = 6, max_len: int = 300, P: int = 40
                ) -> tuple[list[bytes], list[bytes], list[Problem]]:
    """(queries, targets, problems) of one of ``GATHER_CASES``: sequences of
    the case's bytes (upper- and lower-case bases, ``N`` and the IUPAC codes
    among them) and problems of random ranges on either strand, or all on
    the minus strand, with ends past the sequence, negative indices, empty
    ranges (an empty sequence among them), one problem or none."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(_GATHER_ALPHABETS.get(name, b"ACGTacgtN"), dtype=np.uint8)

    def seqs():
        lens = rng.integers(1, max_len + 1, n_seqs)
        if name == "empty_range":
            lens[0] = 0
        return [alphabet[rng.integers(0, len(alphabet), n)].tobytes() for n in lens]

    queries, targets = seqs(), seqs()
    P = {"single": 1, "none": 0}.get(name, P)

    def span(n):
        a, b = sorted(int(x) for x in rng.integers(0, n + 1, 2))
        if name == "past_the_end":
            return a + int(rng.integers(0, 3)) * n // 2, b + int(rng.integers(1, 60))
        if name == "negative_index":
            return a - n - int(rng.integers(0, 20)), b - int(rng.integers(0, n + 2))
        if name == "empty_range":
            return (b, a) if rng.random() < 0.5 else (a, a)
        return a, b

    problems = []
    for _ in range(P):
        qi, ti = int(rng.integers(0, n_seqs)), int(rng.integers(0, n_seqs))
        minus = name == "minus_strand" or bool(rng.random() < 0.5)
        problems.append((qi, *span(len(queries[qi])), ti, *span(len(targets[ti])), minus))
    return queries, targets, problems


def sliced_pairs(queries: list[bytes], targets: list[bytes], problems: list[Problem]
                 ) -> list[tuple[bytes, bytes]]:
    """The problems' (query, target) pairs sliced in Python, the target
    reverse-complemented on the minus strand: what ``pack_problems`` packs."""
    pairs = []
    for qi, qs, qe, ti, ts, te, minus in problems:
        t = targets[ti][ts:te]
        pairs.append((queries[qi][qs:qe], reverse_complement(t) if minus else t))
    return pairs


def gather_inputs(queries: list[bytes], targets: list[bytes], problems: list[Problem]):
    """``gather_problems``' arguments for the problems, as numpy arrays,
    and its widths M and N (1 when there are no problems): the problems as
    ``Mapping`` rows, one read entry each, through refinement's own
    ``problem_coordinates``."""
    from muchsalsa_tpu_torch.io.fasta import SequenceStore
    from muchsalsa_tpu_torch.pipeline.mapper import Mapping
    from muchsalsa_tpu_torch.pipeline.mapper_torch import problem_coordinates

    stores = []
    for prefix, seqs in (("q", queries), ("t", targets)):
        store = SequenceStore()
        stores.append(store)
        ids = [store.add(f"{prefix}{i}", seq) for i, seq in enumerate(seqs)]
        assert ids == list(range(len(seqs)))
    per_read = [(ti, [Mapping(qi, not minus, qs, qe, ts, te, 0, 0)])
                for qi, qs, qe, ti, ts, te, minus in problems]
    _slots, args = problem_coordinates(per_read, stores[1], stores[0])
    M = int(args.q_len.max()) if len(problems) else 1
    N = int(args.t_len.max()) if len(problems) else 1
    return args, M, N


def gather_scale_inputs(seed: int, n_reads: int = 25_786, read_len: int = 9_000,
                        n_unitigs: int = 692, P: int = 57_000):
    """``gather_problems``' arguments (``GatherArgs`` of numpy arrays) and
    widths of a synthetic batch the size of a refined E. coli map stage
    (the sequences and ranges are drawn, not mapped): ``n_reads`` reads of
    ``read_len`` ± 200 and ``n_unitigs`` unitigs of 500 plus an exponential
    of mean 6,953 bases (upper case with 1 % ``N`` and 1 % lower case), and
    ``P`` problems, each a unitig range of 500-10,000 bases against a read
    range within 10 % of its length, half on the minus strand."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)

    def store(lens):
        pick = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
        r = rng.random(len(pick))
        pick[r < 0.01] += 4
        pick[r > 0.99] = 8
        return alphabet[pick], np.cumsum(lens) - lens

    u_len = 500 + rng.exponential(6_953, n_unitigs).astype(np.int64)
    r_len = read_len + rng.integers(-200, 201, n_reads)
    q_blob, u_off = store(u_len)
    t_blob, r_off = store(r_len)
    u = rng.integers(0, n_unitigs, P)
    r = rng.integers(0, n_reads, P)
    q_len = np.minimum(rng.integers(500, 10_001, P), u_len[u])
    t_len = np.minimum(np.maximum(q_len * rng.uniform(0.9, 1.1, P), 0).astype(np.int64), r_len[r])
    q_start = (rng.random(P) * (u_len[u] - q_len + 1)).astype(np.int64)
    t_start = (rng.random(P) * (r_len[r] - t_len + 1)).astype(np.int64)
    args = GatherArgs(q_blob, u_off[u], q_start, q_len.astype(np.int32), t_blob, r_off[r],
                      t_start, t_len.astype(np.int32), rng.random(P) < 0.5)
    return args, int(q_len.max()), int(t_len.max())
