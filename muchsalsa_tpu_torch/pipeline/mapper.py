"""Minimizer-index mapper: the native replacement for the pipeline's
minimap2 anchoring stages.

Reference counterpart: the three ``minimap2 -k15 -DP --dual=yes
--no-long-join -w5 -m100 -g10000 -r2000`` invocations in
``pipeline/pipeline.sh:163,169,175`` that map unitigs (query, PAF col 0)
onto nanopore reads (target, cols 5-8).  Output is a PAF with exactly
the columns the core parser consumes (``BlastFileReader.cpp:52-60``).

Method:
1. index: minimizers of every unitig -> sorted (hash, unitig, pos,
   strand) table with CSR buckets; hashes occurring more than
   ``max_occ`` times are dropped (repeat masking, minimap2's -f
   analog);
2. per read: minimizer lookup -> anchors (unitig, strand, qpos, tpos);
3. chaining: per (unitig, relative strand), anchors are grouped by
   diagonal (tpos - qpos, or tpos + qpos for reverse hits) within
   ``bandwidth``; each group is one candidate chain;
4. scoring: ``matches`` = bases of the read covered by the union of
   anchor k-mer intervals (merged, so overlapping seeds don't double
   count);
5. chains with ``matches >= min_chain_score`` and ``min_anchor_count``
   anchors emit PAF rows.

The port's copy of the host half of ``muchsalsa_tpu/pipeline/mapper.py``:
``MinimizerIndex`` (:41), ``Mapping`` (:140), ``map_read`` (:160),
``map_batch`` (:278), the fork pool's ``_pool_map_one`` (:338), the device
length buckets and their budgets (:400-452) and ``write_paf`` (:850).
``map_all``, ``map_all_with_device`` and ``refine_mappings`` are the port's
own, in ``pipeline/mapper_torch.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.ops.minimizer import minimizers
from muchsalsa_tpu_torch.utils.seq import encode_2bit


@dataclass
class MinimizerIndex:
    hashes: np.ndarray      # sorted uint32
    offsets: np.ndarray     # CSR into entries, len = len(uniq)+1
    entry_unitig: np.ndarray  # int32
    entry_pos: np.ndarray     # int32
    entry_strand: np.ndarray  # bool
    unitig_ids: list[int]
    unitig_lengths: dict[int, int]
    k: int
    w: int

    @staticmethod
    def build(
        store: SequenceStore,
        cfg: MapperConfig,
        sketches: dict | None = None,
    ) -> "MinimizerIndex":
        """``sketches`` (optional): precomputed ``{id: (pos, h, strand)}``
        minimizer sketches to reuse (the scrubber's all-vs-all computes
        each read's sketch once for both index and lookup)."""
        all_h, all_u, all_p, all_s = [], [], [], []
        lengths = {}

        if sketches is None and cfg.k <= 15:
            from muchsalsa_tpu_torch import native

            if native.available():
                ids, seqs = [], []
                for uid, seq in store.items():
                    lengths[uid] = len(seq)
                    ids.append(uid)
                    seqs.append(seq)
                built = native.build_index_native(
                    seqs, np.asarray(ids, dtype=np.int32),
                    cfg.k, cfg.w, cfg.max_occ,
                )
                if built is not None:
                    uniq, offsets, u, p, s = built
                    return MinimizerIndex(
                        hashes=uniq,
                        offsets=offsets,
                        entry_unitig=u,
                        entry_pos=p,
                        entry_strand=s,
                        unitig_ids=store.ids(),
                        unitig_lengths=lengths,
                        k=cfg.k,
                        w=cfg.w,
                    )

        for uid, seq in store.items():
            lengths[uid] = len(seq)
            if sketches is not None and uid in sketches:
                pos, h, strand = sketches[uid]
            else:
                pos, h, strand = minimizers(seq, cfg.k, cfg.w)
            all_h.append(h)
            all_p.append(pos.astype(np.int32))
            all_s.append(strand)
            all_u.append(np.full(len(pos), uid, dtype=np.int32))

        if all_h:
            h = np.concatenate(all_h)
            u = np.concatenate(all_u)
            p = np.concatenate(all_p)
            s = np.concatenate(all_s)
        else:
            h = np.zeros(0, dtype=np.uint32)
            u = p = np.zeros(0, dtype=np.int32)
            s = np.zeros(0, dtype=bool)

        order = np.argsort(h, kind="stable")
        h, u, p, s = h[order], u[order], p[order], s[order]
        uniq, starts = np.unique(h, return_index=True)
        offsets = np.concatenate([starts, [len(h)]]).astype(np.int64)

        # repeat-mask: drop buckets with more than max_occ entries
        counts = np.diff(offsets)
        keep = counts <= cfg.max_occ
        if not np.all(keep):
            keep_rows = np.repeat(keep, counts)
            h, u, p, s = h[keep_rows], u[keep_rows], p[keep_rows], s[keep_rows]
            uniq, starts = np.unique(h, return_index=True)
            offsets = np.concatenate([starts, [len(h)]]).astype(np.int64)

        return MinimizerIndex(
            hashes=uniq,
            offsets=offsets,
            entry_unitig=u,
            entry_pos=p,
            entry_strand=s,
            unitig_ids=store.ids(),
            unitig_lengths=lengths,
            k=cfg.k,
            w=cfg.w,
        )


@dataclass
class Mapping:
    unitig: int
    strand: bool       # True = '+'
    q_start: int       # unitig coords, end exclusive
    q_end: int
    t_start: int       # read coords
    t_end: int
    matches: int
    n_anchors: int


def _covered(starts: np.ndarray, k: int) -> int:
    """Total bases covered by the union of [s, s+k) intervals."""
    if len(starts) == 0:
        return 0
    s = np.sort(starts)
    gaps = np.diff(s)
    return int(k + np.sum(np.minimum(gaps, k)))


def map_read(
    index: MinimizerIndex,
    read_seq: bytes,
    cfg: MapperConfig,
    sketch: tuple | None = None,
    use_native: bool = True,
) -> list[Mapping]:
    if use_native and sketch is None and index.k <= 15:
        from muchsalsa_tpu_torch import native

        if native.available():
            out = native.map_read_native(
                encode_2bit(read_seq), index.k, index.w,
                index.hashes, index.offsets, index.entry_unitig,
                index.entry_pos, index.entry_strand,
                cfg.bandwidth, cfg.min_anchor_count, cfg.min_chain_score,
            )
            if out is not None:
                return [
                    Mapping(
                        unitig=int(out["unitig"][i]),
                        strand=bool(out["strand"][i]),
                        q_start=int(out["qs"][i]),
                        q_end=int(out["qe"][i]),
                        t_start=int(out["ts"][i]),
                        t_end=int(out["te"][i]),
                        matches=int(out["matches"][i]),
                        n_anchors=int(out["n_anchors"][i]),
                    )
                    for i in range(len(out["unitig"]))
                ]

    if sketch is not None:
        pos, h, strand = sketch
    else:
        codes = encode_2bit(read_seq)
        pos, h, strand = minimizers(codes, index.k, index.w)
    if len(pos) == 0:
        return []

    # bucket lookup (vectorised CSR expansion — no per-hit Python)
    loc = np.searchsorted(index.hashes, h)
    loc = np.minimum(loc, max(len(index.hashes) - 1, 0))
    hit = len(index.hashes) > 0
    found = index.hashes[loc] == h if hit else np.zeros(len(h), dtype=bool)

    hit_idx = np.nonzero(found)[0]
    if len(hit_idx) == 0:
        return []
    lo = index.offsets[loc[hit_idx]]
    counts = index.offsets[loc[hit_idx] + 1] - lo
    total = int(counts.sum())
    if total == 0:
        return []
    base = np.repeat(lo, counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    src = base + within

    au = index.entry_unitig[src]
    aq = index.entry_pos[src].astype(np.int64)
    at = np.repeat(pos[hit_idx], counts)
    arel = index.entry_strand[src] == np.repeat(strand[hit_idx], counts)

    k = index.k

    # fully vectorised chaining: one global sort by ((unitig, strand),
    # diagonal), band segmentation by diagonal gaps, and per-segment
    # stats via ufunc.reduceat — no per-group Python
    key = au.astype(np.int64) * 2 + arel
    diag = np.where(arel, at - aq, at + aq)
    order = np.lexsort((diag, key))
    key_s = key[order]
    diag_s = diag[order]
    q_s = aq[order]
    t_s = at[order]

    n_a = len(order)
    new_seg = np.ones(n_a, dtype=bool)
    new_seg[1:] = (key_s[1:] != key_s[:-1]) | (np.diff(diag_s) > cfg.bandwidth)
    starts = np.nonzero(new_seg)[0]
    seg_counts = np.diff(np.concatenate([starts, [n_a]]))

    q_min = np.minimum.reduceat(q_s, starts)
    q_max = np.maximum.reduceat(q_s, starts)
    t_min = np.minimum.reduceat(t_s, starts)
    t_max = np.maximum.reduceat(t_s, starts)

    # covered read bases per segment: sort anchors by (segment, t),
    # clip consecutive gaps at k, zero gaps crossing segment bounds
    seg_ids = np.cumsum(new_seg) - 1
    order2 = np.lexsort((t_s, seg_ids))
    t2 = t_s[order2]
    gaps = np.minimum(np.diff(t2), k) if n_a > 1 else np.zeros(0, dtype=np.int64)
    gaps = np.concatenate([[0], gaps])
    gaps[starts] = 0  # first element of each segment contributes k below
    covered = k + np.add.reduceat(gaps, starts) - gaps[starts]

    ok = (seg_counts >= cfg.min_anchor_count) & (covered >= cfg.min_chain_score)

    results: list[Mapping] = []
    for i in np.nonzero(ok)[0]:
        s0 = starts[i]
        results.append(
            Mapping(
                unitig=int(key_s[s0] // 2),
                strand=bool(key_s[s0] % 2),
                q_start=int(q_min[i]),
                q_end=int(q_max[i]) + k,
                t_start=int(t_min[i]),
                t_end=int(t_max[i]) + k,
                matches=int(covered[i]),
                n_anchors=int(seg_counts[i]),
            )
        )

    return results


def map_batch(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    threads: int = 0,
) -> list[tuple[int, list[Mapping]]] | None:
    """Map every read in one multithreaded native call (the host analog
    of the reference's job-per-read ThreadPool fan-out).  Results are
    identical to per-read :func:`map_read`; returns None when the native
    library is unavailable (callers fall back to the python path)."""
    if index.k > 15:
        return None
    from muchsalsa_tpu_torch import native

    if not native.available():
        return None

    rids, seqs = [], []
    for rid, seq in reads.items():
        rids.append(rid)
        seqs.append(seq)
    out = native.map_batch_native(
        seqs, index.k, index.w,
        index.hashes, index.offsets, index.entry_unitig,
        index.entry_pos, index.entry_strand,
        cfg.bandwidth, cfg.min_anchor_count, cfg.min_chain_score,
        threads=threads,
    )
    if out is None:
        return None

    per_read: list[tuple[int, list[Mapping]]] = [(rid, []) for rid in rids]
    read_col = out["read"]
    for i in range(len(read_col)):
        per_read[int(read_col[i])][1].append(
            Mapping(
                unitig=int(out["unitig"][i]),
                strand=bool(out["strand"][i]),
                q_start=int(out["qs"][i]),
                q_end=int(out["qe"][i]),
                t_start=int(out["ts"][i]),
                t_end=int(out["te"][i]),
                matches=int(out["matches"][i]),
                n_anchors=int(out["n_anchors"][i]),
            )
        )
    return per_read


_POOL_STATE: dict = {}


def _pool_map_one(args):
    rid, seq = args
    return rid, map_read(_POOL_STATE["index"], seq, _POOL_STATE["cfg"])


def device_bucket_len(n: int) -> int:
    """Quarter-step read-length buckets (pow2 x {1.25, 1.5, 1.75, 2}):
    a 9 kb read lands in a 10240 bucket instead of 16384, and every
    device stage width downstream scales with L (reads fill >= 80% of
    their bucket).  All steps are multiples of 256 (packing + lane
    alignment).  Module-level so probes/benches share production's
    shapes (scripts/map_exec_probe.py)."""
    L = 1024
    while L < n:
        L *= 2
    if L > 1024:
        for frac in (5, 6, 7):
            cand = (L // 8) * frac
            if cand >= n:
                return cand
    return L


def device_bucket_budgets(
    L: int, k: int, max_pos_cap: int, max_per_hit: int,
) -> tuple[int, int, int | None]:
    """Static device budgets for one read-length bucket: returns
    (max_sel, max_pos, trim).

    Widths are the whole cost model of the device mapping path — the
    rank-probe gather and the packed-row fetches execute at a fixed
    ~4-6 ns/element regardless of table size, and the sorts scale with
    operand width (BASELINE.md round 5 microbenchmarks) — so every
    budget scales with the bucket:

    - ``max_sel``: minimizer density is 2/(w+1) = ~L/3 at w=5, and
      quarter-step buckets keep reads >= 80% of L, so L/3 plus slack
      covers every read in the bucket (degenerate inputs overflow to
      the exact host path);
    - ``max_pos``: candidates are a subset of selected; capped at
      ``max_pos_cap`` (2048 default keeps the tail's first sort at a
      pow2 8192 slots — 0.89 ms vs 3.73 at 16384);
    - ``trim``: = max_pos (real anchors run ~1.2 per candidate, so a
      1x-candidates anchor budget holds a ~1.6x margin on measured
      workloads; denser repeat anchors overflow to the host).
    """
    Lk = max(L - k + 1, 128)
    sel = min(-(-(L // 3 + 128) // 128) * 128, -(-Lk // 128) * 128)
    pos = min(max_pos_cap, sel)
    if max_per_hit <= 2:
        trim = None
    elif max_per_hit <= 4:
        trim = pos
    else:
        # wider expansion tiers (repeat-heavy reads) carry more anchors
        trim = 2 * pos
    return sel, pos, trim


def write_paf(lines: list[str], path: str | Path) -> None:
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))
