"""Scaffold all-pairs intersection -> overlap-graph edges (vectorised).

Reference counterpart: ``MatchMap::calculateEdges`` / ``processScaffold``
(``libms/src/matching/MatchMap.cpp:161-224``): per unitig ("scaffold"),
sort member reads by PAF line number, then for every ordered pair
(inner before outer) intersect the two illumina ranges; if the overlap
length exceeds ``th_overlap`` (strictly: ``end - start > th_overlap``,
``MatchMap.cpp:192``), add an edge between the two reads (vertex order =
ascending vertex meta line, ``MatchMap.cpp:204-213``) and record an
``EdgeMatch`` with

    score     = s_out * common/len_out + s_in * common/len_in
    direction = (dir_out == dir_in)
    primary   = primary_out and primary_in
    line      = outer match's line number.

Here the whole thing is one batched computation: scaffolds are groups of
the line-sorted match table, pair indices are generated arithmetically,
and every EdgeMatch field is computed with array ops — no mutexes, no
jobs (replaces the reference's Job-per-scaffold fan-out,
``MatchMap.cpp:165-172``).
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore


def _pair_indices(group_sizes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All (i < j) index pairs within each group, flattened globally.

    Returns (inner, outer) absolute indices where groups are laid out
    consecutively with the given sizes.  outer iterates in ascending
    order and inner < outer, matching the reference's loop nesting.
    """
    counts = group_sizes * (group_sizes - 1) // 2
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z

    group_of_pair = np.repeat(np.arange(len(group_sizes)), counts)
    pair_starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    local = np.arange(total) - pair_starts[group_of_pair]

    # local pair ordering: outer = 1..k-1, inner = 0..outer-1
    # pair index p -> outer o such that o(o-1)/2 <= p < o(o+1)/2
    outer_local = ((np.sqrt(8.0 * local + 1.0) + 1.0) / 2.0).astype(np.int64)
    # guard fp rounding
    outer_local = np.where(outer_local * (outer_local - 1) // 2 > local, outer_local - 1, outer_local)
    outer_local = np.where(outer_local * (outer_local + 1) // 2 <= local, outer_local + 1, outer_local)
    inner_local = local - outer_local * (outer_local - 1) // 2

    group_starts = np.concatenate(([0], np.cumsum(group_sizes)))[:-1]
    base = group_starts[group_of_pair]
    return base + inner_local, base + outer_local


def _empty_edges() -> EdgeMatches:
    z32 = np.zeros(0, dtype=np.int32)
    z64 = np.zeros(0, dtype=np.int64)
    zb = np.zeros(0, dtype=bool)
    return EdgeMatches(z32, z32, z32, z32, z32, z32, zb, np.zeros(0), zb, z64)


def _scaffold_groups(store: MatchStore):
    """Stable (illu, line)-sorted row order + group sizes per scaffold."""
    order = np.lexsort((store.line, store.illu_id))
    _ids, group_sizes = np.unique(store.illu_id[order], return_counts=True)
    return order, group_sizes


def build_edges(store: MatchStore, th_overlap: int = 100) -> EdgeMatches:
    n = len(store)
    if n == 0:
        return _empty_edges()

    # scaffold grouping: stable sort match rows by (illu, line)
    order, group_sizes = _scaffold_groups(store)

    inner, outer = _pair_indices(group_sizes)
    ri = order[inner]   # inner match rows (earlier line)
    ro = order[outer]   # outer match rows (later line)

    ov_start = np.maximum(store.illu_start[ro], store.illu_start[ri])
    ov_end = np.minimum(store.illu_end[ro], store.illu_end[ri])
    keep = (ov_start <= ov_end) & ((ov_end - ov_start) > th_overlap)
    ri, ro, ov_start, ov_end = ri[keep], ro[keep], ov_start[keep], ov_end[keep]
    return _finish_edges(store, ri, ro, ov_start, ov_end)


def _finish_edges(store: MatchStore, ri, ro, ov_start, ov_end) -> EdgeMatches:
    """Shared tail: EdgeMatch fields + canonical edge table from the
    surviving (inner, outer) pair rows (MatchMap.cpp:196-218)."""
    common = (ov_end - ov_start + 1).astype(np.float64)
    len_o = (store.illu_end[ro] - store.illu_start[ro] + 1).astype(np.float64)
    len_i = (store.illu_end[ri] - store.illu_start[ri] + 1).astype(np.float64)
    sum_score = (
        store.score[ro].astype(np.float64) * common / len_o
        + store.score[ri].astype(np.float64) * common / len_i
    )
    direction = store.direction[ro] == store.direction[ri]
    primary = store.is_primary[ro] & store.is_primary[ri]
    em_line = store.line[ro]
    em_illu = store.illu_id[ro]

    # vertex ordering by meta line (ascending)
    vi = store.vertex_index(store.nano_id[ri])
    vo = store.vertex_index(store.nano_id[ro])
    line_i = store.vertex_meta_line[vi]
    line_o = store.vertex_meta_line[vo]
    swap = line_o < line_i
    v_first = np.where(swap, store.nano_id[ro], store.nano_id[ri])
    v_second = np.where(swap, store.nano_id[ri], store.nano_id[ro])
    lv_first = np.where(swap, line_o, line_i)
    lv_second = np.where(swap, line_i, line_o)

    # canonical edge order: by (meta line of first, meta line of second);
    # meta lines are unique per vertex, so this is a total order.
    pair_key = lv_first.astype(np.int64) * (int(store.vertex_meta_line.max()) + 1) + lv_second
    uniq_keys, edge_idx = np.unique(pair_key, return_inverse=True)
    # representative row for each unique edge to recover (v, w)
    first_seen = np.zeros(len(uniq_keys), dtype=np.int64)
    first_seen[edge_idx[::-1]] = np.arange(len(pair_key))[::-1]
    edge_v = v_first[first_seen].astype(np.int32)
    edge_w = v_second[first_seen].astype(np.int32)

    # group edge-match rows by (edge, illu); (edge, illu) pairs are unique
    # by construction (one pair of reads meets once per scaffold), matching
    # the no-op dedup in addEdgeMatch (MatchMap.cpp:120-133).
    em_order = np.lexsort((em_illu, edge_idx))

    return EdgeMatches(
        edge_v=edge_v,
        edge_w=edge_w,
        em_edge=edge_idx[em_order].astype(np.int32),
        em_illu=em_illu[em_order].astype(np.int32),
        em_ov_start=ov_start[em_order].astype(np.int32),
        em_ov_end=ov_end[em_order].astype(np.int32),
        em_direction=direction[em_order],
        em_score=sum_score[em_order],
        em_primary=primary[em_order],
        em_line=em_line[em_order].astype(np.int64),
    )
