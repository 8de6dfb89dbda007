"""Batched, bucketized anchor-chaining DP on a torch device.

Port of ``muchsalsa_tpu/ops/chaining_jax.py``.  Every (edge, strand-class)
problem is one row of a padded (B, K) batch; the (B, K, K) compatibility
matrix is built with batched tensor ops (``compat_init_batch``), the forward
DP runs in the chain-scan kernel (``ops/chain_scan.py``), and only the
per-problem scores and backpointers return to the host, where chain
reconstruction and the selection rules reuse the oracle's
``finalize_paths``.

Arithmetic is float64 on every device, bit-equal to the JAX package on the
CPU and to the host oracle ``ops.chaining.check_compatibility``.
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu_torch.ops.chaining import (
    ChainResult, EdgeContext, GatheredMatches, finalize_paths, max_pairwise_paths)
from muchsalsa_tpu_torch.ops.overlap import get_overlap
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.ops.chain_scan import NEG, chain_scan
from muchsalsa_tpu_torch.state import batch_to_torch

Tensor = torch.Tensor


def _corrected(ns, ne, is_, ie, rr, vdir, ov_s, ov_e):
    """(B, K) anchor ranges corrected by rRatio-projected overlap trimming."""
    ncl = (ov_s - is_) / rr
    ncr = (ie - ov_e) / rr
    lo = ns + torch.where(vdir, ncl, ncr)
    hi = ne - torch.where(vdir, ncr, ncl)
    return lo, hi


def _pair_orientation(lo: Tensor, hi: Tensor) -> tuple[Tensor, Tensor]:
    """All-pairs orientation codes in {-2,-1,0,1,2} and gap diffs, (B, K, K)
    with [b, k, l] describing anchors (k, l) — mpp.cpp:67-91."""
    a_lo, a_hi = lo[:, :, None], hi[:, :, None]
    b_lo, b_hi = lo[:, None, :], hi[:, None, :]
    intersect = (a_lo <= b_hi) & (b_lo <= a_hi)

    fwd = (a_lo < b_lo) & (a_hi < b_hi)
    bwd = (a_lo > b_lo) & (a_hi > b_hi)
    ori_int = torch.where(bwd, -2, torch.where(fwd, 2, 0))
    diff_int = torch.where(
        bwd, b_hi - a_lo + 1.0, torch.where(fwd, a_hi - b_lo + 1.0, 0.0))

    lt = a_lo < b_lo
    ori_dis = torch.where(lt, 1, -1)
    diff_dis = torch.where(lt, b_lo - a_hi + 1.0, a_lo - b_hi + 1.0)

    ori = torch.where(intersect, ori_int, ori_dis)
    diff = torch.where(intersect, diff_int, diff_dis)
    return ori, diff


def _vertex_abort(ns: Tensor, ne: Tensor, ori: Tensor) -> Tensor:
    """Abort where corrected and uncorrected orientations disagree in sign
    over intersecting uncorrected ranges (mpp.cpp:93-109)."""
    a_s, a_e = ns[:, :, None], ne[:, :, None]
    b_s, b_e = ns[:, None, :], ne[:, None, :]
    intersect = (a_s <= b_e) & (b_s <= a_e)
    fwd = (a_s < b_s) & (a_e < b_e)
    bwd = (a_s > b_s) & (a_e > b_e)
    uco = torch.where(bwd, -2, torch.where(fwd, 2, 0))
    return intersect & (((ori < 0) & (uco >= 0)) | ((ori > 0) & (uco <= 0)))


def _single_compat(b: dict[str, Tensor], wiggle_room: float) -> tuple[Tensor, Tensor]:
    """(B, K, K) compatibility + (B, K) initial scores (mpp.cpp:38-142),
    the JAX package's per-problem ``_single_compat`` with the vmap written
    out as the leading B axis."""
    v_lo, v_hi = _corrected(
        b["v_ns"], b["v_ne"], b["v_is"], b["v_ie"], b["v_rr"], b["v_dir"],
        b["ov_s"], b["ov_e"],
    )
    w_lo, w_hi = _corrected(
        b["w_ns"], b["w_ne"], b["w_is"], b["w_ie"], b["w_rr"], b["w_dir"],
        b["ov_s"], b["ov_e"],
    )

    o1, d1 = _pair_orientation(v_lo, v_hi)
    o2, d2 = _pair_orientation(w_lo, w_hi)

    abort = _vertex_abort(b["v_ns"], b["v_ne"], o1) | _vertex_abort(
        b["w_ns"], b["w_ne"], o2
    )

    o2 = torch.where(b["cls_dir"][:, None, None], o2, -o2)

    same_nz = (o1 == o2) & (o1 != 0)
    mx = torch.maximum(d1, d2)
    diff = mx - torch.minimum(d1, d2)
    # mx == 0 divides by zero; the where masks it exactly as the JAX code does
    rel = torch.where(mx != 0, diff * 100.0 / mx, float("inf"))
    rule1 = same_nz & ((diff <= wiggle_room) | (rel <= 15.0))
    rule2 = (
        ~same_nz
        & (((o1 < 0) & (o2 < 0)) | ((o1 > 0) & (o2 > 0)))
        & (d1 + d2 <= wiggle_room)
    )

    valid = b["valid"]
    valid_pair = valid[:, :, None] & valid[:, None, :]
    compat = ~abort & (rule1 | rule2) & valid_pair
    init = torch.where(valid, b["score"], NEG)
    return compat, init


def compat_init_batch(batch: dict[str, Tensor], wiggle_room: int) -> tuple[Tensor, Tensor]:
    """(B, K, K) bool compatibility matrices + (B, K) float64 initial scores."""
    return _single_compat(batch, float(wiggle_room))


def chain_dp_batch_kernel(batch: dict[str, Tensor], wiggle_room: int) -> tuple[Tensor, Tensor]:
    """``compat_init_batch`` followed by the chain-scan kernel (the
    counterpart of ``chain_dp_batch_pallas``): per-problem DP scores (B, K)
    and int32 backpointers.  On CPU tensors the scan is the kernel's plain
    version ``chain_scan_reference``."""
    compat, init = compat_init_batch(batch, wiggle_room)
    return chain_scan(compat, init)


# ---------------------------------------------------------------------------
# host-side batch construction + result assembly

# (field name in batch) -> (field name in GatheredMatches)
_FIELD_MAP = {
    "v_ns": "v_ns", "v_ne": "v_ne", "v_is": "v_is", "v_ie": "v_ie", "v_rr": "v_rr",
    "w_ns": "w_ns", "w_ne": "w_ne", "w_is": "w_is", "w_ie": "w_ie", "w_rr": "w_rr",
    "ov_s": "ov_start", "ov_e": "ov_end", "score": "em_score",
}


def chaining_phase_device(
    graph,
    store: MatchStore,
    edge_matches: EdgeMatches,
    wiggle_room: int,
    chain_buckets: tuple[int, ...] = (8, 16, 32, 64, 128),
    min_device_batch: int = 32,
    *,
    device: str | torch.device,
) -> dict:
    """Device-batched variant of ``driver.chaining_phase``.

    One problem per (edge, strand class); batch construction is vectorised
    (one global lexsort + flat scatters).  Problems larger than the biggest
    bucket fall back to the oracle, as does any bucket smaller than
    ``min_device_batch``.  Returns how many problems ran on ``device``
    (``device_problems``) and on the host oracle (``host_problems``), and
    the padded batch size B of each bucket K that ran on ``device``
    (``batches``: {K: B}).
    """
    dev = resolve_device(device)
    if max(chain_buckets) > 128:
        raise ValueError(f"chain buckets {chain_buckets} exceed the kernel's K <= 128")

    gathered = GatheredMatches.build(store, edge_matches)
    em = edge_matches
    f = gathered.fields
    n_rows = len(em.em_edge)

    # global problem grouping: key = (edge, strand class); rows within a
    # problem sorted in vStart order (v_ns, v_ne, illu) — mpp.cpp:172
    key = em.em_edge.astype(np.int64) * 2 + em.em_direction
    order = np.lexsort((f["illu_ids"], f["v_ne"], f["v_ns"], key))
    key_s = key[order]
    bounds = np.nonzero(np.diff(key_s))[0] + 1 if n_rows else np.zeros(0, np.int64)
    starts = np.concatenate([[0], bounds]).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    ends = np.concatenate([bounds, [n_rows]]).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    sizes = ends - starts
    prob_edge = (key_s[starts] // 2).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    prob_dir = (key_s[starts] % 2).astype(bool) if n_rows else np.zeros(0, bool)
    # local (within-edge) row index of each sorted global row
    local_idx = order - em.em_offsets[em.em_edge[order]] if n_rows else np.zeros(0, np.int64)

    n_problems = len(sizes)
    results: dict[tuple[int, bool], list[ChainResult]] = {}
    contexts: dict[int, EdgeContext] = {}

    def ctx_of(edge_idx: int) -> EdgeContext:
        ctx = contexts.get(edge_idx)
        if ctx is None:
            ctx = gathered.context(store, edge_matches, edge_idx)
            contexts[edge_idx] = ctx
        return ctx

    # bucket assignment (vectorised)
    bucket_of = np.full(n_problems, -1, dtype=np.int64)
    for b in sorted(chain_buckets, reverse=True):
        bucket_of[sizes <= b] = b

    host_probs: list[int] = list(np.nonzero(bucket_of < 0)[0])
    batches: dict[int, int] = {}

    for bucket in sorted(set(chain_buckets)):
        probs = np.nonzero(bucket_of == bucket)[0]
        if len(probs) == 0:
            continue
        if len(probs) < min_device_batch:
            host_probs.extend(probs.tolist())
            continue
        # pad the batch axis to the next power of two, as the JAX package
        # does, so that both compute on identical tables
        nb = len(probs)
        B = 1 << int(nb - 1).bit_length() if nb > 1 else 1
        K = bucket
        sel_sizes = sizes[probs]
        total = int(sel_sizes.sum())
        prob_of_row = np.repeat(np.arange(nb), sel_sizes)
        row_pos = np.arange(total) - np.repeat(np.cumsum(sel_sizes) - sel_sizes, sel_sizes)
        src = order[np.repeat(starts[probs], sel_sizes) + row_pos]
        dest = prob_of_row * K + row_pos

        arrs = {}
        for bf, gf in _FIELD_MAP.items():
            a = np.zeros(B * K, dtype=np.float64)
            if bf in ("v_rr", "w_rr"):
                a[:] = 1.0  # padding: avoid div-by-zero; masked anyway
            a[dest] = f[gf][src]
            arrs[bf] = a.reshape(B, K)
        for bf, gf in (("v_dir", "v_dir"), ("w_dir", "w_dir")):
            a = np.zeros(B * K, dtype=bool)
            a[dest] = f[gf][src]
            arrs[bf] = a.reshape(B, K)
        valid = np.zeros(B * K, dtype=bool)
        valid[dest] = True
        arrs["valid"] = valid.reshape(B, K)
        cls_dir = np.zeros(B, dtype=bool)
        cls_dir[:nb] = prob_dir[probs]
        arrs["cls_dir"] = cls_dir

        scores_dev, bps_dev = chain_dp_batch_kernel(batch_to_torch(arrs, dev), int(wiggle_room))
        # one transfer per bucket, not per problem
        scores_np = scores_dev.cpu().numpy()
        bps_np = bps_dev.cpu().numpy()
        batches[K] = B

        for i, p in enumerate(probs):
            n = int(sizes[p])
            srows = [int(x) for x in local_idx[starts[p] : ends[p]]]
            paths, scores = _reconstruct(scores_np[i], bps_np[i], n)
            results[(int(prob_edge[p]), bool(prob_dir[p]))] = finalize_paths(
                ctx_of(int(prob_edge[p])), srows, paths, scores, bool(prob_dir[p])
            )

    for p in host_probs:
        edge_idx = int(prob_edge[p])
        direction = bool(prob_dir[p])
        ctx = ctx_of(edge_idx)
        rows = np.array(
            [r for r in range(len(ctx.illu_ids)) if bool(ctx.em_dir[r]) == direction]
        )
        results[(edge_idx, direction)] = max_pairwise_paths(ctx, rows, direction, wiggle_room)

    # merge per edge exactly like chainingAndOverlaps (main.cpp:328-414)
    for edge in graph.edges():
        ctx = ctx_of(edge.em_idx)
        minus_paths = results.get((edge.em_idx, False), [])
        plus_paths = results.get((edge.em_idx, True), [])

        has_primary = any(p.primary for p in plus_paths) or any(
            p.primary for p in minus_paths
        )
        if has_primary:
            plus_paths = [p for p in plus_paths if p.primary]
            minus_paths = [p for p in minus_paths if p.primary]
        has_multi = any(len(p.ids) > 1 for p in plus_paths) or any(
            len(p.ids) > 1 for p in minus_paths
        )
        if has_multi:
            plus_paths = [p for p in plus_paths if len(p.ids) > 1]
            minus_paths = [p for p in minus_paths if len(p.ids) > 1]

        if len(plus_paths) + len(minus_paths) > 1:
            edge.shadow = True
        else:
            path = minus_paths[0] if minus_paths else plus_paths[0]
            edge.shadow = not path.primary

        for p in minus_paths:
            o = get_overlap(ctx, p.ids, False, p.score, p.primary)
            if o is not None:
                edge.orders.append(o)
        for p in plus_paths:
            o = get_overlap(ctx, p.ids, True, p.score, p.primary)
            if o is not None:
                edge.orders.append(o)

    return {"device_problems": n_problems - len(host_probs),
            "host_problems": len(host_probs), "batches": batches}


def _reconstruct(
    scores: np.ndarray, bps: np.ndarray, n: int
) -> tuple[list[list[int]], list[float]]:
    """Rebuild the reference's population paths from DP backpointers."""
    paths: list[list[int]] = []
    for i in range(n):
        chain = []
        j = i
        while j >= 0:
            chain.append(j)
            j = int(bps[j])
        chain.reverse()
        paths.append(chain)
    return paths, [float(s) for s in scores[:n]]
