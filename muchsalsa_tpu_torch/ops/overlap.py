"""Overhang computation + dovetail/containment classification.

Reference counterpart: ``getOverhangs`` / ``getOverlap``
(``libms/src/kernel/ol.cpp:31-101``).  Given a surviving anchor chain on
an edge, projects the unitig-overlap trimming onto nanopore coordinates
(rRatio scaling) and classifies the relative placement of the two reads
into containment vs dovetail, emitting an :class:`EdgeOrder`.
"""

from __future__ import annotations

from typing import Optional

from muchsalsa_tpu_torch.graph.graph import EdgeOrder
from muchsalsa_tpu_torch.ops.chaining import EdgeContext


def get_overhangs(ctx: EdgeContext, use_v: bool, em_row: int) -> tuple[float, float]:
    """ol.cpp:31-50 — (left, right) overhang of one read past the anchor."""
    if use_v:
        ns, ne, is_, ie, rr, vdir, nlen = (
            ctx.v_ns, ctx.v_ne, ctx.v_is, ctx.v_ie, ctx.v_rr, ctx.v_dir, ctx.v_len,
        )
    else:
        ns, ne, is_, ie, rr, vdir, nlen = (
            ctx.w_ns, ctx.w_ne, ctx.w_is, ctx.w_ie, ctx.w_rr, ctx.w_dir, ctx.w_len,
        )

    ncl = (ctx.ov_start[em_row] - is_[em_row]) / rr[em_row]
    ncr = (ie[em_row] - ctx.ov_end[em_row]) / rr[em_row]
    if not vdir[em_row]:
        ncl, ncr = ncr, ncl

    overhang_left = float(ns[em_row]) + ncl
    overhang_right = float(nlen - ne[em_row]) + ncr
    return overhang_left, overhang_right


def get_overlap(
    ctx: EdgeContext,
    ids: list[int],
    direction: bool,
    score: float,
    primary: bool,
) -> Optional[EdgeOrder]:
    """ol.cpp:53-101 — classify chain into an EdgeOrder (or None)."""
    first_row = ctx.em_index(ids[0])
    last_row = ctx.em_index(ids[-1])

    lo_first_v, _ = get_overhangs(ctx, True, first_row)
    _, ro_last_v = get_overhangs(ctx, True, last_row)
    fw_l, fw_r = get_overhangs(ctx, False, first_row)
    lw_l, lw_r = get_overhangs(ctx, False, last_row)

    left_v, right_v = lo_first_v, ro_last_v
    if direction:
        left_w, right_w = fw_l, lw_r
    else:
        left_w, right_w = fw_r, lw_l

    ids_t = tuple(ids)
    base = ctx.v
    if left_v <= left_w and right_v <= right_w:
        return EdgeOrder(ctx.v, ctx.w, left_w - left_v, right_w - right_v,
                         True, base, score, ids_t, direction, primary)
    if left_v >= left_w and right_v >= right_w:
        return EdgeOrder(ctx.w, ctx.v, left_v - left_w, right_v - right_w,
                         True, base, score, ids_t, direction, primary)
    if left_v > left_w and right_v < right_w:
        return EdgeOrder(ctx.v, ctx.w, left_v - left_w, right_w - right_v,
                         False, base, score, ids_t, direction, primary)
    if left_v < left_w and right_v > right_w:
        return EdgeOrder(ctx.w, ctx.v, left_w - left_v, right_v - right_w,
                         False, base, score, ids_t, direction, primary)
    return None
