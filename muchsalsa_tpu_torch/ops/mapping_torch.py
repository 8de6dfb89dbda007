"""Read -> unitig mapping on a torch device: the v2 and the v1 join.

Port of ``muchsalsa_tpu/ops/mapping_jax.py``: the host builders of the
packed join tables (``_pack_blocks``, ``_row_bucket``,
``build_device_tables``, ``pack_codes``) and the six stages that
``pipeline/mapper.py::map_all_with_device`` runs per batch on the v2 path:

1. ``minimizer_sketch`` over ``unpack_codes``: the minimizer sketch;
2. ``select_compact_device_v2``: compact the selected minimizers;
3. ``probe_candidates_device_v2``: one rank-table probe per slot;
4. ``compact_candidates_device_v2``: compact the candidates;
5. ``expand_anchors_device_v2``: packed-row join and entry expansion;
6. ``anchors_to_hits_device_dense`` (or ``_packed``): the chaining tail.

``anchors_device_v2`` composes stages 1-5, the one place they are
composed; ``map_reads_device_v2`` (and ``_packed``) adds the padded tail,
the step that ``parallel/sharded.py`` runs on each shard.

Every function takes and returns tensors on one device and never moves
them.  The JAX package's uint32 values (hashes, probe words, hash rows) are
int64 here, holding values in ``[0, 2**32)``; everything else keeps its
value range.  ``lax.sort(..., num_keys=2)`` becomes one stable sort of a
packed int64 key (the primary key in the high 32 bits) with ``gather`` for
the payloads.  The JAX sort is unstable, so where keys tie (padding slots)
the payloads of the two packages may differ; no output reads them.

Where ``build_device_tables`` refuses the index, the mapper runs the v1
join instead: ``build_join_tables`` (the occupancy bitmap and the rank
table) and ``map_reads_device``, one call a batch over unpacked codes and
the index's five arrays on the device, ending in the same chaining tail.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from muchsalsa_tpu_torch.ops.minimizer_torch import (
    BITMAP_LOG2_BITS, MASK32, build_hash_bitmap, minimizer_sketch)

I32_MAX = 2**31 - 1
RANK_LOG2 = 20           # v1 rank-table buckets over the 32-bit hash space
RANK2_LOG2 = 22          # probe buckets; FP rate = H / 2^22 per bucket
_PACK_BITS = 27          # low bits of a packed (offset | count<<27) word
_PACK_MASK = (1 << _PACK_BITS) - 1
_CNT_CAP = 31            # count saturates at 31 (only `> max_per_hit` matters)

HIT_FIELDS = ("unitig", "strand", "qs", "qe", "ts", "te", "matches", "n_anchors")


class DeviceTables(NamedTuple):
    """Packed join tables on a device (see ``build_device_tables``).

    rp:    (2^RANK2_LOG2,) int64 (32-bit values): bucket b of the hash's top
           bits holds ``hstart | nhashes << 27`` into ``jrows`` (0 = empty).
    jrows: (JR, 16) int64 (32-bit values): hash rows ``[hash x8 | val x8]``,
           ``val = entry_start | entry_count << 27`` into ``erows``.
    erows: (ER, 16) int32: entry rows ``[unitig*2+strand x8 | pos x8]``.
    """

    rp: torch.Tensor
    jrows: torch.Tensor
    erows: torch.Tensor


def u32_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy uint32 array on ``device`` as int64 values in ``[0, 2**32)``
    (copied as 4-byte words, widened on the device)."""
    words = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device).to(torch.int64) & MASK32


def _pack_blocks(sizes):
    """Block-packing offsets: single-element blocks go contiguously first
    (they never straddle an 8-row), larger blocks are 8-aligned after
    them.  Returns (starts, total)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    starts = np.zeros(len(sizes), dtype=np.int64)
    single = sizes == 1
    n1 = int(single.sum())
    starts[single] = np.arange(n1)
    multi = ~single & (sizes > 0)
    msizes = sizes[multi]
    aligned = (msizes + 7) & ~np.int64(7)
    base = (n1 + 7) & ~np.int64(7)
    starts[multi] = base + np.concatenate([[0], np.cumsum(aligned)[:-1]])
    total = int(base + aligned.sum()) if len(msizes) else max(n1, 1)
    return starts, total


def _row_bucket(n: int) -> int:
    """Round a table row count up to a quarter-step bucket (pow2 x {1,
    1.25, 1.5, 1.75}), as the JAX package does; pad rows are zeros."""
    L = 256
    while L < n:
        L *= 2
    if L > 256:
        for frac in (5, 6, 7):
            cand = (L // 8) * frac
            if cand >= n:
                return cand
    return L


def build_device_tables(idx_hashes, idx_offsets, entry_unitig, entry_pos, entry_strand,
                        *, device):
    """Build the packed v2 join tables from a host index (numpy) on the
    host and place them on ``device``.

    Returns (DeviceTables, hash_takes), or None when the index violates the
    packing bounds (offsets beyond 27 bits, or a probe bucket with more
    than 31 distinct hashes) or is empty.  Every bound is checked before a
    table is filled, so a refusal costs one pass over the hashes.
    """
    h = np.asarray(idx_hashes, dtype=np.uint32)
    off = np.asarray(idx_offsets, dtype=np.int64)
    H = len(h)
    if H == 0:
        return None

    # the bounds, cheapest first: a probe bucket past 31 hashes refuses
    # every large genome (from ~60 Mb of random sequence)
    b = (h >> np.uint32(32 - RANK2_LOG2)).astype(np.int64)
    bcnt = np.bincount(b, minlength=1 << RANK2_LOG2)
    gmax = int(bcnt.max())
    if gmax > _CNT_CAP:
        return None
    nonempty = np.nonzero(bcnt)[0]
    hstarts_b, H2 = _pack_blocks(bcnt[nonempty])
    if H2 >= (1 << _PACK_BITS):
        return None
    ecnt = np.diff(off)
    estarts, E2 = _pack_blocks(ecnt)
    if E2 >= (1 << _PACK_BITS):
        return None

    # --- pack entries: per-hash blocks ---
    packed = np.asarray(entry_unitig, np.int64) * 2 + np.asarray(entry_strand, np.int64)
    pos = np.asarray(entry_pos, np.int64)
    ER = _row_bucket((E2 + 7) // 8 + 4)  # pad rows: clipped fetches read zeros
    erows = np.zeros((ER, 16), dtype=np.int32)
    dst = np.repeat(estarts, ecnt) + (np.arange(int(off[-1])) - np.repeat(off[:-1], ecnt))
    erows[dst // 8, dst % 8] = packed
    erows[dst // 8, 8 + dst % 8] = pos

    # --- pack hashes: per-bucket blocks ---
    # destination of each hash = its bucket's start + rank within bucket
    first_idx = np.concatenate([[0], np.cumsum(bcnt[nonempty])[:-1]])
    within = np.arange(H) - np.repeat(first_idx, bcnt[nonempty])
    hdst = np.repeat(hstarts_b, bcnt[nonempty]) + within
    JR = _row_bucket((H2 + 7) // 8 + 4)  # pad rows: clipped fetches read zeros
    jrows = np.zeros((JR, 16), dtype=np.uint32)
    val = (estarts[:H] | (np.minimum(ecnt, _CNT_CAP) << _PACK_BITS)).astype(np.uint32)
    jrows[hdst // 8, hdst % 8] = h
    jrows[hdst // 8, 8 + hdst % 8] = val

    rp = np.zeros(1 << RANK2_LOG2, dtype=np.uint32)
    rp[nonempty] = (hstarts_b | (bcnt[nonempty] << _PACK_BITS)).astype(np.uint32)

    hash_takes = max(1, -(-gmax // 8))
    tables = DeviceTables(rp=u32_tensor(rp, device), jrows=u32_tensor(jrows, device),
                          erows=torch.from_numpy(erows).to(device))
    return tables, hash_takes


# ---------------------------------------------------------------------------
# 2-bit codes: 16 bases per 32-bit word plus one non-ACGT bit per base


def pack_codes(codes: np.ndarray, *, device):
    """Host pack of (R, L) uint8 base codes (A..T = 0..3, other/pad = 4)
    into (packed, nmask) on ``device``: (R, L/16) and (R, L/32) int64
    tensors of 32-bit words.  Requires L % 32 == 0."""
    R, L = codes.shape
    if L % 32:
        raise ValueError("pack_codes needs L % 32 == 0")
    c = codes.astype(np.uint32)
    two = (c & 3).reshape(R, L // 16, 16)
    packed = np.bitwise_or.reduce(two << (np.arange(16, dtype=np.uint32) * 2), axis=2)
    nbits = (c >= 4).astype(np.uint32).reshape(R, L // 32, 32)
    nmask = np.bitwise_or.reduce(nbits << np.arange(32, dtype=np.uint32), axis=2)
    return u32_tensor(packed, device), u32_tensor(nmask, device)


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_codes`` on the tensors' device -> (R, L) uint8."""
    R, W = packed.shape
    if tuple(nmask.shape) != (R, W // 2):
        raise ValueError(
            f"mismatched pack pair: packed {tuple(packed.shape)} needs nmask "
            f"{(R, W // 2)}, got {tuple(nmask.shape)}")
    dev = packed.device
    sh2 = torch.arange(16, device=dev) * 2
    codes = ((packed[:, :, None] >> sh2) & 3).reshape(R, W * 16)
    sh1 = torch.arange(32, device=dev)
    other = (((nmask[:, :, None] >> sh1) & 1) != 0).reshape(R, W * 16)
    return torch.where(other, 4, codes).to(torch.uint8)


# ---------------------------------------------------------------------------
# the six stages


def _sort_with(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort of ``key`` along dim 1, payloads following."""
    key, idx = torch.sort(key, dim=1, stable=True)
    return (key, *(torch.gather(p, 1, idx) for p in payloads))


def _sorted_low32(seg_id: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Values ``x`` (in ``[0, 2**32)``) sorted by (seg_id, x) per row."""
    return torch.sort((seg_id << 32) | x, dim=1).values & MASK32


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (1,)), dim=1).values, (1,))


def select_compact_device_v2(selected, h, strand, max_sel: int = 4608):
    """Stage 2/6: compact selected minimizer slots to (R, P), P =
    min(max_sel, Lk).  ``skey`` packs position*2+strand (I32_MAX at
    invalid slots), ``h`` rides as payload.  Returns (skey, h_s, n_sel)."""
    R, Lk = selected.shape
    P = min(max_sel, Lk)
    pos_ids = torch.arange(Lk, device=selected.device)[None, :]
    skey = torch.where(selected, pos_ids * 2 + strand.to(torch.int64), I32_MAX)
    skey, h_s = _sort_with(skey, h)
    n_sel = selected.sum(dim=1)
    return skey[:, :P], h_s[:, :P], n_sel


def probe_candidates_device_v2(skey, h_s, rp):
    """Stage 3/6: the rank-table probe over compacted slots.  Returns
    (rpv, cand)."""
    valid = skey < I32_MAX
    bkt = h_s >> (32 - RANK2_LOG2)
    rpv = rp[torch.where(valid, bkt, 0)]
    return rpv, valid & (rpv != 0)


def compact_candidates_device_v2(skey, h_s, rpv, cand, n_sel, max_pos: int = 1024):
    """Stage 4/6: compact candidate slots to (R, max_pos); h and rpv ride
    the sort.  Returns (ckey, h_c, rpv_c, overflow)."""
    R, P = skey.shape
    max_pos = min(max_pos, P)
    ckey = torch.where(cand, skey, I32_MAX)
    ckey, h_c, rpv_c = _sort_with(ckey, h_s, rpv)
    n_cand = cand.sum(dim=1)
    overflow = (n_sel > P) | (n_cand > max_pos)
    return ckey[:, :max_pos], h_c[:, :max_pos], rpv_c[:, :max_pos], overflow


def expand_anchors_device_v2(ckey, h_c, rpv_c, overflow, jrows, erows,
                             max_per_hit: int = 4, hash_takes: int = 1):
    """Stage 5/6: packed-row join and entry expansion.

    Returns the flat anchors (key, diag, aq, at), each (R, max_pos *
    max_per_hit), the width overflow flags unchanged, and ``max_ecnt``, the
    largest index-entry count (saturated at 31) over the read's found
    minimizers: the tier-routing signal, not folded into ``overflow``.
    """
    if max_per_hit >= _CNT_CAP:
        raise ValueError("max_per_hit must be < 31 for the v2 join path")
    dev = ckey.device
    R, max_pos = ckey.shape
    A = max_per_hit
    S = max_pos * A
    entry_takes = max(1, -(-A // 8))
    cand_v = ckey < I32_MAX
    t_c = torch.where(cand_v, ckey >> 1, 0)          # anchor read position
    strand_c = ckey & 1

    # -- join: fetch the candidate's probe bucket as packed hash rows
    hlo = rpv_c & _PACK_MASK
    hcnt = rpv_c >> _PACK_BITS
    JR = jrows.shape[0]
    row0 = hlo >> 3
    rows = [jrows[torch.clamp(row0 + t, 0, JR - 1)] for t in range(hash_takes)]  # (R, C, 16)
    whash = torch.cat([r[..., :8] for r in rows], dim=-1)  # (R, C, 8*hash_takes)
    wval = torch.cat([r[..., 8:] for r in rows], dim=-1)
    slot = (row0 * 8)[..., None] + torch.arange(8 * hash_takes, device=dev)
    match = (cand_v[..., None] & (whash == h_c[..., None])
             & (slot >= hlo[..., None]) & (slot < (hlo + hcnt)[..., None]))
    found = match.any(dim=-1)
    val = torch.where(match, wval, 0).sum(dim=-1)   # at most one match
    elo = val & _PACK_MASK
    ecnt = val >> _PACK_BITS
    max_ecnt = torch.where(found, ecnt, 0).amax(dim=1)
    cnt_c = torch.where(found, torch.clamp(ecnt, max=A), 0)

    # -- expand: fetch each hash's entry block as packed entry rows.
    # Multi-entry blocks are 8-aligned (offset 0); single-entry blocks sit
    # at arbitrary offsets and need only slot elo % 8.
    ER = erows.shape[0]
    erow0 = elo >> 3
    rows = [erows[torch.clamp(erow0 + t, 0, ER - 1)].to(torch.int64)
            for t in range(entry_takes)]
    wpk = torch.cat([r[..., :8] for r in rows], dim=-1)  # (R, C, 8*entry_takes)
    wpos = torch.cat([r[..., 8:] for r in rows], dim=-1)
    s0 = (elo & 7)[..., None]
    a_ids = torch.arange(A, device=dev)
    a_valid = a_ids < cnt_c[..., None]
    first = a_ids == 0
    aligned = s0 == 0
    pk = torch.where(first, torch.gather(wpk, -1, s0), torch.where(aligned, wpk[..., :A], 0))
    aq = torch.where(first, torch.gather(wpos, -1, s0), torch.where(aligned, wpos[..., :A], 0))
    pk = torch.where(a_valid, pk, 0)
    aq = torch.where(a_valid, aq, 0)

    au = pk >> 1
    arel = (pk & 1) == strand_c[..., None]
    at = t_c[..., None].expand(R, max_pos, A)

    key = torch.where(a_valid, au * 2 + arel.to(torch.int64), I32_MAX).reshape(R, S)
    diag = torch.where(a_valid, torch.where(arel, at - aq, at + aq), 0).reshape(R, S)
    at = torch.where(a_valid, at, 0).reshape(R, S)
    return key, diag, aq.reshape(R, S), at, overflow, max_ecnt


def _anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count,
                     min_chain_score, max_hits, overflow, trim=None):
    """The chaining tail: per-read sort by ((unitig, strand), diagonal),
    band segmentation, per-segment stats by range arithmetic over the
    sorted layout, and hit compaction into ``max_hits`` slots (semantics
    of ``pipeline.mapper.map_read``'s chaining).  Returns the dict of
    ``HIT_FIELDS`` (R, max_hits) plus ``n_hits`` and ``overflow``."""
    R, S = key.shape
    dev = key.device

    # (key, diag) as one int64: key < 2^31 high, diag + 2^31 low
    packed, aq, at = _sort_with((key << 32) | (diag + 2**31), aq, at)
    key = packed >> 32
    diag = (packed & MASK32) - 2**31

    if trim is not None and trim < S:
        # invalid slots sort last: the first `trim` slots drop only padding
        # unless the read has more real anchors (flagged)
        n_anch = (key < I32_MAX).sum(dim=1)
        overflow = overflow | (n_anch > trim)
        key, diag, aq, at = (a[:, :trim] for a in (key, diag, aq, at))
        S = trim

    iota = torch.arange(S, device=dev).expand(R, S)
    valid = key < I32_MAX

    prev_key = torch.cat([torch.full((R, 1), -1, dtype=key.dtype, device=dev), key[:, :-1]], 1)
    prev_diag = torch.cat([diag[:, :1], diag[:, :-1]], 1)
    new_seg = (key != prev_key) | (diag - prev_diag > bandwidth)
    new_seg[:, 0] = True
    last_seg = torch.cat([new_seg[:, 1:], torch.ones_like(new_seg[:, :1])], 1)

    # first/last slot of each position's segment (invalid slots sort last
    # and start their own segments)
    firsts = torch.cummax(torch.where(new_seg, iota, -1), dim=1).values
    ends = _reverse_cummin(torch.where(last_seg, iota, I32_MAX))
    seg_n = ends - firsts + 1

    # segment min/max of aq and at: each segment's min sits at its first
    # slot and its max at its last in the (seg_id, value) order
    seg_id = torch.cumsum(new_seg, dim=1) - 1
    q2 = _sorted_low32(seg_id, aq)

    # covered read bases: t-gaps clipped at k, summed per segment; the
    # segment-end prefix sum broadcasts back by a reverse cummin
    t2 = _sorted_low32(seg_id, at)
    prev_t2 = torch.cat([t2[:, :1], t2[:, :-1]], 1)
    gaps = torch.where(iota == firsts, 0, torch.clamp(t2 - prev_t2, max=k))
    cg = torch.cumsum(gaps, dim=1)
    cg_end = _reverse_cummin(torch.where(last_seg, cg, I32_MAX))
    covered = k + cg_end - cg

    ok = new_seg & valid & (seg_n >= min_anchor_count) & (covered >= min_chain_score)

    # compact surviving segments into max_hits slots in (key, diag) order
    hit_pos = torch.sort(torch.where(ok, iota, I32_MAX), dim=1).values[:, :max_hits]
    hit_valid = hit_pos < I32_MAX
    hit_safe = torch.where(hit_valid, hit_pos, 0)

    n_hits = ok.sum(dim=1)
    overflow = overflow | (n_hits > max_hits)

    def take(arr, at_idx=hit_safe):
        return torch.gather(arr, 1, at_idx)

    def mask(arr):
        return torch.where(hit_valid, arr, 0)

    ends_h = take(ends)
    ends_safe = torch.where(hit_valid, ends_h, 0)
    key_h = take(key)
    return {
        "unitig": mask(key_h // 2),
        "strand": mask(key_h % 2),
        "qs": mask(take(q2)),
        "qe": mask(take(q2, ends_safe) + k),
        "ts": mask(take(t2)),
        "te": mask(take(t2, ends_safe) + k),
        "matches": mask(take(covered)),
        "n_anchors": mask(ends_h - hit_pos + 1),
        "n_hits": torch.clamp(n_hits, max=max_hits),
        "overflow": overflow,
    }


def anchors_to_hits_device_packed(key, diag, aq, at, overflow, max_ecnt=None, k: int = 15,
                                  bandwidth: int = 500, min_anchor_count: int = 4,
                                  min_chain_score: int = 100, max_hits: int = 64,
                                  trim: int | None = None, per_hit_cap: int | None = None):
    """Stage 6/6, padded layout: one (R, 8*max_hits + 2) int64 tensor
    ``[HIT_FIELDS x max_hits | n_hits | overflow]``.  ``per_hit_cap`` folds
    the expansion-cap violation (``max_ecnt > cap``) into the overflow."""
    if max_ecnt is not None and per_hit_cap is not None:
        overflow = overflow | (max_ecnt > per_hit_cap)
    return pack_hits(_anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count,
                                      min_chain_score, max_hits, overflow, trim=trim))


def pack_hits(out: dict) -> torch.Tensor:
    """The ``_anchors_to_hits`` dict as one (R, 8*max_hits + 2) int64
    tensor ``[HIT_FIELDS x max_hits | n_hits | overflow]``, so that a
    batch's hits cross to the host in one copy (``unpack_hits``)."""
    R = out["n_hits"].shape[0]
    head = torch.stack([out[f] for f in HIT_FIELDS], dim=1).reshape(R, -1)
    tail = torch.stack([out["n_hits"], out["overflow"].to(torch.int64)], dim=1)
    return torch.cat([head, tail], dim=1)


def anchors_to_hits_device_dense(key, diag, aq, at, overflow, max_ecnt=None, k: int = 15,
                                 bandwidth: int = 500, min_anchor_count: int = 4,
                                 min_chain_score: int = 100, max_hits: int = 64,
                                 trim: int | None = None, budget: int | None = None):
    """Stage 6/6, dense layout: the batch's hits packed into
    ``B = min(budget, R*max_hits)`` rows (``budget`` defaults to 16 R).

    Returns one flat (3R + 9B,) int64 tensor: ``[n_hits (R) |
    width_overflow (R) | max_ecnt (R) | rows]``, each row ``[flat_slot |
    unitig | strand | qs | qe | ts | te | matches | n_anchors]`` with
    ``flat_slot = read*max_hits + slot`` in (read, slot) order and
    I32_MAX rows as padding.  The overflow word is the width overflow
    alone; the caller compares ``max_ecnt`` with its expansion cap.  A
    batch with more than B hits must be re-pulled through the padded tail.
    """
    out = _anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count,
                           min_chain_score, max_hits, overflow, trim=trim)
    me_word = max_ecnt if max_ecnt is not None else torch.zeros_like(out["n_hits"])
    R = key.shape[0]
    F = R * max_hits
    # the host side clamps the budget identically
    B = min(budget if budget is not None else 16 * R, F)
    dev = key.device
    slot = torch.arange(max_hits, device=dev)[None, :]
    hit_valid = slot < out["n_hits"][:, None]
    flat_key = torch.where(
        hit_valid, torch.arange(R, device=dev)[:, None] * max_hits + slot, I32_MAX).reshape(F)
    pos = torch.sort(flat_key).values[:B]
    is_hit = pos < I32_MAX
    safe = torch.where(is_hit, pos, 0)
    cols = [pos] + [torch.where(is_hit, out[f].reshape(F)[safe], 0) for f in HIT_FIELDS]
    dense = torch.stack(cols, dim=1)
    return torch.cat([out["n_hits"], out["overflow"].to(torch.int64), me_word.to(torch.int64),
                      dense.reshape(-1)])


def unpack_hits(arr, max_hits: int) -> dict:
    """Host inverse of ``anchors_to_hits_device_packed`` -> the
    ``_anchors_to_hits`` dict of numpy arrays."""
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    R = arr.shape[0]
    fields = arr[:, : 8 * max_hits].reshape(R, 8, max_hits)
    out = {f: fields[:, i] for i, f in enumerate(HIT_FIELDS)}
    out["n_hits"] = arr[:, -2]
    out["overflow"] = arr[:, -1] != 0
    return out


def anchors_device_v2(codes, lens, rp, jrows, erows, *, k: int = 15, w: int = 5,
                      max_sel: int = 4608, max_pos: int = 1024, max_per_hit: int = 4,
                      hash_takes: int = 1):
    """Stages 1-5 of the v2 mapper over (R, L) codes (pad 4) and the
    ``DeviceTables`` fields: (key, diag, aq, at, overflow, max_ecnt), as
    ``expand_anchors_device_v2`` returns them."""
    selected, h, strand = minimizer_sketch(codes, lens, k, w)
    # a caller's temporary codes die here, before the later stages allocate
    # (the card's peak); CPython hands a call's arguments to the callee
    del codes
    skey, h_s, n_sel = select_compact_device_v2(selected, h, strand, max_sel=max_sel)
    rpv, cand = probe_candidates_device_v2(skey, h_s, rp)
    sel = compact_candidates_device_v2(skey, h_s, rpv, cand, n_sel, max_pos=max_pos)
    return expand_anchors_device_v2(*sel, jrows, erows, max_per_hit=max_per_hit,
                                    hash_takes=hash_takes)


def map_reads_device_v2(codes, lens, rp, jrows, erows, *, k: int = 15, w: int = 5,
                        bandwidth: int = 500, min_anchor_count: int = 4,
                        min_chain_score: int = 100, max_sel: int = 4608, max_pos: int = 1024,
                        max_per_hit: int = 4, max_hits: int = 64, hash_takes: int = 1,
                        trim: int | None = None):
    """The six v2 stages as one call over (R, L) codes (pad 4) and the
    ``DeviceTables`` fields: ``mapping_jax.map_reads_device_v2``, the
    expansion-cap violation folded into ``overflow``.  Returns the dict of
    ``HIT_FIELDS`` (R, max_hits) plus ``n_hits`` and ``overflow``."""
    key, diag, aq, at, overflow, max_ecnt = anchors_device_v2(
        codes, lens, rp, jrows, erows, k=k, w=w, max_sel=max_sel, max_pos=max_pos,
        max_per_hit=max_per_hit, hash_takes=hash_takes)
    return _anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count, min_chain_score,
                            max_hits, overflow | (max_ecnt > max_per_hit), trim=trim)


def map_reads_device_v2_packed(packed, nmask, lens, rp, jrows, erows, **kwargs):
    """``map_reads_device_v2`` over 2-bit packed codes (``pack_codes``)."""
    return map_reads_device_v2(unpack_codes(packed, nmask), lens, rp, jrows, erows, **kwargs)


# ---------------------------------------------------------------------------
# the v1 join: occupancy bitmap, binary search over the sorted hashes


def build_join_tables(idx_hashes, *, device) -> tuple:
    """The v1 join's host-built tables on ``device``: the occupancy bitmap
    (``minimizer_torch.build_hash_bitmap``), the rank table ``rank[b] =
    lower_bound(hashes, b << (32 - RANK_LOG2))`` with ``rank[2**RANK_LOG2]
    = H`` ((2**RANK_LOG2 + 1,) int32), and the number of binary-search
    rounds that the largest rank bucket needs.  Returns (bitmap, rank,
    rounds) for ``map_reads_device``."""
    h = np.asarray(idx_hashes, dtype=np.uint32)
    bounds = (np.arange(1 << RANK_LOG2, dtype=np.uint64) << (32 - RANK_LOG2)).astype(np.uint32)
    rank = np.concatenate([np.searchsorted(h, bounds).astype(np.int32), np.int32([len(h)])])
    max_gap = int(np.max(np.diff(rank))) if len(h) else 0
    rounds = max(int(np.ceil(np.log2(max_gap + 1))), 1)
    return build_hash_bitmap(h, device=device), torch.from_numpy(rank).to(device), rounds


def v1_candidates(selected, h, strand, idx_hashes, bitmap=None, max_pos: int = 512,
                  log2_bits: int = BITMAP_LOG2_BITS):
    """The v1 join's prefilter and compaction: the selected positions whose
    folded hash is set in ``bitmap`` (or, without one, whose hash is in
    ``idx_hashes``), compacted in position order into ``max_pos`` slots.

    Returns (h_c, strand_c, pos_c, pos_valid, n_cand): the hash, strand
    and read position of each slot (position 0's at empty slots), which
    slots hold a candidate, and each read's candidate count.  Bitmap false
    positives count and take slots, as in the JAX package."""
    R, Lk = selected.shape
    if bitmap is not None:
        folded = h & ((1 << log2_bits) - 1)
        probe = (bitmap[folded >> 5].to(torch.int64) >> (folded & 31)) & 1
        cand = selected & (probe != 0)
    elif idx_hashes.numel():
        loc0 = torch.clamp(torch.searchsorted(idx_hashes, h), max=idx_hashes.numel() - 1)
        cand = (idx_hashes[loc0] == h) & selected
    else:
        cand = torch.zeros_like(selected)
    pos_ids = torch.arange(Lk, device=h.device).expand(R, Lk)
    pos_sorted = torch.sort(torch.where(cand, pos_ids, I32_MAX), dim=1).values[:, :max_pos]
    pos_valid = pos_sorted < I32_MAX
    pos_c = torch.where(pos_valid, pos_sorted, 0)
    return (torch.gather(h, 1, pos_c), torch.gather(strand, 1, pos_c), pos_c, pos_valid,
            cand.sum(dim=1))


def v1_expand(h_c, strand_c, pos_c, pos_valid, n_cand, idx_hashes, idx_offsets, entry_unitig,
              entry_pos, entry_strand, max_pos: int, max_per_hit: int = 4):
    """The v1 join's exact membership search and entry expansion.

    Each slot's hash is looked up in the sorted ``idx_hashes`` (int64,
    32-bit values) by one ``searchsorted``: the lower bound that the JAX
    package's rank-bounded binary search also finds.  A found hash expands
    to its first ``max_per_hit`` index entries.  Returns the flat anchors
    (key, diag, aq, at), each (R, max_pos * max_per_hit), and ``overflow``:
    more candidates than ``max_pos``, or a hash with more entries than
    ``max_per_hit``."""
    R, P = h_c.shape
    A = max_per_hit
    H = idx_hashes.numel()
    dev = h_c.device
    if H:
        loc = torch.clamp(torch.searchsorted(idx_hashes, h_c), max=H - 1)
        found = (idx_hashes[loc] == h_c) & pos_valid
        lo = idx_offsets[loc].to(torch.int64)
        hi = idx_offsets[loc + 1].to(torch.int64)
    else:
        found = torch.zeros_like(pos_valid)
        lo = hi = torch.zeros_like(pos_c)
    lo_c = torch.where(found, lo, 0)
    cnt_full = torch.where(found, hi - lo, 0)
    cnt_c = torch.clamp(cnt_full, max=A)
    overflow = (n_cand > max_pos) | (cnt_full > A).any(dim=1)

    a_ids = torch.arange(A, device=dev)
    a_valid = a_ids < cnt_c[..., None]
    src = torch.where(a_valid, lo_c[..., None] + a_ids, 0)

    def entries(arr):
        return arr[src].to(torch.int64) if H else torch.zeros_like(src)

    au = entries(entry_unitig)
    aq = entries(entry_pos)
    arel = entries(entry_strand) == strand_c.to(torch.int64)[..., None]
    at = pos_c[..., None].expand(R, P, A)
    S = P * A
    key = torch.where(a_valid, au * 2 + arel.to(torch.int64), I32_MAX).reshape(R, S)
    diag = torch.where(a_valid, torch.where(arel, at - aq, at + aq), 0).reshape(R, S)
    aq = torch.where(a_valid, aq, 0).reshape(R, S)
    at = torch.where(a_valid, at, 0).reshape(R, S)
    return key, diag, aq, at, overflow


def map_reads_device(codes, lens, idx_hashes, idx_offsets, entry_unitig, entry_pos,
                     entry_strand, bitmap=None, rank_table=None, *, k: int = 15, w: int = 5,
                     bandwidth: int = 500, min_anchor_count: int = 4, min_chain_score: int = 100,
                     max_pos: int = 512, max_per_hit: int = 4, max_hits: int = 64,
                     log2_bits: int = BITMAP_LOG2_BITS, join_rounds: int = 0,
                     trim: int | None = None):
    """Map a batch of reads against the index on the tensors' device: the
    v1 join (``mapping_jax.map_reads_device``).

    ``codes``: (R, L) base codes, pad 4; ``lens``: (R,); ``idx_hashes``:
    (H,) sorted int64 hashes in ``[0, 2**32)``; ``idx_offsets``: (H + 1,)
    CSR offsets; ``entry_unitig``, ``entry_pos``, ``entry_strand``: (E,).
    ``bitmap`` and ``rank_table`` come from ``build_join_tables``; the
    bitmap sets which positions are candidates (false positives included).
    The JAX package bounds its binary search with ``rank_table`` in
    ``join_rounds`` rounds; the index it finds is the one ``searchsorted``
    returns, which this function uses whether or not they are given.

    Returns the dict of ``HIT_FIELDS`` (R, max_hits) plus ``n_hits`` and
    ``overflow`` (anchor budgets exceeded: map the read on the host).
    """
    del rank_table, join_rounds  # the search below finds the same index
    L = codes.shape[1]
    max_pos = min(max_pos, L - k + 1)  # short batches can't exceed Lk positions
    selected, h, strand = minimizer_sketch(codes, lens, k, w)
    cands = v1_candidates(selected, h, strand, idx_hashes, bitmap, max_pos, log2_bits)
    key, diag, aq, at, overflow = v1_expand(*cands, idx_hashes, idx_offsets, entry_unitig,
                                            entry_pos, entry_strand, max_pos, max_per_hit)
    return _anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count, min_chain_score,
                            max_hits, overflow, trim=trim)
