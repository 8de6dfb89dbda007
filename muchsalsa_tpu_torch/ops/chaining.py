"""Anchor chaining over shared unitigs — exact host oracle.

Reference counterpart: ``getMaxPairwisePaths`` + ``checkCompatibility``
(``libms/src/kernel/mpp.cpp:38-305``).  Given one overlap-graph edge
(two nanopore reads) and the unitig ids they share in one strand class,
this finds maximum-score chains of mutually order/gap-consistent anchors
via the O(k^2) forward DP, returns the best chain plus disjoint chains
scoring > 75% of the max, and applies the "interleaved anchors on both
reads" shadow demotion.

This module is the *bit-exact scalar oracle*; the batched/bucketized JAX
device version (``muchsalsa_tpu_torch.ops.chaining_jax``) is verified against
it test-by-test.  Arithmetic is float64 throughout, like the C++ doubles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore


@dataclass
class ChainResult:
    ids: list[int]       # unitig ids in chain order
    score: int           # double DP score truncated to size_t (mpp.cpp:34,221)
    primary: bool


@dataclass
class EdgeContext:
    """Everything chaining needs about one edge.

    ``v`` is the edge's first vertex (lower meta line), ``w`` the second
    — the reference's ``edge.getVertices().first/.second``.  The
    full-vertex match lists needed by the (rare) shadow-demotion scan
    are resolved lazily through ``store``.
    """

    v: int
    w: int
    illu_ids: np.ndarray      # int64, per edge-match row
    ov_start: np.ndarray
    ov_end: np.ndarray
    em_dir: np.ndarray        # bool
    em_score: np.ndarray      # float64
    em_primary: np.ndarray    # bool
    # vertex-match data aligned with illu_ids, for v and w
    v_ns: np.ndarray; v_ne: np.ndarray; v_is: np.ndarray; v_ie: np.ndarray
    v_rr: np.ndarray; v_dir: np.ndarray
    w_ns: np.ndarray; w_ne: np.ndarray; w_is: np.ndarray; w_ie: np.ndarray
    w_rr: np.ndarray; w_dir: np.ndarray
    v_len: int = 0            # nanopore read lengths
    w_len: int = 0
    store: MatchStore = None  # for lazy all-matches lookups

    def em_index(self, illu: int) -> int:
        # lazy dict: per-call np.searchsorted costs ~8x a dict hit and
        # chaining probes each context's ids many times
        lut = self.__dict__.get("_em_lut")
        if lut is None:
            lut = {int(x): i for i, x in enumerate(self.illu_ids)}
            self.__dict__["_em_lut"] = lut
        return lut.get(illu, len(self.illu_ids))

    def illu_list(self) -> list[int]:
        """illu_ids as a python list (scalar indexing ~10x numpy's)."""
        out = self.__dict__.get("_illu_list")
        if out is None:
            out = [int(x) for x in self.illu_ids]
            self.__dict__["_illu_list"] = out
        return out

    def primary_list(self) -> list[bool]:
        out = self.__dict__.get("_primary_list")
        if out is None:
            out = [bool(x) for x in self.em_primary]
            self.__dict__["_primary_list"] = out
        return out

    def all_ids_sorted(self, first_vertex: bool) -> list[int]:
        """All unitig ids of v (or w) sorted by (nano range, id) — the
        vIDsStart/vIDsEnd lists of the shadow-demotion scan
        (mpp.cpp:254-272)."""
        return self.store.sorted_illu_ids(self.v if first_vertex else self.w)


@dataclass
class GatheredMatches:
    """Per-edge-match-row vertex-match data, gathered once for all edges
    (replaces per-edge hash lookups with two vectorised gathers)."""

    rv: np.ndarray
    rw: np.ndarray
    fields: dict

    @staticmethod
    def build(store: MatchStore, edges: EdgeMatches) -> "GatheredMatches":
        rv = store.rows(edges.edge_v[edges.em_edge], edges.em_illu)
        rw = store.rows(edges.edge_w[edges.em_edge], edges.em_illu)
        fields = {
            "illu_ids": edges.em_illu.astype(np.int64),
            "ov_start": edges.em_ov_start.astype(np.int64),
            "ov_end": edges.em_ov_end.astype(np.int64),
            "em_dir": edges.em_direction,
            "em_score": edges.em_score,
            "em_primary": edges.em_primary,
            "v_ns": store.nano_start[rv].astype(np.int64),
            "v_ne": store.nano_end[rv].astype(np.int64),
            "v_is": store.illu_start[rv].astype(np.int64),
            "v_ie": store.illu_end[rv].astype(np.int64),
            "v_rr": store.rratio[rv],
            "v_dir": store.direction[rv],
            "w_ns": store.nano_start[rw].astype(np.int64),
            "w_ne": store.nano_end[rw].astype(np.int64),
            "w_is": store.illu_start[rw].astype(np.int64),
            "w_ie": store.illu_end[rw].astype(np.int64),
            "w_rr": store.rratio[rw],
            "w_dir": store.direction[rw],
        }
        return GatheredMatches(rv, rw, fields)

    def context(self, store: MatchStore, edges: EdgeMatches, edge_idx: int) -> EdgeContext:
        lo = int(edges.em_offsets[edge_idx])
        hi = int(edges.em_offsets[edge_idx + 1])
        sl = slice(lo, hi)
        v = int(edges.edge_v[edge_idx])
        w = int(edges.edge_w[edge_idx])
        # vectorised once for all edges (two searchsorted calls instead
        # of two per context — measured hot at 178k-edge scale)
        vidx = self.__dict__.get("_vidx")
        if vidx is None:
            vidx = (store.vertex_index(edges.edge_v),
                    store.vertex_index(edges.edge_w))
            self.__dict__["_vidx"] = vidx
        vi = vidx[0][edge_idx]
        wi = vidx[1][edge_idx]
        return EdgeContext(
            v=v,
            w=w,
            v_len=int(store.vertex_length[vi]),
            w_len=int(store.vertex_length[wi]),
            store=store,
            **{k: arr[sl] for k, arr in self.fields.items()},
        )


def make_edge_context(store: MatchStore, edges: EdgeMatches, edge_idx: int) -> EdgeContext:
    return GatheredMatches.build(store, edges).context(store, edges, edge_idx)


def _nano_check(ctx: EdgeContext, i1: int, i2: int, use_v: bool) -> tuple[bool, int, float]:
    """One vertex's orientation/diff classification (mpp.cpp:41-112).

    Returns (abort, orientation, diff).
    """
    if use_v:
        ns, ne, is_, ie, rr, vdir = ctx.v_ns, ctx.v_ne, ctx.v_is, ctx.v_ie, ctx.v_rr, ctx.v_dir
    else:
        ns, ne, is_, ie, rr, vdir = ctx.w_ns, ctx.w_ne, ctx.w_is, ctx.w_ie, ctx.w_rr, ctx.w_dir

    def corrected(i: int) -> tuple[float, float]:
        ncl = (ctx.ov_start[i] - is_[i]) / rr[i]
        ncr = (ie[i] - ctx.ov_end[i]) / rr[i]
        if not vdir[i]:
            ncl, ncr = ncr, ncl
        return ns[i] + ncl, ne[i] - ncr

    c1 = corrected(i1)
    c2 = corrected(i2)

    orientation, diff = 0, 0.0
    if c1[0] <= c2[1] and c2[0] <= c1[1]:
        if c1[0] < c2[0] and c1[1] < c2[1]:
            orientation, diff = 2, c1[1] - c2[0] + 1
        if c1[0] > c2[0] and c1[1] > c2[1]:
            orientation, diff = -2, c2[1] - c1[0] + 1
    elif c1[0] < c2[0]:
        orientation, diff = 1, c2[0] - c1[1] + 1
    else:
        orientation, diff = -1, c1[0] - c2[1] + 1

    # compare against the *uncorrected* ranges; mismatching signs abort
    if ns[i1] <= ne[i2] and ns[i2] <= ne[i1]:
        uco = 0
        if ns[i1] < ns[i2] and ne[i1] < ne[i2]:
            uco = 2
        if ns[i1] > ns[i2] and ne[i1] > ne[i2]:
            uco = -2
        if (orientation < 0 and uco >= 0) or (orientation > 0 and uco <= 0):
            return True, orientation, diff

    return False, orientation, diff


def check_compatibility(ctx: EdgeContext, i1: int, i2: int, wiggle_room: int) -> bool:
    """mpp.cpp:38-142; ``i1``/``i2`` are edge-match row indices."""
    abort1, o1, d1 = _nano_check(ctx, i1, i2, use_v=True)
    abort2, o2, d2 = _nano_check(ctx, i1, i2, use_v=False)
    if abort1 or abort2:
        return False

    if not ctx.em_dir[i1]:
        o2 = -o2

    if o1 == o2 and o1 != 0:
        diff = max(d1, d2) - min(d1, d2)
        return diff <= float(wiggle_room) or (
            max(d1, d2) != 0 and diff * 100 / max(d1, d2) <= 15
        )
    if (o1 < 0 and o2 < 0) or (o1 > 0 and o2 > 0):
        return d1 + d2 <= float(wiggle_room)
    return False


def max_pairwise_paths(
    ctx: EdgeContext, rows: np.ndarray, direction: bool, wiggle_room: int
) -> list[ChainResult]:
    """mpp.cpp:145-305.  ``rows``: edge-match row indices of one strand class."""
    if len(rows) == 0:
        return []

    # vStart: sorted by (nano range on v, illu id)
    v_keys = [(int(ctx.v_ns[r]), int(ctx.v_ne[r]), int(ctx.illu_ids[r]), int(r)) for r in rows]
    v_keys.sort()

    srows = [k[3] for k in v_keys]  # edge-match rows in vStart order
    L = len(srows)

    paths: list[list[int]] = [[] for _ in range(L)]
    scores = [float(ctx.em_score[r]) for r in srows]

    for k in range(L - 1):
        for l in range(k + 1, L):
            score = scores[k] + float(ctx.em_score[srows[l]])
            if score > scores[l] and check_compatibility(ctx, srows[k], srows[l], wiggle_room):
                paths[l] = paths[k] + [k]
                scores[l] = score

    for i in range(L):
        paths[i].append(i)

    return finalize_paths(ctx, srows, paths, scores, direction)


def finalize_paths(
    ctx: EdgeContext,
    srows: list[int],
    paths: list[list[int]],
    scores: list[float],
    direction: bool,
) -> list[ChainResult]:
    """Post-DP selection: best chain, 75% disjoint secondaries, shadow
    demotion (mpp.cpp:201-304).  Shared by the host oracle and the JAX
    batched DP (which reconstructs ``paths``/``scores`` from device
    output)."""
    L = len(srows)
    max_val = 0.0
    max_idx = 0
    for i in range(L):
        if scores[i] > max_val:
            max_val = scores[i]
            max_idx = i

    illu = ctx.illu_list()
    primary = ctx.primary_list()

    def ids_of(path: list[int]) -> list[int]:
        return [illu[srows[p]] for p in path]

    best_ids = ids_of(paths[max_idx])
    has_primary = any(primary[srows[p]] for p in paths[max_idx]) or len(paths[max_idx]) > 2
    # scores truncate double -> size_t on emplacement (path_t, mpp.cpp:34);
    # the 75% threshold is computed from the *untruncated* double
    result = [ChainResult(best_ids, int(max_val), bool(has_primary))]

    threshold = max_val * 0.75
    for i in range(L):
        if scores[i] > threshold:
            member_ids = ids_of(paths[i])
            disjoint = all(
                not any(mid in existing.ids for mid in member_ids) for existing in result
            )
            if disjoint:
                result.append(
                    ChainResult(
                        member_ids,
                        int(scores[i]),
                        any(primary[srows[p]] for p in paths[i]),
                    )
                )

    # shadow demotion of a lone primary chain (mpp.cpp:251-302)
    if len(result) == 1 and result[0].primary:
        ids_start = ctx.all_ids_sorted(True)
        ids_end = ctx.all_ids_sorted(False)
        if not direction:
            ids_end = ids_end[::-1]
        p_ids = result[0].ids
        front, back = p_ids[0], p_ids[-1]
        if (ids_start[0] != front and ids_end[0] != front) or (
            ids_start[-1] != back and ids_end[-1] != back
        ):
            result[0] = ChainResult(p_ids, result[0].score, False)
        else:
            i = j = 0
            is_shadow = False
            for pid in p_ids:
                ri = _find_from(ids_start, i, pid)
                is_inter = ri > i
                i = ri + 1
                rj = _find_from(ids_end, j, pid)
                is_inter = is_inter and rj > j
                j = rj + 1
                if is_inter:
                    is_shadow = True
                    break
            if is_shadow:
                result[0] = ChainResult(p_ids, result[0].score, False)

    return result


def _find_from(haystack: list[int], start: int, needle: int) -> int:
    """Index of needle at/after start; len(haystack) if absent (std::find_if)."""
    start = min(start, len(haystack))
    for idx in range(start, len(haystack)):
        if haystack[idx] == needle:
            return idx
    return len(haystack)
