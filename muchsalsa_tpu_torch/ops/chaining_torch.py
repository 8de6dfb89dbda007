"""Batched, bucketized anchor-chaining DP on a torch device.

Port of ``muchsalsa_tpu/ops/chaining_jax.py``.  Every (edge, strand-class)
problem is one row of a padded (B, K) batch, packed on the host into pinned
memory (``state.py``) and copied to the card once; the fused kernel
``chain_dp`` (``ops/chain_scan.py``) builds each problem's compatibility and
runs its forward DP, and only the per-problem scores and backpointers
return to the host, where chain reconstruction and the selection rules
reuse the oracle's ``finalize_paths``.  With a mesh of more than one
device, B rounds up to a multiple of its size and each bucket runs through
``parallel/sharded.py::sharded_chain_dp``, one launch per shard.

Arithmetic is float64 on every device, bit-equal to the JAX package on the
CPU and to the host oracle ``ops.chaining.check_compatibility``.
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.config import DeviceConfig
from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu_torch.ops.chaining import (
    ChainResult, EdgeContext, GatheredMatches, finalize_paths, max_pairwise_paths)
from muchsalsa_tpu_torch.ops.overlap import get_overlap
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.ops.chain_scan import chain_dp, compat_init_batch  # noqa: F401
from muchsalsa_tpu_torch.parallel.mesh import Mesh
from muchsalsa_tpu_torch.parallel.sharded import sharded_chain_dp
from muchsalsa_tpu_torch.state import FLOAT_FIELDS, pack_batch, pack_flags

Tensor = torch.Tensor


def chain_dp_batch_kernel(batch: dict[str, Tensor], wiggle_room: int) -> tuple[Tensor, Tensor]:
    """The per-field batch (``state.batch_to_torch``) packed and run through
    the fused chaining kernel ``chain_dp`` (the counterpart of
    ``chain_dp_batch_pallas``): per-problem DP scores (B, K) and int32
    backpointers.  On CPU tensors it runs the plain ``chain_dp_reference``."""
    return chain_dp(*pack_batch(batch), batch["valid"].shape[1], wiggle_room)


# ---------------------------------------------------------------------------
# host-side batch construction + result assembly

# (field name in batch) -> (field name in GatheredMatches)
_FIELD_MAP = {
    "v_ns": "v_ns", "v_ne": "v_ne", "v_is": "v_is", "v_ie": "v_ie", "v_rr": "v_rr",
    "w_ns": "w_ns", "w_ne": "w_ne", "w_is": "w_is", "w_ie": "w_ie", "w_rr": "w_rr",
    "ov_s": "ov_start", "ov_e": "ov_end", "score": "em_score",
}


def bucket_batch(
    f: dict[str, np.ndarray], src: np.ndarray, sizes: np.ndarray, cls_dir: np.ndarray,
    B: int, *, pin: bool,
) -> tuple[Tensor, Tensor, Tensor]:
    """One bucket's packed batch (``state.py``) on the host, in pinned
    memory when ``pin``: the anchors ``src`` (rows of ``f``, the
    ``GatheredMatches`` fields), problem by problem, the first
    ``len(sizes)`` of the B problems holding ``sizes`` anchors and strand
    class ``cls_dir``, the rest none."""
    fields = torch.empty((len(FLOAT_FIELDS), len(src)), dtype=torch.float64, pin_memory=pin)
    fv = fields.numpy()
    for i, bf in enumerate(FLOAT_FIELDS):
        fv[i] = f[_FIELD_MAP[bf]][src]
    flags = torch.empty((len(src),), dtype=torch.uint8, pin_memory=pin)
    flags.numpy()[:] = pack_flags(f["v_dir"][src].astype(np.uint8),
                                  f["w_dir"][src].astype(np.uint8),
                                  np.repeat(cls_dir.astype(np.uint8), sizes))
    offsets = torch.empty((B + 1,), dtype=torch.int32, pin_memory=pin)
    ov = offsets.numpy()
    ov[0] = 0
    np.cumsum(sizes, out=ov[1 : len(sizes) + 1])
    ov[len(sizes) + 1 :] = len(src)
    return fields, flags, offsets


def chaining_phase_device(
    graph,
    store: MatchStore,
    edge_matches: EdgeMatches,
    wiggle_room: int,
    chain_buckets: tuple[int, ...] = DeviceConfig.chain_buckets,
    min_device_batch: int = DeviceConfig.min_device_batch,
    *,
    device: str | torch.device,
    mesh: Mesh | None = None,
) -> dict:
    """Device-batched variant of ``driver.chaining_phase``, on ``device`` or
    sharded over ``mesh`` where it has more than one device.

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
        meshed = mesh is not None and mesh.size > 1
        if meshed:
            B = -(-B // mesh.size) * mesh.size  # shard evenly over the mesh
        K = bucket
        sel_sizes = sizes[probs]
        total = int(sel_sizes.sum())
        row_pos = np.arange(total) - np.repeat(np.cumsum(sel_sizes) - sel_sizes, sel_sizes)
        src = order[np.repeat(starts[probs], sel_sizes) + row_pos]

        # one packed batch of the anchors in pinned memory, one copy each way
        packed = bucket_batch(f, src, sel_sizes, prob_dir[probs], B, pin=dev.type == "cuda")
        if meshed:
            scores_dev, bps_dev, _stats = sharded_chain_dp(*packed, K, int(wiggle_room), mesh)
        else:
            scores_dev, bps_dev = chain_dp(*(x.to(dev, non_blocking=True) for x in packed), K,
                                           int(wiggle_room))
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
