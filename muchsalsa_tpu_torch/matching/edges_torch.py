"""Scaffold all-pairs intersection on a torch device.

Port of ``muchsalsa_tpu/matching/edges_jax.py``: the device twin of
``matching.edges.build_edges``.  Scaffolds (unitig groups) pad into fixed
(G, K) tables, one (K, K) upper-triangle intersection per scaffold runs as
batched tensor ops, the surviving pairs are compacted on the device, and
only they return to the host, where the identical ``EdgeMatches`` table is
finished.  With a mesh, G pads to a multiple of its size and the scaffolds
are cut over its devices (``parallel/sharded.py``).  Scaffolds larger than
``max_scaffold`` run through the host pair path — same formulas, same
output.
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.matching.edges import (
    _empty_edges, _finish_edges, _pair_indices, _scaffold_groups)
from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.parallel.mesh import Mesh
from muchsalsa_tpu_torch.parallel.sharded import run_sharded


def scaffold_pairs_device(
    ist: torch.Tensor, ien: torch.Tensor, valid: torch.Tensor, th_overlap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, K) illumina ranges -> (G, K, K) pair overlap fields.

    Entry [g, j, i] (i = inner/earlier line, j = outer) holds the
    intersection of rows i and j of scaffold g; ``keep`` applies the strict
    ``end - start > th_overlap`` rule (MatchMap.cpp:192).
    """
    a_s, a_e = ist[:, None, :], ien[:, None, :]          # inner (i) axis
    b_s, b_e = ist[:, :, None], ien[:, :, None]          # outer (j) axis
    ov_s = torch.maximum(a_s, b_s)
    ov_e = torch.minimum(a_e, b_e)
    idx = torch.arange(ist.shape[1], device=ist.device)
    tri = idx[None, :] < idx[:, None]                    # [j, i]: i < j
    pair_valid = valid[:, None, :] & valid[:, :, None] & tri[None]
    keep = pair_valid & (ov_s <= ov_e) & ((ov_e - ov_s) > th_overlap)
    return ov_s, ov_e, keep


def build_edges_device(
    store: MatchStore,
    th_overlap: int = 100,
    max_scaffold: int = 256,
    *,
    device: str | torch.device,
    mesh: Mesh | None = None,
) -> EdgeMatches:
    """``build_edges`` with the all-pairs intersection on ``device``, or cut
    over ``mesh``'s devices.  Output is identical to the host path."""
    dev = resolve_device(device)
    n = len(store)
    if n == 0:
        return _empty_edges()

    order, group_sizes = _scaffold_groups(store)
    group_starts = np.concatenate(([0], np.cumsum(group_sizes)))[:-1]
    lim = int(group_sizes.max()) + 1  # shared radix for the pair-order key

    small = group_sizes <= max_scaffold
    dev_groups = np.nonzero(small & (group_sizes >= 2))[0]
    host_groups = np.nonzero(~small)[0]

    all_ri: list[np.ndarray] = []
    all_ro: list[np.ndarray] = []
    all_s: list[np.ndarray] = []
    all_e: list[np.ndarray] = []
    pair_rank: list[np.ndarray] = []  # global order key for re-merge

    if len(dev_groups):
        K = 1 << int(max(int(group_sizes[dev_groups].max()) - 1, 0)).bit_length()
        G = len(dev_groups)
        n_dev = 1 if mesh is None else mesh.size
        Gp = -(-G // n_dev) * n_dev  # pad the scaffold count to a mesh multiple

        ist = np.zeros((Gp, K), dtype=np.int32)
        ien = np.full((Gp, K), -1, dtype=np.int32)
        valid = np.zeros((Gp, K), dtype=bool)
        for slot, g in enumerate(dev_groups):
            sz = int(group_sizes[g])
            rows = order[group_starts[g] : group_starts[g] + sz]
            ist[slot, :sz] = store.illu_start[rows]
            ien[slot, :sz] = store.illu_end[rows]
            valid[slot, :sz] = True

        tables = tuple(torch.from_numpy(a) for a in (ist, ien, valid))
        if mesh is None:
            shards = [scaffold_pairs_device(*(t.to(dev) for t in tables), th_overlap)]
        else:
            shards = run_sharded(scaffold_pairs_device, mesh, tables, th_overlap=th_overlap)
        kept = []
        for first_slot, (ov_s, ov_e, keep) in zip(range(0, Gp, Gp // len(shards)), shards):
            # torch.nonzero is row-major, the (g, j, i) order of np.nonzero
            slot_t, j_t, i_t = torch.nonzero(keep).unbind(1)
            kept.append((slot_t + first_slot, j_t, i_t, ov_s[slot_t, j_t, i_t],
                         ov_e[slot_t, j_t, i_t]))
        slot_idx, j_idx, i_idx, s_np, e_np = (
            np.concatenate([k[f].cpu().numpy() for k in kept]) for f in range(5))

        g_idx = dev_groups[slot_idx]
        base = group_starts[g_idx]
        all_ri.append(order[base + i_idx])
        all_ro.append(order[base + j_idx])
        all_s.append(s_np)
        all_e.append(e_np)
        # global pair order = (group, outer, inner)
        pair_rank.append(
            (g_idx.astype(np.int64) * lim + j_idx) * lim + i_idx)

    if len(host_groups):
        sizes_h = group_sizes[host_groups]
        inner, outer = _pair_indices(sizes_h)
        starts_h = np.concatenate(([0], np.cumsum(sizes_h)))[:-1]
        # map local (within host subset) positions back to global rows
        pos_of = np.repeat(group_starts[host_groups] - starts_h,
                           sizes_h * (sizes_h - 1) // 2)
        ri = order[pos_of + inner]
        ro = order[pos_of + outer]
        ov_start = np.maximum(store.illu_start[ro], store.illu_start[ri])
        ov_end = np.minimum(store.illu_end[ro], store.illu_end[ri])
        kp = (ov_start <= ov_end) & ((ov_end - ov_start) > th_overlap)
        n_pairs_h = sizes_h * (sizes_h - 1) // 2
        grp_of_pair = np.repeat(host_groups, n_pairs_h)
        local_base = np.repeat(starts_h, n_pairs_h)
        rank = ((grp_of_pair.astype(np.int64) * lim + (outer - local_base))
                * lim + (inner - local_base))
        all_ri.append(ri[kp])
        all_ro.append(ro[kp])
        all_s.append(ov_start[kp])
        all_e.append(ov_end[kp])
        pair_rank.append(rank[kp])

    if not all_ri:
        return _empty_edges()

    ri = np.concatenate(all_ri)
    ro = np.concatenate(all_ro)
    ov_start = np.concatenate(all_s)
    ov_end = np.concatenate(all_e)
    rank = np.concatenate(pair_rank)
    # restore the reference's global (scaffold, outer, inner) pair order
    merge = np.argsort(rank, kind="stable")
    return _finish_edges(
        store, ri[merge], ro[merge], ov_start[merge], ov_end[merge])
