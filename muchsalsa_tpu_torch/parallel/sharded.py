"""The sharded compute steps of the port: one launch per shard of a mesh.

Port of ``muchsalsa_tpu/parallel/sharded.py``, whose six steps are
``shard_map`` over existing functions.  Here each is a split, one call per
shard on its device, and a merge:

- the leading axis is cut into ``mesh.size`` contiguous ranges in shard
  order (``P(axis)``); one that does not divide raises, as ``shard_map``
  does;
- replicated inputs (``P()``: an index, the join tables) are copied once to
  each distinct device of the mesh and reused where a device repeats;
- every shard is launched before any result is read, and nothing here
  synchronises between shards;
- outputs come back concatenated in shard order on the mesh's first
  device, and the statistics are the per-shard partials summed on the host
  in shard order (the ``psum``), in the JAX step's dtype.

``sharded_chain_dp`` runs the chaining kernel ``chain_dp`` (``csrc/
chain_scan.cu``) and ``sharded_myers`` the exact Myers kernel
``myers_edit_distance`` (``csrc/myers_full.cu``) once per shard on a card;
on the CPU both run their plain versions.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
from muchsalsa_tpu_torch.ops.mapping_torch import (
    map_reads_device, map_reads_device_v2, map_reads_device_v2_packed)
from muchsalsa_tpu_torch.ops.minimizer_torch import anchor_counts
from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
from muchsalsa_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def shard_ranges(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """The mesh's contiguous ranges of a leading axis of length ``n``."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over a mesh of {mesh.size} "
                         f"along {mesh.axis!r}")
    step = n // mesh.size
    return [(i * step, (i + 1) * step) for i in range(mesh.size)]


def replicate(tensors: Sequence[Tensor], mesh: Mesh) -> dict[torch.device, tuple[Tensor, ...]]:
    """``tensors`` on each distinct device of the mesh, one copy a device
    (none where a tensor is there already)."""
    return {dev: tuple(t.to(dev, non_blocking=True) for t in tensors)
            for dev in dict.fromkeys(mesh.devices)}


def run_sharded(fn: Callable, mesh: Mesh, sharded: Sequence[Tensor],
                replicated: Sequence[Tensor] = (), **kwargs) -> list:
    """``fn(*shard, *replicas, **kwargs)`` on each shard's device, in shard
    order: ``sharded`` cut along their leading axis, ``replicated`` whole.
    Returns the per-shard results; every shard is launched before the
    caller reads any."""
    ranges = shard_ranges(sharded[0].shape[0], mesh)
    if any(t.shape[0] != sharded[0].shape[0] for t in sharded):
        raise ValueError(f"sharded inputs differ in their leading axis: "
                         f"{[tuple(t.shape) for t in sharded]}")
    reps = replicate(replicated, mesh)
    return [fn(*(t[lo:hi].to(dev, non_blocking=True) for t in sharded), *reps[dev], **kwargs)
            for dev, (lo, hi) in zip(mesh.devices, ranges)]


def gather(parts: Sequence[Tensor], mesh: Mesh) -> Tensor:
    """Per-shard tensors concatenated in shard order on the first device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def psum(parts: Sequence[Tensor]) -> Tensor:
    """Per-shard statistics summed on the host in shard order."""
    total = parts[0].cpu()
    for p in parts[1:]:
        total = total + p.cpu()
    return total


def _hit_stats(out: dict) -> Tensor:
    """[reads with a hit, hits] of one shard's hit table, float32."""
    n = out["n_hits"]
    return torch.stack([(n > 0).sum(), n.sum()]).to(torch.float32)


def _merge_hits(parts: list[dict], mesh: Mesh) -> tuple[dict, Tensor]:
    out = {key: gather([p[key] for p in parts], mesh) for key in parts[0]}
    return out, psum([_hit_stats(p) for p in parts])


def sharded_chain_dp(fields: Tensor, flags: Tensor, offsets: Tensor, K: int,
                     wiggle_room: int, mesh: Mesh) -> tuple[Tensor, Tensor, Tensor]:
    """``chain_dp`` of a packed batch (``state.py``) over the mesh.

    The B problems are cut into ``mesh.size`` equal ranges; each shard's
    anchors go to its device in one copy and ``chain_dp`` runs there.
    Returns (scores (B, K) float64, bps (B, K) int32, stats): ``stats`` is
    the float64 pair [problems with a valid anchor, the sum over problems of
    the best valid score (0 for a problem without one)], as
    ``sharded.py:45-51`` computes it.
    """
    off = offsets.cpu()
    parts, partials = [], []
    for dev, (lo, hi) in zip(mesh.devices, shard_ranges(off.shape[0] - 1, mesh)):
        a0, a1 = int(off[lo]), int(off[hi])
        shard_off = (off[lo : hi + 1] - a0).to(dev, non_blocking=True)
        scores, bps = chain_dp(fields[:, a0:a1].contiguous().to(dev, non_blocking=True),
                               flags[a0:a1].to(dev, non_blocking=True), shard_off, K,
                               wiggle_room)
        valid = torch.arange(K, device=dev) < (shard_off[1:] - shard_off[:-1])[:, None]
        best = torch.where(valid, scores, 0.0).amax(dim=1)
        parts.append((scores, bps))
        partials.append(torch.stack([valid.any(dim=1).sum().to(torch.float64), best.sum()]))
    return (gather([s for s, _ in parts], mesh), gather([b for _, b in parts], mesh),
            psum(partials))


def sharded_myers(q_codes: Tensor, q_lens: Tensor, t_codes: Tensor, t_lens: Tensor,
                  mesh: Mesh) -> tuple[Tensor, Tensor]:
    """``myers_edit_distance`` with the problems cut over the mesh.  Returns
    ((P,) int32 distances, the float32 sum of the distances)."""
    parts = run_sharded(myers_edit_distance, mesh, (q_codes, q_lens, t_codes, t_lens))
    return gather(parts, mesh), psum([d.sum().to(torch.float32) for d in parts])


def sharded_anchor_counts(codes: Tensor, lens: Tensor, index_hashes: Tensor, mesh: Mesh,
                          k: int = 15, w: int = 5) -> tuple[Tensor, Tensor]:
    """``anchor_counts`` with the reads cut over the mesh and the sorted
    index replicated.  Returns ((R,) int32 counts, float32 [reads with an
    anchor, anchors])."""
    parts = run_sharded(anchor_counts, mesh, (codes, lens), (index_hashes,), k=k, w=w)
    return gather(parts, mesh), psum(
        [torch.stack([(c > 0).sum(), c.sum()]).to(torch.float32) for c in parts])


def sharded_map_reads(codes: Tensor, lens: Tensor, index_arrays: tuple, mesh: Mesh,
                      **kwargs) -> tuple[dict, Tensor]:
    """``map_reads_device`` (the v1 join) with the reads cut over the mesh
    and ``index_arrays`` (the index's five arrays, then optionally the
    bitmap and the rank table) replicated.  Returns the hit dict and the
    float32 [reads with a hit, hits]."""
    return _merge_hits(run_sharded(map_reads_device, mesh, (codes, lens), index_arrays,
                                   **kwargs), mesh)


def sharded_map_reads_v2(codes: Tensor, lens: Tensor, tables, mesh: Mesh,
                         **kwargs) -> tuple[dict, Tensor]:
    """``map_reads_device_v2`` with the reads cut over the mesh and the
    ``DeviceTables`` replicated; returns as ``sharded_map_reads``."""
    return _merge_hits(run_sharded(map_reads_device_v2, mesh, (codes, lens), tables,
                                   **kwargs), mesh)


def sharded_map_reads_v2_packed(packed: Tensor, nmask: Tensor, lens: Tensor, tables,
                                mesh: Mesh, **kwargs) -> tuple[dict, Tensor]:
    """``sharded_map_reads_v2`` over 2-bit packed codes: the words shard
    like the reads they encode and unpack on each shard's device."""
    return _merge_hits(run_sharded(map_reads_device_v2_packed, mesh, (packed, nmask, lens),
                                   tables, **kwargs), mesh)
