"""The mapper's alignment refinement on a torch device, and ``map_all``.

Port of ``muchsalsa_tpu/pipeline/mapper.py::refine_mappings`` (:854-927) and
``map_all`` (:343-397).  The host mapper (``MinimizerIndex``, ``map_batch``,
``map_read``, the fork pool and ``write_paf``) is imported from the JAX
package, which loads no JAX for it; only refinement and the PAF formatting
loop live here.  Refinement packs every mapped region into one batch
(``ops.align_torch.pack_problems``), runs one edit-distance kernel over it
on the given device and writes ``max(len q, len t) - d`` back into each
mapping's ``matches``.
"""

from __future__ import annotations

import time

import torch

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.pipeline.mapper import (
    _POOL_STATE, Mapping, MinimizerIndex, _pool_map_one, map_batch, map_read, write_paf)
from muchsalsa_tpu.utils.seq import reverse_complement
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.ops.align_torch import banded_edit_distance, pack_problems
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance

__all__ = [
    "MinimizerIndex", "SequenceStore", "map_all", "map_batch", "refine_mappings", "write_paf"]


def refine_mappings(
    mappings_per_read: list[tuple[int, list[Mapping]]],
    reads: SequenceStore,
    unitigs: SequenceStore,
    band: int = 256,
    use_pallas: bool | None = None,
    engine: str = "myers",
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> None:
    """Alignment-refined match counts (the reference's ``minimap2 -c
    --eqx`` stage): batch edit distance of every mapped region on ``device``
    and replace each mapping's heuristic ``matches`` with
    ``max(span) - edits``.

    ``engine``: "myers" (default: exact bit-parallel, no band guard) or
    "wavefront" (banded; mappings whose length difference reaches ``band``
    are left unrefined).  For "wavefront", ``use_pallas`` picks the banded
    Myers kernel (window ``max(band // 32, 2)`` words) over the Levenshtein
    wavefront; ``None`` means true on ``cuda`` and false on ``cpu``, as the
    JAX package means true on a TPU.  Distances of -1 (outside the band)
    leave the mapping unrefined.  ``stats``, when given, receives the batch
    shape, the packed tensors on the device and the walls of packing (pairs,
    codes and the copy to the device), of the distance call (kernel and the
    copy back) and of the whole refinement.

    ``mappings_per_read``: list of (read_id, [Mapping...]); mutated in place.
    """
    dev = resolve_device(device)
    banded = engine != "myers"
    t0 = time.perf_counter()
    pairs = []
    slots = []
    for rid, maps in mappings_per_read:
        read_seq = reads.sequence(rid)
        for m in maps:
            q = unitigs.sequence(m.unitig)[m.q_start : m.q_end]
            t = read_seq[m.t_start : m.t_end]
            if not m.strand:
                t = reverse_complement(t)
            if banded and abs(len(q) - len(t)) >= band:
                continue
            pairs.append((q, t))
            slots.append(m)
    if not pairs:
        return

    args = tuple(x.to(dev) for x in pack_problems(pairs))
    t1 = time.perf_counter()
    if not banded:
        dists = myers_edit_distance(*args)
    else:
        if use_pallas is None:
            use_pallas = dev.type == "cuda"
        if use_pallas:
            dists = myers_banded(*args, window_words=max(band // 32, 2))
        else:
            dists = banded_edit_distance(*args, band=band)
    dists = dists.cpu().numpy()
    t2 = time.perf_counter()

    for m, (q, t), d in zip(slots, pairs, dists):
        if d >= 0:
            m.matches = max(len(q), len(t)) - int(d)
    if stats is not None:
        stats.update(problems=len(pairs), M=args[0].shape[1], N=args[2].shape[1],
                     packed=args, pack_s=t1 - t0, distance_s=t2 - t1,
                     refine_s=time.perf_counter() - t0)


def map_all(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    unitig_names=None,
    read_names=None,
    unitigs: SequenceStore | None = None,
    processes: int | None = None,
    device: bool = False,
    refine_device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> list[str]:
    """Map every read; emit PAF lines (query = unitig, target = read).

    With ``cfg.refine`` (and ``unitigs`` provided), match counts are
    alignment-refined by ``refine_mappings`` on ``refine_device`` (default
    ``cuda``, which raises when there is no card).  ``processes`` > 1 fans
    reads out over a fork-shared worker pool.  Device mapping
    (``device=True``) is not ported yet and raises.  ``stats``, when given,
    receives the mapping wall and ``refine_mappings``' statistics.
    """
    if device:
        raise NotImplementedError(
            "device mapping is not ported to muchsalsa_tpu_torch yet "
            "(ROADMAP.md §1 item 6); map on the host with device=False")
    uname = unitig_names or (lambda uid: f"u{uid}")
    rname = read_names or (lambda rid: f"r{rid}")

    if processes is None:
        processes = 1
    t0 = time.perf_counter()
    per_read = map_batch(index, reads, cfg, threads=0 if processes <= 1 else processes)
    if per_read is None and processes > 1:
        import multiprocessing as mp

        _POOL_STATE["index"] = index
        _POOL_STATE["cfg"] = cfg
        ctx = mp.get_context("fork")
        with ctx.Pool(processes) as pool:
            per_read = pool.map(_pool_map_one, list(reads.items()), chunksize=64)
        _POOL_STATE.clear()
    elif per_read is None:
        per_read = [(rid, map_read(index, seq, cfg)) for rid, seq in reads.items()]
    if stats is not None:
        stats["map_s"] = time.perf_counter() - t0
    if cfg.refine and unitigs is not None:
        refine_mappings(per_read, reads, unitigs, band=cfg.refine_band,
                        device=refine_device, stats=stats)

    lines: list[str] = []
    for rid, maps in per_read:
        tlen = reads.length(rid)
        for m in maps:
            qlen = index.unitig_lengths[m.unitig]
            block = max(m.q_end - m.q_start, m.t_end - m.t_start)
            lines.append(
                f"{uname(m.unitig)}\t{qlen}\t{m.q_start}\t{m.q_end}\t"
                f"{'+' if m.strand else '-'}\t{rname(rid)}\t{tlen}\t"
                f"{m.t_start}\t{m.t_end}\t{m.matches}\t{block}\t60"
            )
    return lines
