"""The mapper on a torch device: device mapping, alignment refinement and
``map_all``.

Port of ``muchsalsa_tpu/pipeline/mapper.py::map_all_with_device`` (:454-847),
``refine_mappings`` (:854-927) and ``map_all`` (:343-397).  The host mapper
(``MinimizerIndex``, ``map_batch``, ``map_read``, the fork pool, the length
buckets and their budgets, ``write_paf``) is the port's copy in
``pipeline/mapper.py``.

Device mapping runs the six v2 stages of ``ops.mapping_torch`` per batch of
one length bucket and pulls each batch's hits in the dense layout.  Reads
that break a static budget take a second, wider tier on the device or go
to the host mapper (one ``map_batch`` call at the end); either way the
result equals ``map_read``'s.  Where the index breaks the v2 packing
bounds, each batch goes through the v1 join (``map_reads_device``) instead,
and the reads it flags go to the host mapper.  Where more than one device of
the requested type is visible, v2 batches shard over all of them
(``parallel/sharded.py::sharded_map_reads_v2_packed``, the tables
replicated) and come back in the padded layout, with no tier 2: reads past
a budget go to the host mapper.
On one CUDA device each v2 batch's six stages replay a CUDA graph captured
from them, one graph a batch shape (``_StageGraphs``), so the host launches
one graph where it would launch a few hundred small ops; a shape's first
batch launches them op by op.
Refinement builds one padded batch of every mapped region on the device
from the regions' coordinates into the raw bytes of the reads and unitigs
(``ops.align_torch.gather_problems``), runs one edit-distance kernel over
it and writes ``max(len q, len t) - d`` back into each mapping's
``matches``.

Each piece of that work runs in a span of ``utils/timing.py::SPANS``
(``StageTimer.stage``): per call, per batch or per phase, never per read.
The spans of batches go ``map.read_pack`` (the host packing of a batch and
its copy to the device), then ``map.dispatch`` (the stage launches and the
copy back queued), then ``map.collect`` around ``map.wait`` (the host
blocked on the copy back) and ``map.repull`` (the dense re-pull); tier 2's
batches lie inside ``map.tier2``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from muchsalsa_tpu_torch import native
from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.pipeline.mapper import (
    _POOL_STATE, Mapping, MinimizerIndex, _pool_map_one, device_bucket_budgets,
    device_bucket_len, map_batch, map_read, write_paf)
from muchsalsa_tpu_torch.utils.seq import encode_2bit
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.ops.align_torch import (
    GatherArgs, banded_edit_distance, gather_problems, slice_bounds)
from muchsalsa_tpu_torch.ops.mapping_torch import (
    HIT_FIELDS, anchors_to_hits_device_dense, anchors_to_hits_device_packed, build_device_tables,
    build_join_tables, compact_candidates_device_v2, expand_anchors_device_v2, map_reads_device,
    pack_codes, pack_hits, probe_candidates_device_v2, select_compact_device_v2,
    sketch_device_packed, u32_tensor, unpack_hits)
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.parallel.sharded import sharded_map_reads_v2_packed
from muchsalsa_tpu_torch.utils.timing import StageTimer

__all__ = [
    "DEVICE_MAP_STATS", "DEVICE_MAP_STATS_CUM", "MinimizerIndex", "SequenceStore", "map_all",
    "map_all_with_device", "map_batch", "refine_mappings", "write_paf"]

# the last map_all_with_device call's counters (device, v2, total_reads,
# overflow_reads, tier2_reads, dense_repulls, host_map_s: the map.host span,
# the host mapper's call on the reads sent there; on the v2 path the tier
# routing: tier2_width_reads and tier2_hot_reads, the reads the first pass
# deferred with a width overflow and with an entry count past its cap (a
# read may count in both), and tier2_host_reads, the reads tier 2 sent on
# to the host, counted in overflow_reads too; on the v1 path index_entries
# and v1_setup_s, the map.v1_tables span), and the sums of the counting
# keys over every call since the caller last cleared it
DEVICE_MAP_STATS: dict = {}
DEVICE_MAP_STATS_CUM: dict = {}
# the counting keys: the reads' routes, which the JAX package's mapper counts
# too, then the v2 batches' launches: graph_batches replayed from a captured
# CUDA graph, eager_batches launched op by op, graph_captures the graphs
# captured (all three 0 on the v1 path)
_COUNT_KEYS = ("total_reads", "overflow_reads", "tier2_reads", "dense_repulls")
_CUM_KEYS = _COUNT_KEYS + ("graph_batches", "eager_batches", "graph_captures")
# the per-store cache of packed read batches on a device; its own attribute,
# so a store mapped by both packages never hands one package's arrays to the other
_CACHE_ATTR = "_torch_dev_batch_cache"


def _batch_cache(reads: SequenceStore, dev: torch.device) -> dict:
    """The LRU dict of packed batches that ``reads`` keeps for ``dev``,
    emptied when the store has changed since it was filled."""
    caches = getattr(reads, _CACHE_ATTR, None)
    if caches is None:
        caches = {}
        setattr(reads, _CACHE_ATTR, caches)
    version = getattr(reads, "version", 0)
    entry = caches.get(str(dev))
    if entry is None or entry[0] != version:
        entry = caches[str(dev)] = (version, {})
    return entry[1]


def _graph_key(tables, hash_takes, L, budgets, mph, batch_reads, hit_budget, cfg,
               max_hits) -> tuple:
    """Everything that fixes the shapes and constants of a v2 batch's six
    stages: the key of the graph captured from them."""
    return (L, tuple(budgets), mph, hash_takes, batch_reads, hit_budget,
            tuple(tuple(t.shape) for t in tables),
            cfg.k, cfg.w, cfg.bandwidth, cfg.min_anchor_count, cfg.min_chain_score, max_hits)


class _StageGraphs:
    """One call's v2 stages on one CUDA device as a CUDA graph of the
    current ``_graph_key``, captured from them.

    A key's first batch launches the stages op by op, which loads their
    kernels; its second captures them and replays the graph, and later ones
    copy their inputs into the graph's own and replay.  A batch of another
    key drops the graph: one key's batches come one after another (the
    buckets go in order of length, tier 2 after tier 1), so a key that
    serves one batch captures nothing.  The graph reads the call's tables
    and lives no longer than the call.  Its memory comes from the device's
    graph pool (``_graph_memory``): what the stages hold counts as allocated
    while they are captured, as it does while they run op by op, and the
    next capture reuses the blocks the last graph leaves in the pool.  The
    caller queues each replay's output copy right after the replay, before
    a later one can write that memory.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.pool, self.stream = _graph_memory(device)
        self.key = None
        self.graph = None   # (inputs, graph, output) of self.key once captured

    def run(self, key, batch, stages) -> torch.Tensor:
        """``stages(*batch)``, replayed from the graph of ``key`` from the
        key's second batch on."""
        if key != self.key:
            self.key, self.graph = key, None
            DEVICE_MAP_STATS["eager_batches"] += 1
            return stages(*batch)
        with torch.cuda.device(self.device):
            if self.graph is None:
                inputs = tuple(t.clone() for t in batch)
                self.graph = (inputs, *self._capture(inputs, stages))
                DEVICE_MAP_STATS["graph_captures"] += 1
            else:
                for dst, src in zip(self.graph[0], batch):
                    dst.copy_(src)
            _inputs, graph, out = self.graph
            graph.replay()
        DEVICE_MAP_STATS["graph_batches"] += 1
        return out

    def _capture(self, inputs, stages):
        # capture_begin itself and not ``torch.cuda.graph``, which empties
        # the device's and the pinned host memory's caches first, a cost in
        # the middle of a call
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = stages(*inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        return graph, out


# each CUDA device's memory pool for the stages' graphs, the stream they are
# captured on and a graph of one fill that holds the pool, kept for the
# process: the blocks a capture takes, tied to that stream, go back to the
# pool when its graph is dropped, and the next capture, in this call or a
# later one, takes them again (a pool whose last graph goes is freed, and no
# capture can share it after)
_GRAPH_MEMORY: dict[str, tuple] = {}


def _graph_memory(dev: torch.device) -> tuple:
    """(memory pool, capture stream) of the CUDA device ``dev``."""
    mem = _GRAPH_MEMORY.get(str(dev))
    if mem is None:
        with torch.cuda.device(dev):
            pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
            keeper = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                keeper.capture_begin(pool=pool, capture_error_mode="thread_local")
                torch.zeros(1, device=dev)
                keeper.capture_end()
        mem = _GRAPH_MEMORY[str(dev)] = (pool, stream, keeper)
    return mem[:2]


def _mappings_of_rows(rows) -> list[Mapping]:
    """Mappings of hit rows ``[HIT_FIELDS]``."""
    return [Mapping(unitig=int(r[0]), strand=bool(r[1]), q_start=int(r[2]), q_end=int(r[3]),
                    t_start=int(r[4]), t_end=int(r[5]), matches=int(r[6]),
                    n_anchors=int(r[7]))
            for r in rows]


def map_all_with_device(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    batch_reads: int = 256,
    max_pos: int = 2048,
    max_per_hit: int = 4,
    max_hits: int = 64,
    hit_budget: int | None = None,
    prebuilt=None,
    device: str | torch.device = "cuda",
    timer: StageTimer | None = None,
) -> list[tuple[int, list[Mapping]]]:
    """Map every read on ``device``; the result equals per-read
    ``map_read``.

    Reads go in length buckets (``device_bucket_len``) of ``batch_reads``
    rows with per-bucket budgets (``device_bucket_budgets``).  A read whose
    only violation is a minimizer with more than ``max_per_hit`` entries,
    or whose widths tier 2 can grow, is mapped again on the device with the
    expansion cap ``MS_TPU_MAP_TIER2`` (default 16, at most 30; 0 turns it
    off) and twice the widths; every other violating read is mapped on the
    host.  A batch with more hits than ``hit_budget`` (default 16 per row)
    is pulled again in the padded layout.  ``prebuilt`` is the
    ``build_device_tables`` result for ``index`` on ``device``.

    Packed read batches stay on the device in a cache on the store (LRU,
    ``MS_TPU_DEV_CACHE_MB`` MiB, default 2048), so later calls on the same
    store reuse them; tier-2 batches depend on the index and never cache.

    Where the index breaks the v2 packing bounds (or ``max_per_hit`` >= 31),
    the v1 join maps every batch on the device (``_map_v1``) and the stats
    say ``v2=False``; it has no tier 2, no dense pull and no batch cache.

    With the v2 tables and more than one visible device of ``device``'s
    type (``parallel.mesh.local_mesh``), ``batch_reads`` rounds up to a
    multiple of their count D and each batch shards over them, the padded
    layout coming back; reads past a budget go to the host (no tier 2, no
    dense pull).  The stats say ``n_devices=D`` and ``meshed=True``.

    On one CUDA device the v2 batches replay a CUDA graph captured from
    the six stages (``_StageGraphs``), one a batch shape: a shape's first
    batch launches op by op, its second captures the graph.  The CPU, the
    mesh and the v1 join launch op by op.
    Counters go to ``DEVICE_MAP_STATS`` and ``DEVICE_MAP_STATS_CUM``, the
    spans to ``timer`` (a new one when none is given).
    """
    dev = resolve_device(device)
    timer = timer or StageTimer(verbose=False)
    items = list(reads.items())
    if not items:
        return []
    built = prebuilt
    if built is None and max_per_hit < 31:  # v2 count-saturation bound
        with timer.stage("map.v2_tables"):
            built = build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                        index.entry_pos, index.entry_strand, device=dev)
    attached = mesh_mod.local_mesh(dev)
    mesh = attached if built is not None else None  # the v1 join runs unsharded
    if mesh is not None:
        # round the batch up so that it shards evenly: the pad rows have
        # length 0, so no hits and no cost
        batch_reads = -(-batch_reads // mesh.size) * mesh.size
    DEVICE_MAP_STATS.update(
        device=str(dev), n_devices=1 if attached is None else attached.size,
        meshed=mesh is not None, batch_reads=batch_reads, v2=built is not None,
        total_reads=len(items), overflow_reads=0, dense_repulls=0, tier2_reads=0,
        tier2_width_reads=0, tier2_hot_reads=0, tier2_host_reads=0, host_map_s=0.0,
        graph_batches=0, eager_batches=0, graph_captures=0)
    graphs = None
    if built is not None and mesh is None and dev.type == "cuda":
        graphs = _StageGraphs(dev)
    results: dict[int, list[Mapping]] = {}
    if built is None:
        _map_v1(index, items, cfg, dev, results, batch_reads, max_pos, max_per_hit, max_hits,
                timer)
    else:
        _map_v2(index, items, cfg, built, dev, reads, results, batch_reads, max_pos,
                max_per_hit, max_hits, hit_budget, mesh, graphs, timer)
    for k2 in _CUM_KEYS:
        DEVICE_MAP_STATS_CUM[k2] = DEVICE_MAP_STATS_CUM.get(k2, 0) + DEVICE_MAP_STATS[k2]
    return [(rid, results[rid]) for rid, _ in items]


def _map_on_host(index, items, cfg, results, timer) -> None:
    """Map ``items`` ((read id, sequence) pairs) with the host mapper into
    ``results``: one multithreaded ``map_batch`` call where the native
    library serves it (identical to per-read ``map_read``), else
    ``map_read`` a read."""
    if not items:
        return
    with timer.stage("map.host") as span:
        store = SequenceStore()
        for rid, seq in items:
            store.add(str(rid), seq)
        per = map_batch(index, store, cfg)
        if per is None:
            for rid, seq in items:
                results[rid] = map_read(index, seq, cfg)
        else:
            for (rid, _seq), (_sid, maps) in zip(items, per):
                results[rid] = maps
    DEVICE_MAP_STATS["host_map_s"] = span.seconds


def _length_buckets(items) -> list[tuple[int, list[tuple[int, bytes]]]]:
    """``items`` grouped by ``device_bucket_len``, shortest bucket first."""
    buckets: dict[int, list[tuple[int, bytes]]] = {}
    for rid, seq in items:
        buckets.setdefault(device_bucket_len(len(seq)), []).append((rid, seq))
    return sorted(buckets.items())


def _copy_to_host(t: torch.Tensor):
    """Start copying ``t`` to the host; returns (host tensor, its ready
    event or None), so the host can collect it while the device runs on."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    return host, ready


def _pipelined(batches, dispatch, collect, timer) -> None:
    """``dispatch`` each batch (a tuple of its arguments) and ``collect``
    what the one before it queued, so the host collects a batch while the
    device runs the next; each collect is a ``map.collect`` span."""
    pending = None
    for batch in batches:
        nxt = dispatch(*batch)
        if pending is not None:
            with timer.stage("map.collect"):
                collect(pending)
        pending = nxt
    if pending is not None:
        with timer.stage("map.collect"):
            collect(pending)


def _collect_packed(pending, max_hits, results, to_host, timer) -> None:
    """A pending packed pull (chunk, ``pack_hits`` tensor on the host, its
    ready event) into ``results`` once the copy has landed."""
    chunk, flat, ready = pending
    with timer.stage("map.wait"):
        if ready is not None:
            ready.synchronize()
    _collect_padded(chunk, unpack_hits(flat, max_hits), results, to_host)


def _collect_padded(chunk, out, results, to_host) -> None:
    """The padded hits of one batch (``unpack_hits``'s dict) into
    ``results``; flagged reads are counted and queued in ``to_host``."""
    rows = np.stack([out[f] for f in HIT_FIELDS], axis=-1)  # (R, max_hits, 8)
    for i, (rid, seq) in enumerate(chunk):
        if out["overflow"][i]:
            DEVICE_MAP_STATS["overflow_reads"] += 1
            to_host.append((rid, seq))
            continue
        results[rid] = _mappings_of_rows(rows[i, : int(out["n_hits"][i])])


def _map_v1(index, items, cfg, dev, results, batch_reads, max_pos, max_per_hit, max_hits,
            timer):
    """The v1 pass of ``map_all_with_device``, for an index that the v2
    tables refuse: the join tables and the index's five arrays go to
    ``dev`` once, each batch of a length bucket crosses as (R, L) uint8
    codes in one copy and comes back as one packed tensor; the reads it
    flags are mapped on the host at the end, in one call."""
    E = int(index.offsets[-1])
    if E >= 2**31:
        raise ValueError(f"the v1 join addresses entries with int32 offsets: {E} entries")
    with timer.stage("map.v1_tables") as span:
        bitmap, rank, rounds = build_join_tables(index.hashes, device=dev)
        idx_dev = (u32_tensor(index.hashes, dev),
                   torch.from_numpy(index.offsets.astype(np.int32)).to(dev),
                   torch.from_numpy(index.entry_unitig).to(dev),
                   torch.from_numpy(index.entry_pos).to(dev),
                   torch.from_numpy(index.entry_strand).to(dev))
    DEVICE_MAP_STATS.update(index_entries=E, v1_setup_s=span.seconds)
    pin = dev.type == "cuda"
    to_host: list[tuple[int, bytes]] = []

    def dispatch(chunk, L):
        with timer.stage("map.read_pack"):
            codes = torch.full((batch_reads, L), 4, dtype=torch.uint8, pin_memory=pin)
            lens = torch.zeros(batch_reads, dtype=torch.int32, pin_memory=pin)
            codes_np, lens_np = codes.numpy(), lens.numpy()
            for i, (_rid, seq) in enumerate(chunk):
                c = encode_2bit(seq)
                codes_np[i, : len(c)] = c
                lens_np[i] = len(c)
            codes_d, lens_d = codes.to(dev, non_blocking=True), lens.to(dev, non_blocking=True)
        with timer.stage("map.dispatch"):
            _sel, pos_L, trim_L = device_bucket_budgets(L, cfg.k, max_pos, max_per_hit)
            out = map_reads_device(
                codes_d, lens_d, *idx_dev, bitmap, rank, k=cfg.k, w=cfg.w,
                bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                min_chain_score=cfg.min_chain_score, max_pos=pos_L, max_per_hit=max_per_hit,
                max_hits=max_hits, join_rounds=rounds, trim=trim_L)
            return chunk, *_copy_to_host(pack_hits(out))

    _pipelined(((members[s : s + batch_reads], L)
                for L, members in _length_buckets(items)
                for s in range(0, len(members), batch_reads)), dispatch,
               lambda pending: _collect_packed(pending, max_hits, results, to_host, timer),
               timer)
    _map_on_host(index, to_host, cfg, results, timer)


def _map_v2(index, items, cfg, built, dev, reads, results, batch_reads, max_pos, max_per_hit,
            max_hits, hit_budget, mesh, graphs, timer):
    """The v2 pass of ``map_all_with_device``, sharded over ``mesh`` when
    one is given, each batch replayed from ``graphs`` when they are given:
    fills ``results``; the reads that leave the device are mapped on the
    host at the end, in one call."""
    tables, hash_takes = built
    if hit_budget is None:
        hit_budget = 16 * batch_reads
    # the dense tail clamps identically: a budget above R*max_hits can
    # never be filled
    hit_budget = min(hit_budget, batch_reads * max_hits)
    tail_kw = dict(k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                   min_chain_score=cfg.min_chain_score, max_hits=max_hits)

    to_host: list[tuple[int, bytes]] = []
    dev_cache = _batch_cache(reads, dev)
    cache_cap = int(os.environ.get("MS_TPU_DEV_CACHE_MB", "2048")) << 20

    def cache_put(key, tensors):
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if nbytes > cache_cap:
            return
        used = sum(sz for _v, sz in dev_cache.values())
        while dev_cache and used + nbytes > cache_cap:
            _k, (_v, sz) = next(iter(dev_cache.items()))
            del dev_cache[_k]
            used -= sz
        dev_cache[key] = (tensors, nbytes)

    def packed_batch(chunk, L, s, cache=True):
        # tier-2 batches never cache: which reads they hold depends on the
        # index, so a positional key would alias them across calls
        key = (L, s, batch_reads)
        if cache and key in dev_cache:
            dev_cache[key] = dev_cache.pop(key)  # LRU: move to the back
            return dev_cache[key][0]
        with timer.stage("map.read_pack"):
            seqs = [seq for _rid, seq in chunk]
            built_np = (native.pack_reads_2bit(seqs, L, n_rows=batch_reads)
                        if native.available() else None)
            if built_np is not None:
                packed, nmask, lens = built_np
                tensors = (u32_tensor(packed, dev), u32_tensor(nmask, dev))
            else:
                codes = np.full((batch_reads, L), 4, dtype=np.uint8)
                lens = np.zeros(batch_reads, dtype=np.int32)
                for i, seq in enumerate(seqs):
                    c = encode_2bit(seq)
                    codes[i, : len(c)] = c
                    lens[i] = len(c)
                tensors = pack_codes(codes, device=dev)
            tensors = (*tensors, torch.from_numpy(lens).to(dev))
        if cache:
            cache_put(key, tensors)
        return tensors

    batches = ((members[s : s + batch_reads], L, s)
               for L, members in _length_buckets(items)
               for s in range(0, len(members), batch_reads))
    if mesh is not None:
        def dispatch_meshed(chunk, L, s):
            """One batch sharded over the mesh; returns the pending padded
            pull (chunk, hits on the host, its ready event)."""
            batch = packed_batch(chunk, L, s)
            with timer.stage("map.dispatch"):
                sel_L, pos_L, trim_L = device_bucket_budgets(L, cfg.k, max_pos, max_per_hit)
                out, _stats = sharded_map_reads_v2_packed(
                    *batch, tables, mesh, w=cfg.w, max_sel=sel_L, max_pos=pos_L,
                    max_per_hit=max_per_hit, hash_takes=hash_takes, trim=trim_L, **tail_kw)
                DEVICE_MAP_STATS["eager_batches"] += 1
                return chunk, *_copy_to_host(pack_hits(out))

        with timer.stage("map.tier1"):
            _pipelined(batches, dispatch_meshed,
                       lambda pending: _collect_packed(pending, max_hits, results, to_host,
                                                       timer),
                       timer)
        _map_on_host(index, to_host, cfg, results, timer)
        return

    def anchors_of(batch, budgets, mph):
        """Stages 1-5 of one batch (packed, nmask, lens): its anchors."""
        sel_L, pos_L, _trim = budgets
        selected, h, strand = sketch_device_packed(*batch, cfg.k, cfg.w)
        skey, h_s, n_sel = select_compact_device_v2(selected, h, strand, max_sel=sel_L)
        rpv, cand = probe_candidates_device_v2(skey, h_s, tables.rp)
        sel = compact_candidates_device_v2(skey, h_s, rpv, cand, n_sel, max_pos=pos_L)
        return expand_anchors_device_v2(*sel, tables.jrows, tables.erows, max_per_hit=mph,
                                        hash_takes=hash_takes)

    def dispatch(chunk, L, s, mph=max_per_hit, pos_cap=max_pos, cache_batch=True):
        """The six stages of one batch, queued on the device; returns the
        pending pull (chunk, flat hits on the host, its ready event, the
        batch, its budgets, cap)."""
        batch = packed_batch(chunk, L, s, cache=cache_batch)
        with timer.stage("map.dispatch"):
            budgets = device_bucket_budgets(L, cfg.k, pos_cap, mph)

            def stages(*inputs):
                return anchors_to_hits_device_dense(
                    *anchors_of(inputs, budgets, mph), trim=budgets[2], budget=hit_budget,
                    **tail_kw)

            if graphs is None:
                flat = stages(*batch)
                DEVICE_MAP_STATS["eager_batches"] += 1
            else:
                flat = graphs.run(_graph_key(tables, hash_takes, L, budgets, mph, batch_reads,
                                             hit_budget, cfg, max_hits), batch, stages)
            # start the copy back now, so the host collects this batch while
            # the device runs the next one (and before a replay reuses flat)
            return chunk, *_copy_to_host(flat), batch, budgets, mph

    # second-tier expansion cap (0 disables): reads whose violation a
    # wider cap or wider widths fix go through the device again
    tier2_mph = min(int(os.environ.get("MS_TPU_MAP_TIER2", "16")), 30)  # < 31: saturation
    if tier2_mph <= max_per_hit:
        tier2_mph = 0
    deferred: dict[int, list[tuple[int, bytes]]] = {}

    def collect(pending):
        chunk, flat, ready, batch, budgets, mph = pending
        with timer.stage("map.wait"):
            if ready is not None:
                ready.synchronize()
        flat_np = flat.numpy()
        R = batch_reads
        n_hits = flat_np[:R]
        width_ovf = flat_np[R : 2 * R] != 0
        max_ecnt = flat_np[2 * R : 3 * R]
        counts = np.minimum(n_hits, max_hits)
        if int(counts.sum()) > hit_budget:
            # over the dense budget: pull the padded tail instead (cap
            # violations fold into its overflow -> host), the batch's
            # anchors computed again, op by op
            DEVICE_MAP_STATS["dense_repulls"] += 1
            with timer.stage("map.repull"):
                out = unpack_hits(anchors_to_hits_device_packed(
                    *anchors_of(batch, budgets, mph), trim=budgets[2], per_hit_cap=mph,
                    **tail_kw), max_hits)
            _collect_padded(chunk, out, results, to_host)
            return
        dense_np = flat_np[3 * R :].reshape(hit_budget, 9)[:, 1:]  # drop flat_slot
        offs = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        for i, (rid, seq) in enumerate(chunk):
            if width_ovf[i] or max_ecnt[i] > mph:
                # tier 2 widens the cap and the candidate/anchor widths;
                # reads hot past its cap, or whose widths it cannot grow
                # with no cap violation to fix, go to the host
                Lb = device_bucket_len(len(seq))
                t2_budgets = device_bucket_budgets(Lb, cfg.k, 2 * max_pos, tier2_mph)
                t1_budgets = device_bucket_budgets(Lb, cfg.k, max_pos, mph)
                tier2_helps = max_ecnt[i] > mph or t2_budgets != t1_budgets
                if mph < tier2_mph and max_ecnt[i] <= tier2_mph and tier2_helps:
                    deferred.setdefault(Lb, []).append((rid, seq))
                    DEVICE_MAP_STATS["tier2_reads"] += 1
                    DEVICE_MAP_STATS["tier2_width_reads"] += int(width_ovf[i])
                    DEVICE_MAP_STATS["tier2_hot_reads"] += int(max_ecnt[i] > mph)
                else:
                    DEVICE_MAP_STATS["overflow_reads"] += 1
                    to_host.append((rid, seq))
                continue
            results[rid] = _mappings_of_rows(dense_np[offs[i] : offs[i + 1]])

    def run(batches, **kw):
        _pipelined(batches, lambda *batch: dispatch(*batch, **kw), collect, timer)

    with timer.stage("map.tier1"):
        run(batches)
    # tier 2 over the deferred reads: the wider cap and twice the widths;
    # its own violations go to the host (mph == tier2_mph there)
    if deferred:
        first_pass_host = len(to_host)
        with timer.stage("map.tier2"):
            run(((members[s : s + batch_reads], L, ("t2", L, j))
                 for L, members in sorted(deferred.items())
                 for j, s in enumerate(range(0, len(members), batch_reads))),
                mph=tier2_mph, pos_cap=2 * max_pos, cache_batch=False)
        DEVICE_MAP_STATS["tier2_host_reads"] = len(to_host) - first_pass_host
    _map_on_host(index, to_host, cfg, results, timer)


def problem_coordinates(
    mappings_per_read: list[tuple[int, list[Mapping]]],
    reads: SequenceStore,
    unitigs: SequenceStore,
    band: int | None = None,
) -> tuple[list[Mapping], GatherArgs]:
    """Each mapped region as coordinates into two blobs of raw bytes, the
    arguments of ``ops.align_torch.gather_problems`` but its widths.

    Returns ``(slots, GatherArgs)`` of numpy arrays: the unitigs named and the
    reads with mappings joined into one uint8 blob each, a problem's
    sequence at ``*_off`` (int64) in its blob, its range ``[*_start,
    *_start + *_len)`` as Python slicing gives ``seq[start:end]`` (int64
    start, int32 length) and ``t_minus`` where the read maps on the minus
    strand.  With ``band``, mappings whose lengths differ by ``band`` or
    more are left out, as the wavefront engine leaves them unrefined;
    ``slots`` are the mappings kept, in the problems' order.
    """
    slots = []
    rows = []
    read_ids = []
    for rid, maps in mappings_per_read:
        if not maps:
            continue
        r = len(read_ids)
        read_ids.append(rid)
        for m in maps:
            slots.append(m)
            rows.append((m.unitig, m.q_start, m.q_end, r, m.t_start, m.t_end, m.strand))
    coords = np.array(rows, dtype=np.int64).reshape(len(rows), 7).T
    uid, q_start, q_end, r, t_start, t_end, plus = coords
    uniq, u_of = np.unique(uid, return_inverse=True)
    useqs = [unitigs.sequence(int(u)) for u in uniq]
    rseqs = [reads.sequence(rid) for rid in read_ids]

    def blob(seqs):
        lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        return (np.frombuffer(bytearray().join(seqs), dtype=np.uint8),
                np.cumsum(lens) - lens, lens)

    q_blob, u_off, u_len = blob(useqs)
    t_blob, r_off, r_len = blob(rseqs)
    q_start, q_len = slice_bounds(q_start, q_end, u_len[u_of])
    t_start, t_len = slice_bounds(t_start, t_end, r_len[r])
    args = (u_off[u_of], q_start, q_len, r_off[r], t_start, t_len, plus == 0)
    if band is not None:
        keep = np.abs(q_len.astype(np.int64) - t_len) < band
        slots = [m for m, k in zip(slots, keep.tolist()) if k]
        args = tuple(x[keep] for x in args)
    q_off, q_start, q_len, t_off, t_start, t_len, t_minus = args
    return slots, GatherArgs(q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len,
                             t_minus)


def refine_mappings(
    mappings_per_read: list[tuple[int, list[Mapping]]],
    reads: SequenceStore,
    unitigs: SequenceStore,
    band: int = 256,
    use_pallas: bool | None = None,
    engine: str = "myers",
    device: str | torch.device = "cuda",
    stats: dict | None = None,
    timer: StageTimer | None = None,
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
    leave the mapping unrefined.

    The padded batch is built on ``device`` from coordinates
    (``problem_coordinates``, span ``refine.pairs``): the blobs and the
    coordinates go to the device (``refine.copy``) and
    ``ops.align_torch.gather_problems`` builds the batch (``refine.pad``;
    the kernel on ``cuda``, the plain version on ``cpu``).  ``stats``, when
    given, receives the batch shape, the packed tensors on the device, the
    problems the kernel built (``card_packed``: 0 on the CPU) and the walls
    of packing (``pack_s``: the three spans; ``refine.pad`` holds the
    gather's launch, not its device time), of the distance call
    (``distance_s``: the span ``refine.distance``, whose copy back is the
    first wait on the gather, then the edit-distance kernel) and of the
    whole refinement; the spans go to ``timer`` (a new one when none is
    given).

    ``mappings_per_read``: list of (read_id, [Mapping...]); mutated in place.
    """
    dev = resolve_device(device)
    timer = timer or StageTimer(verbose=False)
    banded = engine != "myers"
    t0 = time.perf_counter()
    with timer.stage("refine.pairs") as pairs_span:
        slots, coords = problem_coordinates(mappings_per_read, reads, unitigs,
                                            band if banded else None)
    if not slots:
        return
    M, N = int(coords.q_len.max()), int(coords.t_len.max())

    with timer.stage("refine.copy") as copy_span:
        on_dev = coords.to(dev)
    with timer.stage("refine.pad") as pad_span:
        launches = gather_problems.launches
        args = gather_problems(*on_dev, M, N)
        card_packed = len(slots) if gather_problems.launches > launches else 0
    with timer.stage("refine.distance") as distance_span:
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

    with timer.stage("refine.writeback"):
        spans = np.maximum(coords.q_len, coords.t_len)
        for m, span, d in zip(slots, spans.tolist(), dists.tolist()):
            if d >= 0:
                m.matches = span - d
    if stats is not None:
        stats.update(problems=len(slots), M=M, N=N, packed=args, card_packed=card_packed,
                     pack_s=pairs_span.seconds + pad_span.seconds + copy_span.seconds,
                     distance_s=distance_span.seconds, refine_s=time.perf_counter() - t0)


def map_all(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    unitig_names=None,
    read_names=None,
    unitigs: SequenceStore | None = None,
    processes: int | None = None,
    device: bool = True,
    torch_device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> list[str]:
    """Map every read; emit PAF lines (query = unitig, target = read).

    ``device=True`` (the default, as in the CLI and ``run_full_pipeline``)
    maps on ``torch_device`` (``map_all_with_device``); ``device=False``
    maps on the host.  With ``cfg.refine`` (and ``unitigs``
    provided), match counts are alignment-refined by ``refine_mappings`` on
    ``torch_device``.  The default ``cuda`` raises when there is no card;
    ``torch_device`` is not touched when neither runs.  ``processes`` > 1
    fans host mapping out over a fork-shared worker pool.  ``stats``, when
    given, receives the mapping wall, ``refine_mappings``' statistics and
    the call's span totals (``<span>_s`` seconds, ``<span>_n`` count;
    ``StageTimer.totals``).  Under ``MS_TPU_TRACE`` the totals are also one
    line on standard error.
    """
    uname = unitig_names or (lambda uid: f"u{uid}")
    rname = read_names or (lambda rid: f"r{rid}")

    if processes is None:
        processes = 1
    timer = StageTimer(verbose=False)
    t0 = time.perf_counter()
    if device:
        per_read = map_all_with_device(index, reads, cfg, device=torch_device, timer=timer)
    else:
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
                        device=torch_device, stats=stats, timer=timer)

    lines: list[str] = []
    with timer.stage("map.paf"):
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
    totals = timer.totals()
    if stats is not None:
        stats.update(totals)
    if os.environ.get("MS_TPU_TRACE"):
        print("[ms-tpu] map_all: " + ", ".join(
            f"{name} {totals[name + '_s']:.3f}s/{totals[name + '_n']}" for name in timer.stages),
            file=sys.stderr)
    return lines
