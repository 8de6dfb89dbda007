"""The mapper on a torch device: device mapping, alignment refinement and
``map_all``.

Port of ``muchsalsa_tpu/pipeline/mapper.py::map_all_with_device`` (:454-847),
``refine_mappings`` (:854-927) and ``map_all`` (:343-397).  The host mapper
(``MinimizerIndex``, ``map_batch``, ``map_read``, the fork pool, the length
buckets and their budgets, ``write_paf``) is the port's copy in
``pipeline/mapper.py``.

Device mapping takes one of three routes, chosen once a call.  The v2 on
one device (``_dense_pass``) runs the six stages of ``ops.mapping_torch``
per batch of one length bucket and pulls each batch's hits in the dense
layout; reads that break a static budget take a second, wider tier on the
device or go to the host mapper (one ``map_batch`` call at the end), and
either way the result equals ``map_read``'s.  On a CUDA device each batch
replays a CUDA graph captured from its stages, one a batch shape
(``_StageGraphs``), so the host launches one graph where it would launch a
few hundred small ops.  Where the index breaks the v2 packing bounds, the
v1 join (``map_reads_device``) maps each batch; where more than one device
of the requested type is visible, v2 batches shard over all of them
(``parallel/sharded.py::sharded_map_reads_v2_packed``, the tables
replicated).  Both pull padded hits (``_padded_pass``) with no tier 2: the
reads they flag go to the host mapper.
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
from typing import NamedTuple

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
    HIT_FIELDS, anchors_device_v2, anchors_to_hits_device_dense, build_device_tables,
    build_join_tables, map_reads_device, map_reads_device_v2_packed, pack_codes, pack_hits,
    u32_tensor, unpack_codes, unpack_hits)
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.parallel.sharded import sharded_map_reads_v2_packed
from muchsalsa_tpu_torch.utils.timing import StageTimer

__all__ = [
    "DEVICE_MAP_STATS", "DEVICE_MAP_STATS_CUM", "MinimizerIndex", "SequenceStore", "map_all",
    "map_all_with_device", "map_batch", "refine_mappings", "write_paf"]

# the last map_all_with_device call's counters, cleared at its start (device,
# v2, total_reads, overflow_reads, tier2_reads, dense_repulls, host_map_s: the
# map.host span, the host mapper's call on the reads sent there; on the v2
# path the tier routing: tier2_width_reads and tier2_hot_reads, the reads the
# first pass deferred with a width overflow and with an entry count past its
# cap (a read may count in both), and tier2_host_reads, the reads tier 2 sent
# on to the host, counted in overflow_reads too; on the v1 path index_entries
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


class _Call(NamedTuple):
    """What every pass of one ``map_all_with_device`` call shares: its
    settings, the mappings found and the reads queued for the host mapper."""

    cfg: MapperConfig
    dev: torch.device
    batch_reads: int
    max_pos: int
    max_per_hit: int
    max_hits: int
    timer: StageTimer
    results: dict
    to_host: list

    def tail_kw(self) -> dict:
        """The chaining tail's keyword arguments."""
        cfg = self.cfg
        return dict(k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                    min_chain_score=cfg.min_chain_score, max_hits=self.max_hits)

    def v2_kw(self, hash_takes, budgets, mph) -> dict:
        """``map_reads_device_v2``'s keyword arguments for a batch of
        ``budgets`` (max_sel, max_pos, trim) and expansion cap ``mph``."""
        sel_L, pos_L, trim_L = budgets
        return dict(w=self.cfg.w, max_sel=sel_L, max_pos=pos_L, max_per_hit=mph,
                    hash_takes=hash_takes, trim=trim_L, **self.tail_kw())


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

    One route serves the call.  Where the index breaks the v2 packing
    bounds (or ``max_per_hit`` >= 31), the v1 join maps every batch and the
    stats say ``v2=False``.  With the v2 tables and D > 1 visible devices
    of ``device``'s type (``parallel.mesh.local_mesh``), each batch shards
    over them, ``batch_reads`` rounded up to a multiple of D; the stats say
    ``n_devices=D`` and ``meshed=True``.  Both pull padded hits
    (``_padded_pass``): no tier 2, no dense pull, and no batch cache for
    the v1 join.  Otherwise the v2 maps on one device (``_dense_pass``); on
    a CUDA device a batch shape's second batch captures the six stages as
    a CUDA graph (``_StageGraphs``) that later ones replay.
    ``DEVICE_MAP_STATS`` is cleared at each call's start and then holds the
    call's counters, ``DEVICE_MAP_STATS_CUM`` their sums; the spans go to
    ``timer`` (a new one when none is given).
    """
    DEVICE_MAP_STATS.clear()
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
    call = _Call(cfg, dev, batch_reads, max_pos, max_per_hit, max_hits, timer, {}, [])
    batches = _batches(_length_buckets(items), batch_reads)
    if built is None:
        _padded_pass(call, batches, *_v1_join(call, index))
    elif mesh is not None:
        tables, hash_takes = built

        def launch(batch, budgets):
            DEVICE_MAP_STATS["eager_batches"] += 1
            return sharded_map_reads_v2_packed(
                *batch, tables, mesh, **call.v2_kw(hash_takes, budgets, max_per_hit))[0]

        with timer.stage("map.tier1"):
            _padded_pass(call, batches, _v2_packer(call, reads), launch)
    else:
        _dense_pass(call, batches, _v2_packer(call, reads), built, hit_budget)
    _map_on_host(index, call)
    for k2 in _CUM_KEYS:
        DEVICE_MAP_STATS_CUM[k2] = DEVICE_MAP_STATS_CUM.get(k2, 0) + DEVICE_MAP_STATS[k2]
    return [(rid, call.results[rid]) for rid, _ in items]


def _map_on_host(index, call) -> None:
    """Map the reads the call queued for the host into its results: one
    multithreaded ``map_batch`` call where the native library serves it
    (identical to per-read ``map_read``), else ``map_read`` a read."""
    if not call.to_host:
        return
    with call.timer.stage("map.host") as span:
        store = SequenceStore()
        for rid, seq in call.to_host:
            store.add(str(rid), seq)
        per = map_batch(index, store, call.cfg)
        if per is None:
            for rid, seq in call.to_host:
                call.results[rid] = map_read(index, seq, call.cfg)
        else:
            for (rid, _seq), (_sid, maps) in zip(call.to_host, per):
                call.results[rid] = maps
    DEVICE_MAP_STATS["host_map_s"] = span.seconds


def _length_buckets(items) -> list[tuple[int, list[tuple[int, bytes]]]]:
    """``items`` grouped by ``device_bucket_len``, shortest bucket first."""
    buckets: dict[int, list[tuple[int, bytes]]] = {}
    for rid, seq in items:
        buckets.setdefault(device_bucket_len(len(seq)), []).append((rid, seq))
    return sorted(buckets.items())


def _batches(buckets, batch_reads):
    """(chunk, L, first row) of each batch of ``batch_reads`` reads of the
    ``(L, reads)`` buckets, in their order."""
    return ((members[s : s + batch_reads], L, s)
            for L, members in buckets for s in range(0, len(members), batch_reads))


def _codes_of(seqs, rows: int, L: int, pin: bool = False):
    """(rows, L) uint8 base codes (pad 4) and (rows,) int32 lengths of
    ``seqs``, host tensors in pinned memory with ``pin``."""
    codes = torch.full((rows, L), 4, dtype=torch.uint8, pin_memory=pin)
    lens = torch.zeros(rows, dtype=torch.int32, pin_memory=pin)
    codes_np, lens_np = codes.numpy(), lens.numpy()
    for i, seq in enumerate(seqs):
        c = encode_2bit(seq)
        codes_np[i, : len(c)] = c
        lens_np[i] = len(c)
    return codes, lens


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


def _collect_padded(call, chunk, out) -> None:
    """The padded hits of one batch (``unpack_hits``'s dict) into the
    call's results; flagged reads are counted and queued for the host."""
    rows = np.stack([out[f] for f in HIT_FIELDS], axis=-1)  # (R, max_hits, 8)
    for i, (rid, seq) in enumerate(chunk):
        if out["overflow"][i]:
            DEVICE_MAP_STATS["overflow_reads"] += 1
            call.to_host.append((rid, seq))
            continue
        call.results[rid] = _mappings_of_rows(rows[i, : int(out["n_hits"][i])])


def _padded_pass(call, batches, pack, launch) -> None:
    """The batches of a route whose hits come back in the padded layout:
    ``pack(chunk, L, s)`` puts a batch on the device, ``launch(batch,
    budgets)`` maps it, and its hits cross back in one ``pack_hits``
    tensor; the reads they flag are queued for the host."""
    timer = call.timer

    def dispatch(chunk, L, s):
        batch = pack(chunk, L, s)
        with timer.stage("map.dispatch"):
            budgets = device_bucket_budgets(L, call.cfg.k, call.max_pos, call.max_per_hit)
            return chunk, *_copy_to_host(pack_hits(launch(batch, budgets)))

    def collect(pending):
        chunk, flat, ready = pending
        with timer.stage("map.wait"):
            if ready is not None:
                ready.synchronize()
        _collect_padded(call, chunk, unpack_hits(flat, call.max_hits))

    _pipelined(batches, dispatch, collect, timer)


def _v1_join(call, index):
    """(pack, launch) of the v1 join, for an index that the v2 tables
    refuse: the join tables and the index's five arrays go to the device
    once, and each batch crosses as (R, L) uint8 codes from pinned memory."""
    E = int(index.offsets[-1])
    if E >= 2**31:
        raise ValueError(f"the v1 join addresses entries with int32 offsets: {E} entries")
    dev = call.dev
    with call.timer.stage("map.v1_tables") as span:
        bitmap, rank, rounds = build_join_tables(index.hashes, device=dev)
        idx_dev = (u32_tensor(index.hashes, dev),
                   torch.from_numpy(index.offsets.astype(np.int32)).to(dev),
                   torch.from_numpy(index.entry_unitig).to(dev),
                   torch.from_numpy(index.entry_pos).to(dev),
                   torch.from_numpy(index.entry_strand).to(dev))
    DEVICE_MAP_STATS.update(index_entries=E, v1_setup_s=span.seconds)
    pin = dev.type == "cuda"

    def pack(chunk, L, _s):
        with call.timer.stage("map.read_pack"):
            codes, lens = _codes_of((seq for _rid, seq in chunk), call.batch_reads, L, pin)
            return codes.to(dev, non_blocking=True), lens.to(dev, non_blocking=True)

    def launch(batch, budgets):
        _sel, pos_L, trim_L = budgets
        return map_reads_device(*batch, *idx_dev, bitmap, rank, w=call.cfg.w, max_pos=pos_L,
                                max_per_hit=call.max_per_hit, join_rounds=rounds, trim=trim_L,
                                **call.tail_kw())

    return pack, launch


def _v2_packer(call, reads):
    """``pack(chunk, L, s, cache=True)`` of the v2 routes: a batch's 2-bit
    packed codes, non-ACGT mask and lengths on the device, taken from and
    kept in the store's batch cache unless ``cache`` is false."""
    dev, R = call.dev, call.batch_reads
    dev_cache = _batch_cache(reads, dev)
    cache_cap = int(os.environ.get("MS_TPU_DEV_CACHE_MB", "2048")) << 20

    def cache_put(key, tensors):
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if nbytes > cache_cap:
            return
        while dev_cache and sum(sz for _v, sz in dev_cache.values()) + nbytes > cache_cap:
            del dev_cache[next(iter(dev_cache))]  # the least recently used
        dev_cache[key] = (tensors, nbytes)

    def pack(chunk, L, s, cache=True):
        # tier-2 batches never cache: which reads they hold depends on the
        # index, so a positional key would alias them across calls
        key = (L, s, R)
        if cache and key in dev_cache:
            dev_cache[key] = dev_cache.pop(key)  # LRU: move to the back
            return dev_cache[key][0]
        with call.timer.stage("map.read_pack"):
            seqs = [seq for _rid, seq in chunk]
            built_np = (native.pack_reads_2bit(seqs, L, n_rows=R)
                        if native.available() else None)
            if built_np is not None:
                packed, nmask, lens = built_np
                tensors = (u32_tensor(packed, dev), u32_tensor(nmask, dev),
                           torch.from_numpy(lens).to(dev))
            else:
                codes, lens = _codes_of(seqs, R, L)
                tensors = (*pack_codes(codes.numpy(), device=dev), lens.to(dev))
        if cache:
            cache_put(key, tensors)
        return tensors

    return pack


def _dense_pass(call, batches, pack, built, hit_budget) -> None:
    """The v2 route on one device: each batch's six stages, replayed from
    a CUDA graph on a CUDA device (``_StageGraphs``) and launched op by op
    elsewhere, its hits pulled in the dense layout.  A batch with more
    than ``hit_budget`` hits is mapped again op by op and pulled padded;
    the reads that break a budget go through tier 2 or to the host."""
    cfg, timer, R, max_hits = call.cfg, call.timer, call.batch_reads, call.max_hits
    tables, hash_takes = built
    # the dense tail clamps identically: a budget above R*max_hits can
    # never be filled
    hit_budget = min(16 * R if hit_budget is None else hit_budget, R * max_hits)
    tail_kw = call.tail_kw()
    graphs = _StageGraphs(call.dev) if call.dev.type == "cuda" else None
    # second-tier expansion cap (one no wider than the first's disables
    # tier 2): reads whose violation a wider cap or wider widths fix go
    # through the device again
    tier2_mph = min(int(os.environ.get("MS_TPU_MAP_TIER2", "16")), 30)  # < 31: saturation
    deferred: dict[int, list[tuple[int, bytes]]] = {}

    def dispatch(chunk, L, s, mph=call.max_per_hit, pos_cap=call.max_pos, cache=True):
        """The six stages of one batch, queued on the device; returns the
        pending pull (chunk, flat hits on the host, its ready event, the
        batch, its budgets, cap)."""
        batch = pack(chunk, L, s, cache)
        with timer.stage("map.dispatch"):
            budgets = device_bucket_budgets(L, cfg.k, pos_cap, mph)
            sel_L, pos_L, trim_L = budgets

            def stages(packed, nmask, lens):
                anchors = anchors_device_v2(
                    unpack_codes(packed, nmask), lens, *tables, k=cfg.k, w=cfg.w,
                    max_sel=sel_L, max_pos=pos_L, max_per_hit=mph, hash_takes=hash_takes)
                return anchors_to_hits_device_dense(*anchors, trim=trim_L, budget=hit_budget,
                                                    **tail_kw)

            if graphs is None:
                flat = stages(*batch)
                DEVICE_MAP_STATS["eager_batches"] += 1
            else:
                flat = graphs.run(_graph_key(tables, hash_takes, L, budgets, mph, R, hit_budget,
                                             cfg, max_hits), batch, stages)
            # start the copy back now, so the host collects this batch while
            # the device runs the next one (and before a replay reuses flat)
            return chunk, *_copy_to_host(flat), batch, budgets, mph

    def route(n, width_ovf, max_ecnt, mph) -> str:
        """Where a read of ``n`` bases goes after a pass with expansion cap
        ``mph``: "hits" where it broke no budget; else "tier2" where the
        wider cap or the wider widths fix what broke, and "host" where the
        read is hot past tier 2's cap or tier 2 cannot grow its widths."""
        if not (width_ovf or max_ecnt > mph):
            return "hits"
        if mph >= tier2_mph or max_ecnt > tier2_mph:
            return "host"
        Lb = device_bucket_len(n)
        widths_grow = (device_bucket_budgets(Lb, cfg.k, 2 * call.max_pos, tier2_mph)
                       != device_bucket_budgets(Lb, cfg.k, call.max_pos, mph))
        return "tier2" if max_ecnt > mph or widths_grow else "host"

    def collect(pending):
        chunk, flat, ready, batch, budgets, mph = pending
        with timer.stage("map.wait"):
            if ready is not None:
                ready.synchronize()
        flat_np = flat.numpy()
        n_hits = flat_np[:R]
        width_ovf = flat_np[R : 2 * R] != 0
        max_ecnt = flat_np[2 * R : 3 * R]
        counts = np.minimum(n_hits, max_hits)
        if int(counts.sum()) > hit_budget:
            # over the dense budget: the batch mapped again op by op with
            # the padded tail, cap violations folded into its overflow
            DEVICE_MAP_STATS["dense_repulls"] += 1
            with timer.stage("map.repull"):
                out = unpack_hits(pack_hits(map_reads_device_v2_packed(
                    *batch, *tables, **call.v2_kw(hash_takes, budgets, mph))), max_hits)
            _collect_padded(call, chunk, out)
            return
        dense_np = flat_np[3 * R :].reshape(hit_budget, 9)[:, 1:]  # drop flat_slot
        offs = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        for i, (rid, seq) in enumerate(chunk):
            where = route(len(seq), width_ovf[i], max_ecnt[i], mph)
            if where == "hits":
                call.results[rid] = _mappings_of_rows(dense_np[offs[i] : offs[i + 1]])
            elif where == "tier2":
                deferred.setdefault(device_bucket_len(len(seq)), []).append((rid, seq))
                DEVICE_MAP_STATS["tier2_reads"] += 1
                DEVICE_MAP_STATS["tier2_width_reads"] += int(width_ovf[i])
                DEVICE_MAP_STATS["tier2_hot_reads"] += int(max_ecnt[i] > mph)
            else:
                DEVICE_MAP_STATS["overflow_reads"] += 1
                call.to_host.append((rid, seq))

    with timer.stage("map.tier1"):
        _pipelined(batches, dispatch, collect, timer)
    # tier 2 over the deferred reads: the wider cap and twice the widths;
    # its own violations go to the host (mph == tier2_mph there)
    if deferred:
        first_pass_host = len(call.to_host)
        with timer.stage("map.tier2"):
            _pipelined(_batches(sorted(deferred.items()), R),
                       lambda chunk, L, s: dispatch(chunk, L, s, tier2_mph, 2 * call.max_pos,
                                                    cache=False),
                       collect, timer)
        DEVICE_MAP_STATS["tier2_host_reads"] = len(call.to_host) - first_pass_host


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
