"""Read scrubbing: trim long reads to their anchor/overlap-supported spans.

Reference counterpart: ``pipeline/scrubber_bfs.py`` — the reference's
out-of-core streaming mechanism (SURVEY.md §2.4 #35): a graph links
reads sharing an anchor; bounded BFS subsets (<= ``subset_size`` nodes)
are all-vs-all overlapped (there: an external ``minimap2 -x ava-ont``
fork; here: the native minimizer mapper over the subset), overlap spans
merge into each read's covered intervals, and interior ("center") nodes
emit their covered spans (ends trimmed) and leave the graph.

Semantics mirrored: >= 500bp hits only, first anchor hit per
(anchor, read) pair, same-direction extension-merge within 500bp
(``scrubber_bfs.py:204-240``), span trim to [200, len-200], min-id BFS
starts.

The port's copy of ``muchsalsa_tpu/pipeline/scrubber.py``.  Its device
all-vs-all (``_device_all_vs_all``) maps each subset on a torch device
through the port's device mapper; across processes the subsets go
round-robin and their records cross through ``torch_record_allgather``
(the counterpart of ``jax_record_allgather``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import torch

from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.pipeline.mapper import MinimizerIndex, map_read

# the last scrub_reads call with a device: the device, how many subsets were
# mapped on it and how many its guard declined (those ran on the host), and
# each subset's index multiplicity and its count of index chunks (estimated
# where declined, as built where mapped) and, where mapped, the device
# mapper's counters summed over its chunks (reads mapped, reads that went to
# the host mapper, reads through tier 2, padded re-pulls)
SCRUB_DEVICE_STATS: dict = {}
_MAP_COUNTERS = ("total_reads", "overflow_reads", "tier2_reads", "dense_repulls")


@dataclass
class _Node:
    length: int
    illu_to_ranges: dict[str, tuple[int, int]] = field(default_factory=dict)
    seq_to_ranges: dict[str, tuple[int, int, str]] = field(default_factory=dict)


def build_anchor_graph(paf_lines, min_hit: int = 500):
    """Anchor-sharing read graph (scrubber_bfs.py:57-114).

    Reads sharing an anchor (PAF col 0) form a clique.  The reference
    groups CONSECUTIVE lines by col 0 — correct for minimap2's
    query-grouped output; our native mapper emits read-grouped lines,
    so membership is keyed by anchor id explicitly (identical graph on
    query-grouped input, and the intended graph — anchor-sharing reads
    co-located per BFS subset — on any line order)."""
    nodes: dict[str, _Node] = {}
    adj: dict[str, set[str]] = {}
    chunks: dict[str, list[str]] = {}

    for line in paf_lines:
        if not line:
            continue
        c = line.split("\t")
        id_1, id_2 = c[0], c[5]
        len_2 = int(c[6])
        s_1, e_1 = int(c[2]), int(c[3])
        s_2, e_2 = int(c[7]), int(c[8])

        if e_1 - s_1 < min_hit:
            continue

        if id_2 not in nodes:
            nodes[id_2] = _Node(length=len_2)
            adj[id_2] = set()
        if id_1 in nodes[id_2].illu_to_ranges:
            continue
        nodes[id_2].illu_to_ranges[id_1] = (s_2, e_2)

        chunk_nodes = chunks.setdefault(id_1, [])
        for prev in chunk_nodes:
            adj[prev].add(id_2)
            adj[id_2].add(prev)
        chunk_nodes.append(id_2)

    return nodes, adj


def _merge_ranges(node: _Node, other: str, s: int, e: int, direction: str, ext: int):
    cur = node.seq_to_ranges.get(other)
    if cur is None:
        node.seq_to_ranges[other] = (s, e, direction)
        return
    cs, ce, d = cur
    if direction == d and (abs(cs - e) < ext or abs(s - ce) < ext):
        node.seq_to_ranges[other] = (min(s, cs), max(e, ce), direction)


def _covered_spans(node: _Node) -> list[tuple[int, int]]:
    join = [(s, e) for (s, e, _d) in node.seq_to_ranges.values()]
    join += list(node.illu_to_ranges.values())
    join.sort()
    covered: list[tuple[int, int]] = []
    for s, e in join:
        if covered and covered[-1][0] <= e and s <= covered[-1][1]:
            covered[-1] = (min(s, covered[-1][0]), max(e, covered[-1][1]))
        else:
            covered.append((s, e))
    return covered


def _subset_schedule(
    nodes, adj, subset_size: int
) -> list[tuple[list[str], list[str]]]:
    """Precompute the (subset, center) schedule of the streaming scrub.

    The BFS subsets, center selection, and node retirement depend only
    on the anchor graph — never on the overlap results — so the whole
    schedule is known up front.  That makes the expensive per-subset
    all-vs-all overlap step embarrassingly parallel (across processes /
    hosts) while the order-dependent range merging stays sequential.
    """
    adj = {k: set(v) for k, v in adj.items()}
    remaining = set(nodes)
    schedule: list[tuple[list[str], list[str]]] = []

    # ``min(remaining - bfs_subset)`` recomputed per accreted node is
    # O(N) set work — O(N * subset_size) total when the anchor graph is
    # sparse and BFS adds one node at a time (measured: the dominant
    # term of the 140 Mb scrub wall).  An ascending scan pointer gives
    # the identical min: within one subset accumulation ``remaining``
    # only shrinks and ``bfs_subset`` only grows, so everything behind
    # the pointer stays ineligible; the pointer resets when a subset is
    # emitted (non-center members become eligible again).
    sorted_ids = sorted(nodes)
    ptr = 0
    bfs_subset: set[str] = set()
    while remaining:
        while ptr < len(sorted_ids) and (
            sorted_ids[ptr] not in remaining or sorted_ids[ptr] in bfs_subset
        ):
            ptr += 1
        if ptr < len(sorted_ids):
            start = sorted_ids[ptr]
        else:
            # every remaining node is already in the subset
            start = min(remaining)

        # BFS until subset_size nodes collected.  Membership against
        # ``bfs_subset`` is checked in place — building
        # ``{start} | bfs_subset`` copied the whole growing subset per
        # accreted node (the second quadratic term of the 140 Mb wall)
        queue = deque([start])
        seen = {start}
        order = [start]
        while queue and len(bfs_subset) + len(order) < 10 * subset_size:
            cur = queue.popleft()
            for nb in sorted(adj.get(cur, ())):
                if nb in seen or nb in bfs_subset or nb not in remaining:
                    continue
                seen.add(nb)
                order.append(nb)
                queue.append(nb)

        for node in order:
            if len(bfs_subset) >= subset_size:
                break
            bfs_subset.add(node)

        if len(bfs_subset) < subset_size and len(remaining) > len(bfs_subset):
            continue  # merge small component into the next subset

        # center = members with no neighbor outside the subset
        center = set(bfs_subset)
        for u in bfs_subset:
            for v in adj.get(u, ()):
                if v in remaining and v not in bfs_subset:
                    center.discard(u)
                    break

        schedule.append((sorted(bfs_subset), sorted(center)))

        for name in center:
            remaining.discard(name)
            subsetless = adj.pop(name, set())
            for v in subsetless:
                adj.get(v, set()).discard(name)
        bfs_subset.clear()
        ptr = 0  # non-center members are eligible starts again

    return schedule


def _device_all_vs_all(subset_store: SequenceStore, mapper_cfg,
                       entry_budget: float = 60e6,
                       max_chunks: float = 2, *,
                       device: str | torch.device = "cuda"):
    """All-vs-all of one scrub subset on ``device``.

    Returns (per-read mappings, or None where the guard declines, and the
    subset's full index).  A 60 k-read subset indexes ~180M minimizer
    entries — past the v2 join tables' 27-bit packing bound
    (``build_device_tables`` would refuse and the mapper would map every
    read on the host).  So the index side is built in CONTIGUOUS id chunks
    small enough to pack, every subset read is mapped against each chunk
    on the device, and chunk-local target ids are rebased.  Because chunks
    are ascending id ranges and the mapper emits hits in (target, strand,
    diagonal) order, the concatenated per-read hit lists are in exactly
    the single-index order — records (and therefore scrub output) are
    identical.
    """
    from muchsalsa_tpu_torch.ops.mapping_torch import build_device_tables
    from muchsalsa_tpu_torch.pipeline.mapper_torch import DEVICE_MAP_STATS, map_all_with_device

    items = list(subset_store.items())
    # multiplicity guard (the JAX package's, measured on its TPU): in an
    # all-vs-all every minimizer indexes ~coverage reads, so past the
    # mapper's expansion budgets EVERY read overflows and "device"
    # degrades to N-chunk host fallback.  The exact multiplicity is
    # entries/hashes of the full subset index (built once here and
    # REUSED — returned to the caller on decline, fed to the single-chunk
    # path otherwise).  Viability accounts for the mapper's tier-2 ladder:
    # the read survives iff multiplicity fits the tier-2 cap AND its
    # expected anchor count (~len/3 candidates x multiplicity) fits the
    # tier-2 anchor trim.
    full_idx = MinimizerIndex.build(subset_store, mapper_cfg)
    subsets = SCRUB_DEVICE_STATS.setdefault("subsets", [])
    if len(full_idx.hashes) and items:
        mult = len(full_idx.entry_pos) / len(full_idx.hashes)
        est_chunks = max(1.0, len(full_idx.entry_pos) / entry_budget)
        # two disqualifiers:
        # - chunk multiplication: every subset read maps against EVERY
        #   index chunk, so an N-chunk subset costs N x the mapping work
        #   of the host's single index;
        # - universal tiering: multiplicity near/above the tier-1 cap
        #   routes essentially every read through a second device pass,
        #   doubling the work.
        if est_chunks > max_chunks or mult > 4:
            print(f"[scrub] device ava declined: multiplicity {mult:.1f}, "
                  f"~{est_chunks:.0f} index chunks — the coverage-bound "
                  f"all-vs-all runs host-native (pair-join formulation "
                  f"needed for a device win, docs/DESIGN.md §9)",
                  flush=True)
            SCRUB_DEVICE_STATS["declined"] = SCRUB_DEVICE_STATS.get("declined", 0) + 1
            subsets.append({"multiplicity": mult, "chunks": est_chunks, "declined": True})
            return None, full_idx
    else:
        mult = 0.0
    # size chunks by estimated entries (~len/3 minimizers per read).
    # The binding constraint is usually the rank-probe bucket cap (<=31
    # distinct hashes per 2^22-bucket), not the 27-bit offset bound, so
    # packability is VERIFIED per chunk (build_device_tables refuses)
    # and refused chunks split in half; the built tables feed the
    # mapper via ``prebuilt`` so nothing builds twice.
    budget = entry_budget
    est = [len(seq) / 3 + 64 for _rid, seq in items]
    chunks: list[tuple[int, int]] = []
    start, acc = 0, 0.0
    for i, e in enumerate(est):
        if acc + e > budget and i > start:
            chunks.append((start, i))
            start, acc = i, 0.0
        acc += e
    chunks.append((start, len(items)))

    merged: dict[int, list] = {rid: [] for rid, _seq in items}
    stack = list(reversed(chunks))
    mapped_chunks = 0
    mapper = dict.fromkeys(_MAP_COUNTERS, 0)
    while stack:
        lo, hi = stack.pop()
        if lo == 0 and hi == len(items):
            index_c = full_idx  # single-chunk subset: reuse, don't rebuild
        else:
            chunk_store = SequenceStore()
            for rid, seq in items[lo:hi]:
                chunk_store.add(subset_store.registry.name(rid), seq)
            index_c = MinimizerIndex.build(chunk_store, mapper_cfg)
        built = build_device_tables(
            index_c.hashes, index_c.offsets, index_c.entry_unitig,
            index_c.entry_pos, index_c.entry_strand, device=device)
        if built is None and hi - lo > 1:
            mid = (lo + hi) // 2
            stack.append((mid, hi))
            stack.append((lo, mid))
            continue
        per = map_all_with_device(index_c, subset_store, mapper_cfg,
                                  prebuilt=built, device=device)
        mapped_chunks += 1
        for key in _MAP_COUNTERS:
            mapper[key] += DEVICE_MAP_STATS[key]
        for rid, maps in per:
            for m in maps:
                m.unitig += lo  # rebase chunk-local target ids
            merged[rid].extend(maps)
    SCRUB_DEVICE_STATS["on_device"] = SCRUB_DEVICE_STATS.get("on_device", 0) + 1
    subsets.append({"multiplicity": mult, "chunks": mapped_chunks, "declined": False, **mapper})
    return [(rid, merged[rid]) for rid, _seq in items], full_idx


def _subset_overlap_records(
    subset: list[str], reads: SequenceStore, scrub_cfg, mapper_cfg,
    device: bool | str | torch.device = False,
) -> list[tuple[str, str, int, int, str]]:
    """All-vs-all overlap of one subset -> ordered merge records
    ``(target_read, other_read, start, end, direction)``.

    Pure function of (subset, reads) — the parallelizable step.  Uses
    one multithreaded native batch call when available; otherwise the
    python path computes each read's minimizer sketch once and reuses
    it for index build and lookup.  A torch ``device`` runs the lookups
    there (the subset all-vs-all IS the mapping kernel —
    ``map_all_with_device``), output identical by the mapper's parity
    contract, unless the guard of ``_device_all_vs_all`` declines.
    """
    from muchsalsa_tpu_torch import native
    from muchsalsa_tpu_torch.ops.minimizer import minimizers
    from muchsalsa_tpu_torch.pipeline.mapper import map_batch

    use_native = native.available() and mapper_cfg.k <= 15

    subset_store = SequenceStore()
    for name in sorted(subset):
        rid = reads.registry.get(name)
        if rid is not None and rid in reads:
            subset_store.add(name, reads.sequence(rid))

    per_read = None
    sketches = None
    index = None
    if device is not False:
        per_read, index = _device_all_vs_all(subset_store, mapper_cfg, device=device)
    if per_read is None:
        if not use_native:
            sketches = {
                sid: minimizers(seq, mapper_cfg.k, mapper_cfg.w)
                for sid, seq in subset_store.items()
            }
        if index is None:
            # (the declined device path already built and returned it)
            index = MinimizerIndex.build(subset_store, mapper_cfg, sketches=sketches)
        per_read = map_batch(index, subset_store, mapper_cfg) if use_native else None
    if per_read is None:
        per_read = [
            (
                rid,
                map_read(
                    index, seq, mapper_cfg,
                    sketch=sketches[rid] if sketches is not None else None,
                ),
            )
            for rid, seq in subset_store.items()
        ]

    records: list[tuple[str, str, int, int, str]] = []
    for rid, maps in per_read:
        rname = subset_store.registry.name(rid)
        for m in maps:
            if m.unitig == rid:
                continue
            if m.q_end - m.q_start < scrub_cfg.min_hit_length:
                continue
            oname = subset_store.registry.name(m.unitig)
            d = "+" if m.strand else "-"
            # id_1 = indexed read (query coords), id_2 = mapped read
            records.append((oname, rname, m.q_start, m.q_end, d))
            records.append((rname, oname, m.t_start, m.t_end, d))
    return records


def _apply_and_emit(nodes, center, records, reads, out, scrub_cfg) -> None:
    """Sequential half of one subset: merge overlap records into the
    node ranges, then emit the covered spans of the center nodes."""
    for tgt, other, s, e, d in records:
        _merge_ranges(nodes[tgt], other, s, e, d, scrub_cfg.ext_merge_distance)

    trim = scrub_cfg.end_trim
    for name in center:
        node = nodes[name]
        rid = reads.registry.get(name)
        if rid is None or rid not in reads:
            continue
        seq = reads.sequence(rid)
        for i, (cs, ce) in enumerate(_covered_spans(node)):
            lo = max(cs, trim)
            hi = min(ce, node.length - trim)
            # reference slices [lo, hi] inclusive via find_sequence_r
            if hi >= lo:
                out.append((f"{name}_{i}", seq[lo : hi + 1]))


def scrub_reads(
    paf_lines: list[str],
    reads: SequenceStore,
    scrub_cfg: ScrubConfig | None = None,
    mapper_cfg: MapperConfig | None = None,
    process_index: int = 0,
    process_count: int = 1,
    allgather=None,
    device: bool | str | torch.device = False,
) -> list[tuple[str, bytes]]:
    """Returns scrubbed read records ``(name, sequence)``.

    ``device`` (a torch device, or False for the host) is where each
    subset's all-vs-all maps; a subset that the guard of
    ``_device_all_vs_all`` declines maps on the host, and the guard prints
    its line; ``SCRUB_DEVICE_STATS`` counts both (this process's subsets).

    With ``process_count > 1`` the per-subset all-vs-all overlap step is
    sharded round-robin across processes and the record lists exchanged
    through ``allgather`` (``allgather(list_of_(subset_idx, records)) ->
    the processes' lists concatenated``, ``torch_record_allgather``).  The
    merge/emit pass replays records in subset order, so the output is
    identical to the single-process run.  Several processes without an
    ``allgather`` raise: no process would see the others' records.
    """
    if process_count > 1 and allgather is None:
        raise ValueError(f"scrub_reads over {process_count} processes needs an allgather")
    scrub_cfg = scrub_cfg or ScrubConfig()
    mapper_cfg = mapper_cfg or MapperConfig()
    if device is not False:
        from muchsalsa_tpu_torch.device import resolve_device

        device = resolve_device(device)
        SCRUB_DEVICE_STATS.clear()
        SCRUB_DEVICE_STATS.update(device=str(device), on_device=0, declined=0, subsets=[])

    nodes, adj = build_anchor_graph(paf_lines, scrub_cfg.min_hit_length)
    schedule = _subset_schedule(nodes, adj, scrub_cfg.subset_size)

    if process_count > 1:
        local = [
            (i, _subset_overlap_records(subset, reads, scrub_cfg, mapper_cfg, device=device))
            for i, (subset, _center) in enumerate(schedule)
            if i % process_count == process_index
        ]
        by_subset = dict(allgather(local))
        record_lists = [by_subset[i] for i in range(len(schedule))]
    else:
        record_lists = [
            _subset_overlap_records(subset, reads, scrub_cfg, mapper_cfg, device=device)
            for subset, _center in schedule
        ]

    out: list[tuple[str, bytes]] = []
    for (subset, center), records in zip(schedule, record_lists):
        _apply_and_emit(nodes, center, records, reads, out, scrub_cfg)
    return out


def torch_record_allgather(local: list) -> list:
    """Exchange per-subset (or per-component) records across the process
    group: every process's list, concatenated in rank order
    (``torch.distributed.all_gather_object`` over gloo).  The identity
    without a group of more than one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return local
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return [record for part in gathered for record in part]
