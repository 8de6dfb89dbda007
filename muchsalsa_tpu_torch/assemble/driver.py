"""Top-level assembly driver of the port: the core's 11 phases.

Port of ``muchsalsa_tpu/assemble/driver.py::assemble``.  The phases, their
order, and the ``StageTimer`` stage names are the JAX driver's; phase ②
(edges) and phase ③ (chaining) run on ``device`` through
``matching/edges_torch.py`` and ``ops/chaining_torch.py`` where
``config.device.use_device`` is set and their size gates open (below),
sharded over every visible device of ``device``'s type where there are
several (``_driver_mesh``).  With it unset, both run the host oracle
(``matching.edges.build_edges`` and ``host.chaining_phase``) and nothing
reaches ``device``: ``chip_smoke.py`` holds the port against that run.  Every other phase is host code, the
port's own copy of the JAX package's modules (``assemble/host.py`` holds
the driver's host half).  Across processes (``process_count > 1``) every
process replays the graph phases and assembles its round-robin share of
the components (``host._run_distributed_assembly``).

Each device phase has a size gate, the JAX driver's rule (``_on_device``):
phase ② goes to the device when the match table has at least
``config.device.edges_device_min_rows`` rows, phase ③ when ``2 *
graph.size`` (an upper bound on its (edge, strand class) problems) reaches
``config.device.chain_device_min_problems``.  A threshold of 0 forces the
device, ``use_device`` unset keeps both phases on the host, and on the
CPU the gates always open, as the JAX driver's do on its CPU backend.
Both thresholds were measured on an H100 by
``scripts/torch_gate_crossover.py``; the card's edges won at no size
measured, so phase ②'s default keeps it on the host on a card
(``config.GATE_CLOSED``).  A closed gate runs the host oracle of the unset
branch and launches nothing for its phase; a run whose gates
both close creates no CUDA context (``resolve_device`` and the peak-memory
counters create none), which spares it the card's first tensor.  The JAX
driver also probes its link to the device (``MS_TPU_MIN_LINK_MBPS``); an
attached card has no such link, so the port has no probe.  Every process
of a process group and every shard of a mesh takes the same decision,
before the mesh is used.

Two environment switches, as in the JAX driver: ``MS_TPU_PROFILE=<dir>``
writes a ``torch.profiler`` Chrome trace of the chaining stage into
``<dir>`` (``utils/timing.py::torch_profile``; the profiler starts before
the stage's timer and exports after it, so the stage wall holds neither),
and ``MS_TPU_DEBUG`` turns on the verbose stage lines of the timer the
driver creates (a caller's timer keeps its setting) and synchronises the
card at the end of each device stage, so that a kernel fault surfaces in
the stage that launched it.  Neither changes an output byte.
"""

from __future__ import annotations

import json
import os
import resource
from pathlib import Path

import torch

from muchsalsa_tpu_torch.assemble import consensus
from muchsalsa_tpu_torch.assemble import contraction as ctr
from muchsalsa_tpu_torch.assemble import spanning
from muchsalsa_tpu_torch.assemble.consensus import ConsensusContext, assemble_path
from muchsalsa_tpu_torch.assemble.host import (
    _assembly_worker_count, _run_distributed_assembly, _run_parallel_assembly, build_graph,
    chaining_phase)
from muchsalsa_tpu_torch.assemble.linearize import linearize_graph
from muchsalsa_tpu_torch.assemble.orientation import get_directed_graph, pick_start_vertex
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.io.output import OutputWriter
from muchsalsa_tpu_torch.io.paf import read_paf
from muchsalsa_tpu_torch.io.registry import Registry
from muchsalsa_tpu_torch.matching.edges import build_edges
from muchsalsa_tpu_torch.matching.store import MatchStore
from muchsalsa_tpu_torch.utils.timing import StageTimer, torch_profile
from muchsalsa_tpu_torch.config import DEFAULT_CONFIG, Config
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.matching.edges_torch import build_edges_device
from muchsalsa_tpu_torch.ops.chaining_torch import chaining_phase_device
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod


def memory_stats(device: torch.device) -> dict:
    """Peak host RSS, and on a card the peak bytes torch allocated there
    since the run reset the counter."""
    out = {"host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if device.type == "cuda":
        out["device_peak_bytes_allocated"] = torch.cuda.max_memory_allocated(device)
    return out


def _on_device(config: Config, n: int, threshold: int, dev: torch.device) -> bool:
    """Whether a device phase of ``n`` work items runs on ``dev``: the JAX
    driver's rule (``muchsalsa_tpu/assemble/driver.py:492-497``,
    ``:522-527``) without its link probe.  ``use_device`` unset keeps the
    phase on the host; on the CPU, or with a threshold of 0, it always runs
    on ``dev``; on a card it runs there from ``threshold`` items up."""
    return config.device.use_device and (dev.type == "cpu" or threshold == 0 or n >= threshold)


def _device_stage_end(debug: bool, on_device: bool, dev: torch.device) -> None:
    """Under ``MS_TPU_DEBUG``, wait for the card at the end of a device
    stage, so that a fault of its kernels raises in that stage."""
    if debug and on_device and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _driver_mesh(config: Config, device: torch.device) -> mesh_mod.Mesh | None:
    """The data-parallel mesh of the device phases: every visible device of
    ``device``'s type, or None with ``use_device`` unset or fewer than two.
    The devices are this process's own (``visible_devices``), so under a
    process group each process's graph phases stay on its own cards, as
    the JAX driver's ``local_only`` mesh does."""
    if not config.device.use_device:
        return None
    return mesh_mod.local_mesh(device, axis=config.device.data_axis)


def assemble(
    paf_path: str | Path,
    unitigs_path: str | Path,
    nanopore_path: str | Path,
    output_dir: str | Path,
    config: Config = DEFAULT_CONFIG,
    timer: StageTimer | None = None,
    workers: int | None = None,
    process_index: int = 0,
    process_count: int = 1,
    allgather=None,
    *,
    device: str | torch.device,
) -> dict:
    """Run the core assembly; returns summary counters, the timer and the
    memory block also written to ``assembly_stats.json``.

    ``workers > 1`` fans the per-component assembly out over host worker
    processes (spawned by default); they run host code only and never
    touch the card.  With ``process_count > 1`` (a process group), the
    components go round-robin over the processes and merge through
    ``allgather`` (``pipeline/scrubber.py::torch_record_allgather``); every
    process writes the same bytes.  A given ``allgather`` takes that branch
    with one process too.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    debug = bool(os.environ.get("MS_TPU_DEBUG"))
    if timer is None:
        timer = StageTimer()
        timer.verbose = timer.verbose or debug
    profile_dir = os.environ.get("MS_TPU_PROFILE")
    gcfg = config.graph
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    registry_nano = Registry()
    registry_illu = Registry()

    with timer.stage("ingest"):
        records = read_paf(
            paf_path,
            min_matches=gcfg.min_matches,
            th_length=gcfg.th_length,
            th_matches=gcfg.th_matches,
            skip_last_line=gcfg.skip_last_paf_line,
            registry_nanopore=registry_nano,
            registry_illumina=registry_illu,
        )
        store = MatchStore.from_paf(records)

    mesh = _driver_mesh(config, dev)
    timer.count("mesh_devices", 0 if mesh is None else mesh.size)

    timer.count("match_rows", len(store))
    edges_on_device = _on_device(config, len(store), config.device.edges_device_min_rows, dev)
    timer.count("edges_on_device", int(edges_on_device))
    with timer.stage("edges"):
        if edges_on_device:
            edge_matches = build_edges_device(store, gcfg.th_overlap, device=dev, mesh=mesh)
        else:
            edge_matches = build_edges(store, gcfg.th_overlap)
        _device_stage_end(debug, edges_on_device, dev)
        graph = build_graph(store, edge_matches)
    timer.count("graph_order", graph.order)
    timer.count("graph_size", graph.size)

    with timer.stage("sequence_index"):
        nano_seqs = SequenceStore(registry_nano)
        nano_seqs.load(nanopore_path)
        illu_seqs = SequenceStore(registry_illu)
        illu_seqs.load(unitigs_path)

    chain_on_device = _on_device(config, 2 * graph.size,
                                 config.device.chain_device_min_problems, dev)
    timer.count("chaining_on_device", int(chain_on_device))
    with torch_profile(profile_dir, dev), timer.stage("chaining"):
        if chain_on_device:
            placed = chaining_phase_device(
                graph,
                store,
                edge_matches,
                gcfg.wiggle_room,
                config.device.chain_buckets,
                config.device.min_device_batch,
                device=dev,
                mesh=mesh,
            )
            timer.count("chain_device_problems", placed["device_problems"])
            timer.count("chain_host_problems", placed["host_problems"])
            for k, b in placed["batches"].items():
                timer.count(f"chain_batch_k{k}", b)
        else:
            chaining_phase(graph, store, edge_matches, gcfg.wiggle_room)
        _device_stage_end(debug, chain_on_device, dev)

    with timer.stage("contraction"):
        contraction_edges = ctr.find_contraction_edges(graph, gcfg.wiggle_room)
        targets = ctr.find_contraction_targets(graph, contraction_edges)
        deletable_vertices, roots = ctr.find_deletable_vertices(contraction_edges, targets)
        contain_elements = ctr.contract(
            contraction_edges,
            roots,
            lambda nano, illu: store.row(nano, illu),
            lambda vid: graph.vertex(vid).nanopore_length,
        )
        for vid in sorted(deletable_vertices):
            graph.delete_vertex(vid)
        for edge in ctr.prune_contained_orders(graph):
            graph.delete_edge(edge)
    timer.count("contraction_edges", len(contraction_edges))
    timer.count("contraction_roots", len(roots))

    with timer.stage("spanning"):
        spanning.compute_bitweights(graph)
        tree = spanning.max_span_tree(graph)
        for edge in spanning.decycle(
            graph,
            tree,
            gcfg.base_weight_multiplicator,
            gcfg.max_weight_multiplicator,
        ):
            graph.delete_edge(edge)
    timer.count("graph_order_reduced", graph.order)
    timer.count("graph_size_reduced", graph.size)

    consensus.reset_fallback_counts()
    with timer.stage("assembly"):
        writer = OutputWriter(
            out / "temp_1.query.fa", out / "temp_1.align.paf", out / "temp_1.target.fa"
        )
        ctx = ConsensusContext(
            store,
            edge_matches,
            nano_seqs,
            illu_seqs,
            config.consensus.th_sequence_length,
            config.consensus.sequence_line_length,
        )
        components = spanning.connected_components(graph)
        lcfg = config.linearize
        if process_count > 1 or allgather is not None:
            n_workers = 1
            n_paths = _run_distributed_assembly(
                ctx, contain_elements, graph, components, lcfg, writer,
                process_index, process_count,
                allgather if allgather is not None else (lambda x: x),
            )
        elif (n_workers := _assembly_worker_count(workers, len(components))) > 1:
            n_paths = _run_parallel_assembly(
                ctx, contain_elements, graph, components, lcfg, n_workers,
                writer,
            )
        else:
            # sequential: per-component orientation + linearization, then
            # per-path consensus — the reference's processing order
            # (src/main.cpp:303-310, 645-657)
            asm_idx = -1
            n_paths = 0
            for component in components:
                sub = graph.subgraph(component)
                start = pick_start_vertex(sub)
                if start is None:
                    continue
                dig = get_directed_graph(graph, sub, start)
                paths = linearize_graph(
                    dig,
                    lcfg.cluster_weight_exact_max_order,
                    lcfg.path_min_length,
                    lcfg.path_min_length_touching,
                    lcfg.join_max_distance,
                )
                for path in paths:
                    asm_idx += 1
                    n_paths += 1
                    assemble_path(
                        ctx, {}, contain_elements, path, dig, asm_idx, writer,
                    )
        writer.close()
    timer.count("assembly_workers", n_workers)
    timer.count("components", len(components))
    timer.count("paths", n_paths)
    for name, value in consensus.FALLBACK_COUNTS.items():
        timer.count(name, value)

    memory = memory_stats(dev)
    (out / "assembly_stats.json").write_text(json.dumps(
        {"stages": timer.stages, "counters": timer.counters, "memory": memory},
        indent=2))
    return {"components": len(components), "paths": n_paths, "timer": timer,
            "memory": memory}
