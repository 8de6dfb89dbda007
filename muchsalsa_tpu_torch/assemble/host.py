"""The host half of the core driver: graph build, the chaining oracle and
the spawn pool of the per-component assembly.

The port's copy of ``muchsalsa_tpu/assemble/driver.py`` :47-310, line for
line (``build_graph``, ``chain_edge``, ``chaining_phase``,
``_assembly_worker_count``, the pool and the cross-process fan-out
``_run_distributed_assembly``); the TPU link probe is not ported.  This
module imports no ``torch``: the pool's spawned workers import it, and
they run host code only.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.assemble import consensus
from muchsalsa_tpu_torch.assemble.consensus import assemble_path
from muchsalsa_tpu_torch.assemble.linearize import linearize_graph
from muchsalsa_tpu_torch.assemble.orientation import get_directed_graph, pick_start_vertex
from muchsalsa_tpu_torch.graph.graph import Graph, VertexInfo
from muchsalsa_tpu_torch.io.output import BufferedOutputWriter
from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu_torch.ops.chaining import GatheredMatches, max_pairwise_paths
from muchsalsa_tpu_torch.ops.overlap import get_overlap

def build_graph(store: MatchStore, edge_matches: EdgeMatches) -> Graph:
    graph = Graph()
    for i, vid in enumerate(store.vertex_ids):
        graph.add_vertex(
            VertexInfo(
                int(vid),
                int(store.vertex_length[i]),
                int(store.vertex_meta_line[i]),
            )
        )
    for e in range(edge_matches.n_edges):
        edge = graph.add_edge(int(edge_matches.edge_v[e]), int(edge_matches.edge_w[e]))
        edge.em_idx = e
    return graph


def chain_edge(ctx, wiggle_room: int):
    """main.cpp:328-414 — returns (shadow, orders)."""
    k = len(ctx.illu_ids)
    plus_rows = np.array([i for i in range(k) if ctx.em_dir[i]], dtype=np.int64)
    minus_rows = np.array([i for i in range(k) if not ctx.em_dir[i]], dtype=np.int64)

    minus_paths = max_pairwise_paths(ctx, minus_rows, False, wiggle_room)
    plus_paths = max_pairwise_paths(ctx, plus_rows, True, wiggle_room)

    has_primary = any(p.primary for p in plus_paths) or any(p.primary for p in minus_paths)
    if has_primary:
        plus_paths = [p for p in plus_paths if p.primary]
        minus_paths = [p for p in minus_paths if p.primary]

    has_multi = any(len(p.ids) > 1 for p in plus_paths) or any(
        len(p.ids) > 1 for p in minus_paths
    )
    if has_multi:
        plus_paths = [p for p in plus_paths if len(p.ids) > 1]
        minus_paths = [p for p in minus_paths if len(p.ids) > 1]

    combined = len(plus_paths) + len(minus_paths)
    if combined > 1:
        shadow = True
    else:
        path = minus_paths[0] if minus_paths else plus_paths[0]
        shadow = not path.primary

    orders = []
    for p in minus_paths:
        o = get_overlap(ctx, p.ids, False, p.score, p.primary)
        if o is not None:
            orders.append(o)
    for p in plus_paths:
        o = get_overlap(ctx, p.ids, True, p.score, p.primary)
        if o is not None:
            orders.append(o)
    return shadow, orders


def chaining_phase(
    graph: Graph, store: MatchStore, edge_matches: EdgeMatches, wiggle_room: int
) -> None:
    gathered = GatheredMatches.build(store, edge_matches)
    for edge in graph.edges():
        ctx = gathered.context(store, edge_matches, edge.em_idx)
        shadow, orders = chain_edge(ctx, wiggle_room)
        edge.shadow = shadow
        edge.orders.extend(orders)


_ASM_STATE: dict | None = None
# per-WORKER cache of post-linearization digraphs (component idx -> dig)
_WORKER_DIGS: dict = {}


def _assembly_worker_count(workers: int | None, n_components: int) -> int:
    import multiprocessing as _mp
    import os as _os

    if n_components < 1:
        return 1
    # never nest pools: a spawn worker re-importing an unguarded user
    # script could otherwise recursively fan out
    if _mp.parent_process() is not None:
        return 1
    env = _os.environ.get("MS_TPU_ASSEMBLY_WORKERS")
    if env is not None:
        return max(1, int(env))
    if workers is None:
        # default OFF: the spawn fan-out has lost every wall-clock
        # measurement taken on this project's hosts (fork-COW over the
        # multi-GB heap outweighs the compute win — BASELINE.md round 2;
        # re-confirmed round 4), so an implicit cpu_count fan-out is a
        # footgun.  Opt in via the `threads` CLI positional / `workers`
        # arg / MS_TPU_ASSEMBLY_WORKERS once measured on the target
        # host.  (The reference defaults to hardware_concurrency,
        # src/Application.cpp:45 — but its threads share one heap.)
        return 1
    return max(1, workers)


def _component_dig_and_paths(comp_idx: int):
    """Build (and cache) a component's post-linearization digraph."""
    st = _ASM_STATE
    graph = st["graph"]
    lcfg = st["lcfg"]
    sub = graph.subgraph(st["components"][comp_idx])
    start = pick_start_vertex(sub)
    if start is None:
        return None, []
    dig = get_directed_graph(graph, sub, start)
    paths = linearize_graph(
        dig,
        lcfg.cluster_weight_exact_max_order,
        lcfg.path_min_length,
        lcfg.path_min_length_touching,
        lcfg.join_max_distance,
    )
    _WORKER_DIGS[comp_idx] = (dig, paths)
    return dig, paths


def _linearize_component(comp_idx: int):
    """Pool phase A: orientation + linearization of one component;
    returns the (small) path lists, keeps the digraph worker-local."""
    _, paths = _component_dig_and_paths(comp_idx)
    return paths


def _assemble_component_buffered(task):
    """Pool phase B: consensus of ALL of one component's paths into
    in-memory buffers.

    The worker reuses its phase-A digraph when it has one for this
    component, otherwise deterministically rebuilds it once
    (linearization is a pure function of the shared graph, so the
    rebuilt digraph is identical).  Final assembly indices are fixed
    before the fan-out.
    """
    comp_idx, indexed_paths = task
    st = _ASM_STATE
    cached = _WORKER_DIGS.get(comp_idx)
    dig = cached[0] if cached else _component_dig_and_paths(comp_idx)[0]
    consensus.reset_fallback_counts()
    out = []
    for asm_idx, path in indexed_paths:
        bw = BufferedOutputWriter()
        assemble_path(st["ctx"], {}, st["contain"], path, dig, asm_idx, bw)
        out.append((asm_idx, *bw.texts()))
    return out, dict(consensus.FALLBACK_COUNTS)


def _asm_pool_init() -> None:
    # forked workers inherit the parent's initialized jax backend; their
    # interpreter-shutdown atexit would run jax's teardown against the
    # shared device connection. Workers are pure Python — drop it all.
    import atexit

    atexit._clear()
    _WORKER_DIGS.clear()


def _asm_spawn_init(state_path: str) -> None:
    # shared-nothing worker: explicit state handoff via one pickle load
    # (no fork-COW over the parent heap, no fork-in-threaded-process
    # deprecation — VERDICT r2 item 10)
    import pickle

    global _ASM_STATE
    with open(state_path, "rb") as fh:
        _ASM_STATE = pickle.load(fh)
    _WORKER_DIGS.clear()


def _make_assembly_pool(n_workers: int, state: dict, tmp_dir):
    """Worker pool for the assembly fan-out.  Start method comes from
    ``MS_TPU_ASSEMBLY_START`` (default ``spawn``): spawn workers are
    shared-nothing (state shipped by pickle once per worker), fork
    workers inherit the heap copy-on-write (cheaper on hosts with
    ordinary DRAM bandwidth, but deprecated in threaded parents)."""
    import multiprocessing
    import os
    import pickle
    import warnings

    method = os.environ.get("MS_TPU_ASSEMBLY_START", "spawn")
    if method == "spawn":
        # spawn re-imports __main__ in every worker; a parent whose
        # __main__ is not an importable file (python - <<EOF, embedded
        # interpreters) would crash-loop the pool — use fork there
        import sys

        main_file = getattr(sys.modules.get("__main__"), "__file__", None)
        if main_file is not None and not os.path.isfile(main_file):
            method = "fork"
    if method == "fork" and "fork" in multiprocessing.get_all_start_methods():
        mp_ctx = multiprocessing.get_context("fork")
        with warnings.catch_warnings():
            # CPython warns that fork + jax's threads may deadlock; the
            # workers are pure Python and never touch jax (atexit is
            # cleared in the initializer), so the fork is safe here
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning)
            return mp_ctx.Pool(n_workers, initializer=_asm_pool_init)
    state_path = os.path.join(tmp_dir, "asm_state.pkl")
    with open(state_path, "wb") as fh:
        pickle.dump(state, fh, protocol=5)
    mp_ctx = multiprocessing.get_context("spawn")
    return mp_ctx.Pool(
        n_workers, initializer=_asm_spawn_init, initargs=(state_path,))


def _run_parallel_assembly(
    ctx, contain_elements, graph, components, lcfg, n_workers, writer
) -> int:
    """Two pool phases mirroring the reference's job-per-component +
    subjob-per-path fan-out (src/main.cpp:303-310, 645-657): A)
    orientation+linearization per component (returns path lists), B)
    consensus per path (returns output buffers, written in path order —
    byte-identical to the sequential loop)."""
    import tempfile

    global _ASM_STATE
    _ASM_STATE = {
        "ctx": ctx, "contain": contain_elements, "graph": graph,
        "components": components, "lcfg": lcfg,
    }
    try:
        with tempfile.TemporaryDirectory(prefix="ms_asm_") as tmp_dir:
            pool = _make_assembly_pool(n_workers, _ASM_STATE, tmp_dir)
            with pool:
                per_comp = pool.map(
                    _linearize_component, range(len(components)), chunksize=1)
                tasks = []
                asm_idx = -1
                for comp_idx, paths in enumerate(per_comp):
                    indexed = []
                    for path in paths:
                        asm_idx += 1
                        indexed.append((asm_idx, path))
                    if indexed:
                        tasks.append((comp_idx, indexed))
                # heaviest components first: the largest sets the
                # critical path
                order = sorted(
                    range(len(tasks)),
                    key=lambda i: -sum(len(p) for _a, p in tasks[i][1]))
                results = pool.map(
                    _assemble_component_buffered, [tasks[i] for i in order],
                    chunksize=1)
        n_paths = asm_idx + 1
        by_idx = {}
        for out, counts in results:
            for a_idx, q, p, t in out:
                by_idx[a_idx] = (q, p, t)
            for name, value in counts.items():
                consensus.FALLBACK_COUNTS[name] += value
        for i in range(n_paths):
            q, p, t = by_idx[i]
            writer.write_query(q)
            writer.write_paf(p)
            writer.write_target(t)
        return n_paths
    finally:
        _ASM_STATE = None


def _run_distributed_assembly(
    ctx, contain_elements, graph, components, lcfg, writer,
    process_index: int, process_count: int, allgather,
) -> int:
    """Cross-process component fan-out (the multi-host form of
    ``src/main.cpp:303-310``): components go round-robin over the
    processes, every process linearizes and assembles its share into
    in-memory buffers, path lists and buffers cross through ``allgather``
    (list in, the processes' lists concatenated in rank order out), and
    every process writes the identical merged output in global path order,
    byte-equal to the sequential loop.  The graph phases before this point
    are deterministic replicas in each process, so only path lists and
    output buffers cross."""
    global _ASM_STATE
    _ASM_STATE = {
        "ctx": ctx, "contain": contain_elements, "graph": graph,
        "components": components, "lcfg": lcfg,
    }
    try:
        _WORKER_DIGS.clear()
        mine = [i for i in range(len(components))
                if i % process_count == process_index]
        local_paths = [(i, _linearize_component(i)) for i in mine]
        paths_by_comp = dict(allgather(local_paths))

        # deterministic global assembly indices in component order
        asm_idx = -1
        tasks = {}
        for comp_idx in range(len(components)):
            indexed = []
            for path in paths_by_comp.get(comp_idx, []):
                asm_idx += 1
                indexed.append((asm_idx, path))
            if indexed:
                tasks[comp_idx] = indexed
        n_paths = asm_idx + 1

        local_out = [_assemble_component_buffered((comp_idx, tasks[comp_idx]))
                     for comp_idx in mine if comp_idx in tasks]
        gathered = allgather(local_out)

        consensus.reset_fallback_counts()
        by_idx = {}
        for out, counts in gathered:
            for a_idx, q, p, t in out:
                by_idx[a_idx] = (q, p, t)
            for name, value in counts.items():
                consensus.FALLBACK_COUNTS[name] += value
        for i in range(n_paths):
            q, p, t = by_idx[i]
            writer.write_query(q)
            writer.write_paf(p)
            writer.write_target(t)
        return n_paths
    finally:
        _ASM_STATE = None
