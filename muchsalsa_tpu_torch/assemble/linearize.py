"""Graph linearization: DAG reduction + conservation-path peeling + joins.

Reference counterpart: ``libms/src/kernel/lg.cpp`` —
``sortReductionByWeight`` (lg.cpp:418-520), ``findClusterWeights``
(exact, lg.cpp:144-264) and ``findClusterWeightsHeuristic``
(lg.cpp:72-141, used at order >= 150000, lg.cpp:362-366),
``findConservationPathAlt`` (lg.cpp:267-344), ``extractPaths``
(lg.cpp:347-414) and ``linearizeGraph`` (lg.cpp:522-629).

Determinism: the reference keys several maps by pointers; all orderings
here are canonicalized to vertex-id order / insertion order.
"""

from __future__ import annotations

from collections import deque

from muchsalsa_tpu_torch.graph.graph import DiGraph, Edge


def sort_reduction_by_weight(dig: DiGraph) -> None:
    """Kahn's peeling; on a cycle, delete (and shadow-mark) the min-weight
    unresolved incoming edge of a frontier vertex (lg.cpp:418-520)."""
    non_null: dict[int, int] = {}
    null_q: deque[int] = deque()
    resolved: set[int] = set()

    for vid in dig.vertices:
        d = dig.in_degree(vid)
        if d > 0:
            non_null[vid] = d
        else:
            null_q.append(vid)

    neighbors: set[int] = set()
    if non_null:
        neighbors.add(min(non_null))  # canonical stand-in for map-begin

    while True:
        while null_q:
            vid = null_q.popleft()
            resolved.add(vid)
            for succ in sorted(dig.successors(vid)):
                non_null[succ] -= 1
                if non_null[succ] == 0:
                    null_q.append(succ)
                    del non_null[succ]
                    neighbors.discard(succ)
                else:
                    neighbors.add(succ)

        if not non_null:
            break

        min_edge: Edge | None = None
        min_vertex: int | None = None
        min_score = 0.0
        scan = sorted(non_null) if not neighbors else sorted(neighbors)
        for open_vertex in scan:
            if open_vertex not in non_null:
                continue
            preds = dig.predecessors(open_vertex)
            for pred in sorted(preds):
                if pred in resolved:
                    continue
                score = preds[pred].weight
                if min_edge is None or score < min_score:
                    min_edge = preds[pred]
                    min_vertex = open_vertex
                    min_score = score

        min_edge.shadow = True
        dig.delete_edge(min_edge)

        non_null[min_vertex] -= 1
        if non_null[min_vertex] == 0:
            del non_null[min_vertex]
            null_q.append(min_vertex)
            neighbors.discard(min_vertex)


def find_cluster_weights(dig: DiGraph) -> dict[Edge, int]:
    """Exact antichain-candidate propagation (lg.cpp:144-264)."""
    sorted_vertices = dig.sort_topologically()
    v2idx = {vid: i for i, vid in enumerate(sorted_vertices)}
    result: dict[Edge, int] = {e: 0 for e in dig.edges()}

    succ_idx = {
        vid: set(v2idx[t] for t in dig.successors(vid)) for vid in sorted_vertices
    }
    pred_idx = {
        vid: set(v2idx[t] for t in dig.predecessors(vid)) for vid in sorted_vertices
    }

    for vid in sorted_vertices:
        # candidate = (open successor-idx set, visited idx list)
        candidates: list[tuple[set[int], list[int]]] = [
            (set(succ_idx[vid]), [v2idx[vid]])
        ]

        for idx_out in sorted(succ_idx[vid]):
            active = sorted_vertices[idx_out]

            for idx_in in sorted(pred_idx[active]):
                # the C++ re-evaluates candidates.size() each iteration,
                # scanning candidates appended within this loop too
                i = 0
                while i < len(candidates):
                    open_set, visited = candidates[i]
                    if visited[-1] == idx_in and idx_out in open_set:
                        intersection = open_set & succ_idx[active]
                        candidates.append((intersection, visited + [idx_out]))
                    i += 1

            filtered = []
            vis_sets = [set(vis) for _, vis in candidates]
            for i, (open_o, _vis_o) in enumerate(candidates):
                dominated = False
                vis_o_set = vis_sets[i]
                for j, (open_i, _vis_i) in enumerate(candidates):
                    if i == j:
                        continue
                    if open_o <= open_i and vis_o_set <= vis_sets[j]:
                        dominated = True
                        break
                if not dominated:
                    filtered.append(candidates[i])
            candidates = filtered

        max_visited: list[list[int]] = []
        max_len = 0
        for _open, visited in candidates:
            if len(visited) > max_len:
                max_visited = [visited]
                max_len = len(visited)
            elif len(visited) == max_len:
                max_visited.append(visited)

        for mv in max_visited:
            c = len(mv) - 1
            for i in range(len(mv) - 1):
                edge = dig.get_edge(sorted_vertices[mv[i]], sorted_vertices[mv[i + 1]])
                result[edge] += c
                c -= 1

    return result


def find_cluster_weights_heuristic(dig: DiGraph) -> dict[Edge, int]:
    """Longest-predecessor-path heuristic (lg.cpp:72-141)."""
    sorted_vertices = dig.sort_topologically()
    v2idx = {vid: i for i, vid in enumerate(sorted_vertices)}
    result: dict[Edge, int] = {e: 0 for e in dig.edges()}

    for vid in sorted_vertices:
        sorted_successors = sorted(v2idx[t] for t in dig.successors(vid))

        candidates: dict[int, list[int]] = {vid: [v2idx[vid]]}
        for succ_idx in sorted_successors:
            v = sorted_vertices[succ_idx]
            best_path: list[int] = []
            for pred in sorted(dig.predecessors(v)):
                if pred in candidates and len(candidates[pred]) > len(best_path):
                    best_path = candidates[pred]
            best_path = best_path + [v2idx[v]]
            candidates.setdefault(v, best_path)

        best = max(candidates.values(), key=len)
        c = len(best) - 1
        for i in range(len(best) - 1):
            edge = dig.get_edge(sorted_vertices[best[i]], sorted_vertices[best[i + 1]])
            result[edge] += c
            c -= 1

    return result


def find_conservation_path(
    dig: DiGraph, cluster_weights: dict[Edge, int]
) -> list[int]:
    """Greedy max-cluster-weight walk in topological order (lg.cpp:267-344)."""
    sorted_vertices = dig.sort_topologically()

    finalized: list[int] = []
    # vertex -> (cluster weight it was reached with, path list)
    open_paths: dict[int, tuple[int, list[int]]] = {}

    for vid in sorted_vertices:
        if dig.out_degree(vid) == 0:
            if vid not in open_paths:
                if not finalized:
                    finalized = [vid]
            else:
                if len(open_paths[vid][1]) > len(finalized):
                    finalized = open_paths[vid][1]
                else:
                    open_paths[vid] = (open_paths[vid][0], [])
            continue

        max_outs: list[tuple[int, int]] = []  # (from, to)
        max_out = 0
        succs = dig.successors(vid)
        for target in sorted(succs):
            w = cluster_weights[succs[target]]
            edge_pair = (succs[target].v, succs[target].w)
            if edge_pair[1] != target:
                edge_pair = (edge_pair[1], edge_pair[0])
            if w > max_out:
                max_out = w
                max_outs = [edge_pair]
            elif w == max_out:
                max_outs.append(edge_pair)

        for src, nxt in max_outs:
            if nxt in open_paths:
                old_w, old_path = open_paths[nxt]
                # mirror C++ short-circuit + operator[] creation side
                # effects exactly (lg.cpp:320-324): openPaths[pVertex] is
                # default-created when the comparison or body touches it
                if old_w < max_out:
                    take = True
                elif old_w == max_out:
                    cur = open_paths.setdefault(vid, (0, []))
                    take = len(old_path) < len(cur[1]) + 1
                else:
                    take = False
                if take:
                    cur = open_paths.setdefault(vid, (0, []))
                    open_paths[nxt] = (max_out, list(cur[1]) + [nxt])
            else:
                if vid in open_paths:
                    open_paths[nxt] = (max_out, list(open_paths[vid][1]) + [nxt])
                else:
                    open_paths[nxt] = (max_out, [src, nxt])

        entry = open_paths.setdefault(vid, (0, []))
        open_paths[vid] = (entry[0], [])

    return finalized


def extract_paths(
    dig: DiGraph,
    cluster_weight_exact_max_order: int = 150_000,
    path_min_length: int = 10,
    path_min_length_touching: int = 5,
) -> list[list[int]]:
    """lg.cpp:347-414."""
    work = dig.copy()
    for edge in work.edges():
        if edge.shadow:
            work.delete_edge(edge)

    sort_reduction_by_weight(work)

    if work.order < cluster_weight_exact_max_order:
        cluster_weights = find_cluster_weights(work)
    else:
        cluster_weights = find_cluster_weights_heuristic(work)

    paths: list[list[int]] = []
    visited: set[int] = set()

    while work.size > 0:
        longest = find_conservation_path(work, cluster_weights)

        if len(longest) < path_min_length:
            is_in_visit = any(p in visited for p in dig.predecessors(longest[0]))
            is_out_visit = any(s in visited for s in dig.successors(longest[-1]))
            if (not is_in_visit and not is_out_visit) or (
                (is_in_visit or is_out_visit) and len(longest) > path_min_length_touching
            ):
                paths.append(longest)
        else:
            paths.append(longest)

        for vid in longest:
            visited.add(vid)
            work.delete_vertex(vid)

    for vid in work.vertices:
        paths.append([vid])

    return paths


def linearize_graph(
    dig: DiGraph,
    cluster_weight_exact_max_order: int = 150_000,
    path_min_length: int = 10,
    path_min_length_touching: int = 5,
    join_max_distance: int = 3,
) -> list[list[int]]:
    """lg.cpp:522-629 — extract paths then join ends through shadow edges."""
    paths = extract_paths(
        dig, cluster_weight_exact_max_order, path_min_length, path_min_length_touching
    )

    color_correction = {i: i for i in range(len(paths))}
    color_length = {i: len(p) for i, p in enumerate(paths)}
    vertex2idx: dict[int, int] = {}
    for i, path in enumerate(paths):
        for vid in path:
            vertex2idx.setdefault(vid, i)

    potential_joins: list[tuple[int, int, Edge]] = []
    for edge_pos, edge in enumerate(dig.edges()):
        if not edge.shadow:
            continue
        u, v = edge.v, edge.w
        if u not in vertex2idx or v not in vertex2idx:
            continue
        idx1 = vertex2idx[u]
        idx2 = vertex2idx[v]
        idx_l1_start = _index_of(paths[idx1], u)
        idx_l2_start = _index_of(paths[idx2], v)
        l1_end = color_length[idx1] - idx_l1_start - 1
        l2_end = color_length[idx2] - idx_l2_start - 1
        if idx1 != idx2 and l1_end < idx_l1_start and idx_l2_start < l2_end:
            potential_joins.append((l1_end + idx_l2_start, edge_pos, edge))
    potential_joins.sort(key=lambda t: (t[0], t[1]))

    for distance, _pos, edge in potential_joins:
        if distance > join_max_distance:
            break

        u, v = edge.v, edge.w
        idx1 = vertex2idx[u]
        idx2 = vertex2idx[v]

        def find_color(idx: int) -> int:
            while color_correction[idx] != idx:
                idx = color_correction[idx]
            return idx

        color1 = find_color(idx1)
        color2 = find_color(idx2)
        if color1 == color2:
            continue

        try:
            idx_l1 = paths[color1].index(u)
            idx_l2 = paths[color2].index(v)
        except ValueError:
            continue

        l1_end = color_length[color1] - idx_l1 - 1
        if l1_end + idx_l2 != distance:
            continue

        paths[color1] = paths[color1][: idx_l1 + 1] + paths[color2][idx_l2:]
        paths[color2] = []
        color_correction[color2] = color_correction[color1]
        color_length[color1] = len(paths[color1])
        color_length[color2] = 0

    return [p for p in paths if len(p) > 1]


def _index_of(path: list[int], vid: int) -> int:
    try:
        return path.index(vid)
    except ValueError:
        return len(path)
