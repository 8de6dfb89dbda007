"""Orientation propagation: undirected component -> directed graph.

Reference counterpart: ``getDirectedGraph`` (``libms/src/kernel/dg.cpp:35-121``).
DFS from the longest read; each vertex receives an orientation (the
XNOR-product of consensus directions along the DFS path); each
undirected edge's orders are copied onto directed edges whose
orientation follows the per-order ``(direction, baseVertex, current
orientation)`` flip rule (dg.cpp:75-105).

Determinism: neighbor iteration is sorted by vertex id (the reference
iterates an unordered map).
"""

from __future__ import annotations

from muchsalsa_tpu_torch.graph.graph import DiGraph, Direction, Graph


def get_directed_graph(graph: Graph, component: Graph, start: int) -> DiGraph:
    stack: list[tuple[int, bool]] = [(start, True)]
    dig = DiGraph()

    while stack:
        cur, cur_dir = stack.pop()

        if not dig.has_vertex(cur):
            dig.add_vertex(graph.vertex(cur))
        if graph.vertex(cur).direction == Direction.NONE:
            dig.vertex(cur).direction = Direction.POS if cur_dir else Direction.NEG

        neighbors = component.neighbors(cur)
        for nb in sorted(neighbors):
            edge = neighbors[nb]
            other_exists = dig.has_vertex(nb)
            if other_exists:
                other_exists = graph.vertex(nb).direction != Direction.NONE
            if not other_exists:
                dig.add_vertex(component.vertex(nb))

            if dig.has_edge(edge.v, edge.w) or dig.has_edge(edge.w, edge.v):
                continue

            for order in edge.orders:
                flip = False
                if not order.direction and order.base == nb:
                    flip = not flip
                if not cur_dir:
                    flip = not flip

                s, e = order.start, order.end
                if flip:
                    s, e = e, s

                new_edge = dig.get_edge(s, e)
                if new_edge is None:
                    new_edge = dig.add_edge(s, e)
                    new_edge.shadow = edge.shadow
                    if not edge.shadow:
                        new_edge.weight = edge.weight
                    new_edge.em_idx = edge.em_idx
                new_edge.orders.append(order)

            if edge.consensus_direction == Direction.NONE:
                continue

            next_mod = cur_dir == (edge.consensus_direction == Direction.POS)
            if not other_exists:
                stack.append((nb, next_mod))

    return dig


def pick_start_vertex(component: Graph) -> int | None:
    """Longest nanopore read; first max in canonical vertex order
    (reference ``std::max_element``, main.cpp:627-630)."""
    best = None
    best_len = -1
    for vid, info in component.vertices.items():
        if info.nanopore_length > best_len:
            best_len = info.nanopore_length
            best = vid
    return best
