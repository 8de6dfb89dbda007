"""Vertex contraction: fold contained reads into their containers.

Reference counterparts:
- ``sanityCheck`` (``libms/src/kernel/sc.cpp:29-90``)
- ``findContractionEdges`` / ``findContractionTargets`` /
  ``findDeletableVertices`` / ``contract`` / ``findDeletableEdges``
  (``src/main.cpp:416-549``)

Determinism: the reference fans these out as jobs with mutex-guarded
maps, so map contents are order-dependent races; here each phase sweeps
edges/orders in canonical edge-table order and neighbors sorted by
vertex id (the reference itself sorts neighbors via ``std::map`` in
``findContractionEdges``, ``main.cpp:425``).
"""

from __future__ import annotations

from dataclasses import dataclass

from muchsalsa_tpu_torch.graph.graph import Edge, EdgeOrder, Graph


def sanity_check(
    graph: Graph, subnode: int, node: int, target: int, order: EdgeOrder, wiggle_room: int
) -> bool:
    """sc.cpp:29-90 — does any (checkOn, checkFor) order pair agree?"""
    check_on = graph.get_edge(node, target)
    check_for = graph.get_edge(subnode, target)
    for on in check_on.orders:
        for fo in check_for.orders:
            is_sane = (order.direction == on.direction) == fo.direction

            if fo.contained and on.contained:
                is_sane &= (fo.start == target or fo.end == target) and on.start == target
            elif fo.contained and not on.contained:
                if fo.end != target:
                    l1 = l2 = l3 = False
                    if (not on.direction and on.end == target) or (
                        on.direction and on.end == target
                    ):
                        if not order.direction:
                            l2 = True
                    else:
                        l1 = True
                        l3 = True
                        if order.direction:
                            l2 = True
                    if not order.direction and order.base != order.end:
                        l1 = not l1
                    if not fo.direction and fo.base != fo.end:
                        l2 = not l2
                    d1 = order.left_offset if l1 else order.right_offset
                    d2 = fo.left_offset if l2 else fo.right_offset
                    d3 = on.left_offset if l3 else on.right_offset
                    is_sane &= (d1 + d2 + d3) < float(wiggle_room)
            elif not fo.contained and on.contained:
                is_sane &= on.start == target
            else:
                d1 = fo.start == target
                d2 = on.start == target
                if not fo.direction and fo.base == target:
                    d1 = not d1
                if not on.direction and on.base == target:
                    d2 = not d2
                if not order.direction:
                    d1 = not d1
                is_sane &= d1 == d2

            if is_sane:
                return True
    return False


def find_contraction_edges(
    graph: Graph, wiggle_room: int
) -> dict[Edge, EdgeOrder]:
    """main.cpp:416-463 — first contained+primary order per edge that is
    sane against every non-shadow neighbor of its start vertex."""
    result: dict[Edge, EdgeOrder] = {}
    for edge in graph.edges():
        for order in edge.orders:
            if not (order.contained and order.primary):
                continue
            is_sane = True
            for target_id in sorted(graph.neighbors(order.start)):
                subedge = graph.neighbors(order.start)[target_id]
                if target_id == order.end or subedge.shadow:
                    continue
                if not graph.has_edge(order.end, target_id):
                    is_sane = False
                    break
                if not sanity_check(graph, order.start, order.end, target_id, order, wiggle_room):
                    is_sane = False
                    break
            if is_sane:
                result[edge] = order
                break
    return result


def find_contraction_targets(
    graph: Graph, contraction_edges: dict[Edge, EdgeOrder]
) -> dict[int, int]:
    """main.cpp:465-482 — route each contracted start vertex to a target."""
    targets = {vid: vid for vid in graph.vertices}
    meta = lambda vid: graph.vertex(vid).meta_line  # noqa: E731
    for order in contraction_edges.values():
        contract_to = targets[order.end]
        if targets[order.start] == order.start or meta(targets[order.start]) > meta(contract_to):
            targets[order.start] = contract_to
    return targets


def find_deletable_vertices(
    contraction_edges: dict[Edge, EdgeOrder], targets: dict[int, int]
) -> tuple[set[int], set[int]]:
    """main.cpp:484-507 — returns (deletable vertices, contraction roots)."""
    deletable: set[int] = set()
    roots: set[int] = set()
    for order in contraction_edges.values():
        deletable.add(order.start)
        contract_to = targets[order.start]
        roots.add(contract_to)
        roots.discard(order.start)
    return deletable, roots


@dataclass
class ContainElement:
    """Reference ``matching::ContainElement`` (``MatchMap.h:80-87``):
    one contained read folded into a container vertex.  ``matches`` maps
    unitig id -> MatchStore row index of the *contained* read's match."""

    matches: dict[int, int]
    nano: int
    nano_length: int
    score: float
    direction: bool
    is_primary: bool


def contract(
    contraction_edges: dict[Edge, EdgeOrder],
    roots: set[int],
    match_row,
    vertex_length,
) -> dict[int, list[ContainElement]]:
    """main.cpp:509-531.  ``match_row(nano, illu) -> row | -1``;
    ``vertex_length(vid) -> int``."""
    contain: dict[int, list[ContainElement]] = {}
    for order in contraction_edges.values():
        if order.end not in roots:
            continue
        matches = {}
        for illu in order.ids:
            row = match_row(order.start, illu)
            if row >= 0:
                matches[illu] = row
        contain.setdefault(order.end, []).append(
            ContainElement(
                matches=matches,
                nano=order.start,
                nano_length=vertex_length(order.start),
                score=order.score,
                direction=order.direction,
                is_primary=order.primary,
            )
        )
    return contain


def prune_contained_orders(graph: Graph) -> list[Edge]:
    """main.cpp:534-549 — drop contained orders everywhere; edges left
    orderless are returned for deletion."""
    deletable: list[Edge] = []
    for edge in graph.edges():
        filtered = [o for o in edge.orders if not o.contained]
        if not filtered:
            deletable.append(edge)
        edge.orders = filtered
    return deletable
