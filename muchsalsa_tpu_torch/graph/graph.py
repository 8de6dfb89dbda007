"""Host-side overlap graph structures.

Reference counterpart: ``GraphBase`` / ``Graph`` / ``DiGraph``
(``include/ms/graph/Graph.h:109-741``, ``libms/src/graph/Graph.cpp``),
``Vertex`` (``graph/Vertex.h:50-219``) and ``Edge``/``EdgeOrder``
(``graph/Edge.h:49-219``).

Design differences:

- No mutexes: graph mutation phases are data-parallel array passes (see
  ``muchsalsa_tpu_torch.ops``) or single-threaded host sweeps; the graphs here
  orchestrate only the irregular reduction steps.
- Deterministic iteration everywhere the reference used unordered maps:
  vertices and edges iterate in insertion order, neighbor sweeps sort by
  vertex id.  This defines a canonical total order where the reference's
  output depends on incidental hash order (SURVEY.md §7 "hard parts").
- Vertices are shared ``VertexInfo`` records (a pool keyed by id), so a
  direction assigned while orienting a component's DiGraph is visible to
  every (sub)graph holding that vertex — same aliasing the reference
  gets from ``shared_ptr<Vertex>`` (``Graph.cpp:62-78``, ``dg.cpp:50-54``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional


class Direction:
    """Orientation constants (reference ``types/Direction.h:40-42``)."""

    POS = 1
    NEG = -1
    NONE = 0


@dataclass
class VertexInfo:
    id: int
    nanopore_length: int = 0
    meta_line: int = -1
    direction: int = Direction.NONE  # mutable; set during orientation phase


@dataclass(frozen=True)
class EdgeOrder:
    """One overlap hypothesis (reference ``graph/Edge.h:49-60``)."""

    start: int            # start vertex id
    end: int              # end vertex id
    left_offset: float
    right_offset: float
    contained: bool
    base: int             # base vertex id (always edge's first vertex)
    score: float
    ids: tuple[int, ...]  # unitig (illumina) ids of the chain
    direction: bool
    primary: bool


class Edge:
    """Mutable edge record; identity-hashed like the reference's ``Edge*``."""

    __slots__ = ("v", "w", "shadow", "weight", "consensus_direction", "orders", "em_idx")

    def __init__(self, v: int, w: int):
        self.v = v
        self.w = w
        self.shadow = False
        self.weight = 0.0
        self.consensus_direction = Direction.NONE
        self.orders: list[EdgeOrder] = []
        # index into the undirected EdgeMatches table; carried onto
        # DiGraph edges (the reference instead copies EdgeMatch records
        # onto new edges, dg.cpp:99-101)
        self.em_idx = -1

    def other(self, vid: int) -> int:
        return self.w if vid == self.v else self.v

    def __repr__(self) -> str:  # pragma: no cover
        return f"Edge({self.v},{self.w},shadow={self.shadow},orders={len(self.orders)})"


class _GraphBase:
    def __init__(self) -> None:
        self.vertices: dict[int, VertexInfo] = {}

    # -- vertices ------------------------------------------------------------

    def add_vertex(self, info: VertexInfo) -> VertexInfo:
        return self.vertices.setdefault(info.id, info)

    def has_vertex(self, vid: int) -> bool:
        return vid in self.vertices

    def vertex(self, vid: int) -> VertexInfo:
        return self.vertices[vid]

    @property
    def order(self) -> int:
        return len(self.vertices)


class Graph(_GraphBase):
    """Undirected overlap graph (reference ``Graph.h:434-533``)."""

    def __init__(self) -> None:
        super().__init__()
        self._adj: dict[int, dict[int, Edge]] = {}
        self._edges: dict[tuple[int, int], Edge] = {}

    # -- edges ---------------------------------------------------------------

    def add_edge(self, u: int, v: int) -> Edge:
        if v in self._adj.get(u, ()):  # already present
            return self._adj[u][v]
        edge = Edge(u, v)
        self._edges[(u, v)] = edge
        self._adj.setdefault(u, {})[v] = edge
        self._adj.setdefault(v, {})[u] = edge
        return edge

    def has_edge(self, u: int, v: int) -> bool:
        return v in self._adj.get(u, ())

    def get_edge(self, u: int, v: int) -> Optional[Edge]:
        return self._adj.get(u, {}).get(v)

    def edges(self) -> list[Edge]:
        return list(self._edges.values())

    @property
    def size(self) -> int:
        return len(self._edges)

    def neighbors(self, vid: int) -> dict[int, Edge]:
        return self._adj.get(vid, {})

    def delete_edge(self, edge: Edge) -> None:
        key = (edge.v, edge.w)
        if key not in self._edges:
            return
        del self._edges[key]
        self._adj[edge.v].pop(edge.w, None)
        self._adj[edge.w].pop(edge.v, None)

    def delete_vertex(self, vid: int) -> None:
        if vid not in self.vertices:
            return
        for edge in list(self._adj.get(vid, {}).values()):
            self.delete_edge(edge)
        self._adj.pop(vid, None)
        del self.vertices[vid]

    def subgraph(self, vertex_ids: Iterable[int]) -> "Graph":
        """Vertex-induced subgraph sharing VertexInfo and Edge objects
        (reference ``Graph::getSubgraph``, ``Graph.cpp:319-328``)."""
        wanted = set(vertex_ids)
        sub = Graph()
        for vid in self.vertices:
            if vid in wanted:
                sub.add_vertex(self.vertices[vid])
        for (u, v), edge in self._edges.items():
            if u in wanted and v in wanted:
                sub._edges[(u, v)] = edge
                sub._adj.setdefault(u, {})[v] = edge
                sub._adj.setdefault(v, {})[u] = edge
        return sub


class DiGraph(_GraphBase):
    """Directed graph with degree maps + topological sort
    (reference ``Graph.h:545-741``, ``Graph.cpp:336-395``)."""

    def __init__(self) -> None:
        super().__init__()
        self._succ: dict[int, dict[int, Edge]] = {}
        self._pred: dict[int, dict[int, Edge]] = {}
        self._edges: dict[tuple[int, int], Edge] = {}

    def add_vertex(self, info: VertexInfo) -> VertexInfo:
        info = super().add_vertex(info)
        self._succ.setdefault(info.id, {})
        self._pred.setdefault(info.id, {})
        return info

    def add_edge(self, u: int, v: int) -> Edge:
        if (u, v) in self._edges:
            return self._edges[(u, v)]
        edge = Edge(u, v)
        self._edges[(u, v)] = edge
        self._succ.setdefault(u, {})[v] = edge
        self._pred.setdefault(v, {})[u] = edge
        return edge

    def has_edge(self, u: int, v: int) -> bool:
        return (u, v) in self._edges

    def get_edge(self, u: int, v: int) -> Optional[Edge]:
        return self._edges.get((u, v))

    def edges(self) -> list[Edge]:
        return list(self._edges.values())

    @property
    def size(self) -> int:
        return len(self._edges)

    def successors(self, vid: int) -> dict[int, Edge]:
        return self._succ.get(vid, {})

    def predecessors(self, vid: int) -> dict[int, Edge]:
        return self._pred.get(vid, {})

    def out_degree(self, vid: int) -> int:
        return len(self._succ.get(vid, ()))

    def in_degree(self, vid: int) -> int:
        return len(self._pred.get(vid, ()))

    def delete_edge(self, edge: Edge) -> None:
        key = (edge.v, edge.w)
        if key not in self._edges:
            return
        del self._edges[key]
        self._succ[edge.v].pop(edge.w, None)
        self._pred[edge.w].pop(edge.v, None)

    def delete_vertex(self, vid: int) -> None:
        if vid not in self.vertices:
            return
        for edge in list(self._succ.get(vid, {}).values()):
            self.delete_edge(edge)
        for edge in list(self._pred.get(vid, {}).values()):
            self.delete_edge(edge)
        self._succ.pop(vid, None)
        self._pred.pop(vid, None)
        del self.vertices[vid]

    def copy(self) -> "DiGraph":
        """Shallow structural copy sharing VertexInfo and Edge objects
        (mirrors ``auto diGraphCycle = *pDiGraph`` in lg.cpp:350)."""
        dup = DiGraph()
        for info in self.vertices.values():
            dup.add_vertex(info)
        for (u, v), edge in self._edges.items():
            dup._edges[(u, v)] = edge
            dup._succ.setdefault(u, {})[v] = edge
            dup._pred.setdefault(v, {})[u] = edge
        return dup

    def sort_topologically(self) -> list[int]:
        """Kahn's algorithm, LIFO like the reference (``Graph.cpp:358-394``
        pops from the back), seeds in insertion order, successors sorted.
        On a cyclic graph this returns a *partial* order silently — the
        reference does the same, and the anchor DiGraph in consensus can
        be cyclic."""
        in_deg = {vid: self.in_degree(vid) for vid in self.vertices}
        stack = [vid for vid, d in in_deg.items() if d == 0]
        out: list[int] = []
        while stack:
            vid = stack.pop()
            out.append(vid)
            for succ in sorted(self._succ.get(vid, ())):
                in_deg[succ] -= 1
                if in_deg[succ] == 0:
                    stack.append(succ)
        return out


def shortest_path(graph: Graph, u: int, v: int) -> list[int]:
    """Unweighted shortest path u -> v by BFS, deterministic neighbor
    order (reference ``GraphUtil::getShortestPath``, ``Graph.h:927-992``)."""
    from collections import deque

    if u == v:
        return [u]
    prev: dict[int, int] = {u: u}
    queue = deque([u])
    while queue:
        cur = queue.popleft()
        for nb in sorted(graph.neighbors(cur)):
            if nb in prev:
                continue
            prev[nb] = cur
            if nb == v:
                path = [v]
                while path[-1] != u:
                    path.append(prev[path[-1]])
                path.reverse()
                return path
            queue.append(nb)
    return []
