"""Edge weighting, maximum spanning tree, de-cycling, components.

Reference counterparts:
- ``computeBitweight`` (``src/main.cpp:551-573``)
- ``getMaxSpanTree`` (Kruskal, ``libms/src/kernel/mst.cpp:75-111``)
- ``decycle`` (``src/main.cpp:575-618``) with constants
  ``BASE_WEIGHT_MULTIPLICATOR``/``MAX_WEIGHT_MULTIPLICATOR``
  (``main.cpp:96-97``)
- ``getConnectedComponents`` (``libms/src/kernel/cc.cpp:34-71``)

Determinism: Kruskal ties (equal weights) break on the canonical edge
order (vertex meta lines) instead of the reference's unstable pointer
sort (``mst.cpp:82-83``).
"""

from __future__ import annotations

from collections import deque

from muchsalsa_tpu_torch.graph.graph import Direction, Edge, Graph, shortest_path


def compute_bitweights(graph: Graph) -> None:
    """main.cpp:551-573 — weight + consensus direction per edge."""
    for edge in graph.edges():
        orders = edge.orders
        if not orders:
            continue
        if edge.shadow:
            initial = orders[0].direction
            if all(o.direction == initial for o in orders):
                edge.consensus_direction = Direction.POS if initial else Direction.NEG
        else:
            edge.weight = orders[0].score
            edge.consensus_direction = Direction.POS if orders[0].direction else Direction.NEG


class _UnionFind:
    """Path-compressed, size-weighted union-find (mst.cpp:35-73)."""

    def __init__(self) -> None:
        self.parent: dict[int, int] = {}
        self.weight: dict[int, int] = {}

    def find(self, x: int) -> int:
        if x not in self.parent:
            self.parent[x] = x
            self.weight[x] = 1
            return x
        path = [x]
        root = self.parent[x]
        while root != path[-1]:
            path.append(root)
            root = self.parent[root]
        for node in path:
            self.parent[node] = root
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        # note: reference compares m_weights[pV2]/[pV1] on the *inputs*,
        # not the roots (mst.cpp:62) — reproduced here.
        if self.weight.get(b, 1) > self.weight.get(a, 1):
            ra, rb = rb, ra
        self.weight[ra] += self.weight[rb]
        self.parent[rb] = ra


def max_span_tree(graph: Graph) -> Graph:
    """Kruskal *maximum* spanning forest over direction-consistent edges."""
    candidates = [e for e in graph.edges() if e.consensus_direction != Direction.NONE]
    # descending weight; ties by canonical position in the edge list
    order = {id(e): i for i, e in enumerate(candidates)}
    candidates.sort(key=lambda e: (-e.weight, order[id(e)]))

    tree = Graph()
    for vid, info in graph.vertices.items():
        tree.add_vertex(info)
    uf = _UnionFind()
    for edge in candidates:
        if uf.find(edge.v) != uf.find(edge.w):
            # share the Edge object like the reference shares shared_ptrs
            tree._edges[(edge.v, edge.w)] = edge
            tree._adj.setdefault(edge.v, {})[edge.w] = edge
            tree._adj.setdefault(edge.w, {})[edge.v] = edge
            uf.union(edge.v, edge.w)
    return tree


class _TreePaths:
    """O(path)-time unique-path queries on a spanning forest: one BFS
    per component precomputes parent/depth, then queries climb parent
    pointers.  Identical output to ``shortest_path`` on the tree (tree
    paths are unique), without the per-query whole-component BFS the
    reference does (``GraphUtil::getShortestPath`` from ``decycle``,
    ``main.cpp:591``)."""

    def __init__(self, tree: Graph):
        from collections import deque

        self.parent: dict[int, int] = {}
        self.depth: dict[int, int] = {}
        for root in tree.vertices:
            if root in self.parent:
                continue
            self.parent[root] = root
            self.depth[root] = 0
            queue = deque([root])
            while queue:
                cur = queue.popleft()
                for nb in tree.neighbors(cur):
                    if nb in self.parent:
                        continue
                    self.parent[nb] = cur
                    self.depth[nb] = self.depth[cur] + 1
                    queue.append(nb)

    def path(self, u: int, v: int) -> list[int]:
        if u not in self.depth or v not in self.depth:
            return []
        up, vp = u, v
        left: list[int] = [up]
        right: list[int] = [vp]
        while self.depth[up] > self.depth[vp]:
            up = self.parent[up]
            left.append(up)
        while self.depth[vp] > self.depth[up]:
            vp = self.parent[vp]
            right.append(vp)
        while up != vp:
            if self.parent[up] == up:  # different components
                return []
            up = self.parent[up]
            left.append(up)
            vp = self.parent[vp]
            right.append(vp)
        return left + right[-2::-1]


def decycle(
    graph: Graph,
    tree: Graph,
    base_weight_multiplicator: float = 1.1,
    max_weight_multiplicator: float = 0.8,
) -> set[Edge]:
    """main.cpp:575-618 — detect orientation-inconsistent off-tree edges
    and nominate edges for deletion."""
    deletable: set[Edge] = set()
    tree_paths = _TreePaths(tree)
    for edge in graph.edges():
        if edge.consensus_direction == Direction.NONE:
            continue
        if tree.has_edge(edge.v, edge.w):
            continue
        path = tree_paths.path(edge.v, edge.w)
        direction = edge.consensus_direction == Direction.POS
        weights: list[float] = []
        path_edges: list[Edge] = []
        for a, b in zip(path, path[1:]):
            pe = graph.get_edge(a, b)
            direction = direction == (pe.consensus_direction == Direction.POS)
            weights.append(float(pe.weight))
            path_edges.append(pe)

        if not direction and weights:
            min_idx = min(range(len(weights)), key=lambda i: (weights[i], i))
            min_w = weights[min_idx]
            max_w = max(weights)
            base = float(edge.weight)
            if min_w < base or (
                base * base_weight_multiplicator >= min_w
                and min_w < max_w * max_weight_multiplicator
            ):
                deletable.add(path_edges[min_idx])
            deletable.add(edge)
    return deletable


def connected_components(graph: Graph) -> list[list[int]]:
    """cc.cpp:34-71 — BFS components over direction-consistent edges."""
    visited: set[int] = set()
    components: list[list[int]] = []
    for source in graph.vertices:
        if source in visited:
            continue
        component = [source]
        visited.add(source)
        queue = deque([source])
        while queue:
            cur = queue.popleft()
            for nb in sorted(graph.neighbors(cur)):
                edge = graph.neighbors(cur)[nb]
                if nb not in visited and edge.consensus_direction != Direction.NONE:
                    component.append(nb)
                    visited.add(nb)
                    queue.append(nb)
        components.append(component)
    return components
