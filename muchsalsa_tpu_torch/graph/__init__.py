from muchsalsa_tpu_torch.graph.graph import (
    DiGraph,
    Edge,
    EdgeOrder,
    Graph,
    VertexInfo,
    Direction,
    shortest_path,
)

__all__ = [
    "DiGraph",
    "Edge",
    "EdgeOrder",
    "Graph",
    "VertexInfo",
    "Direction",
    "shortest_path",
]
