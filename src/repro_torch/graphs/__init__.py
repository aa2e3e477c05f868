from repro_torch.graphs.generators import (
    GRAPH_SUITE,
    GraphSpec,
    delaunay_like,
    erdos_renyi,
    generate,
    grid2d,
    powerlaw,
    preferential_attachment,
    random_regular,
    rmat,
    web_like,
)
from repro_torch.graphs.graph import Graph, from_edges

__all__ = [
    "Graph", "from_edges", "GRAPH_SUITE", "GraphSpec", "delaunay_like", "erdos_renyi",
    "generate", "grid2d", "powerlaw", "preferential_attachment", "random_regular", "rmat",
    "web_like",
]
