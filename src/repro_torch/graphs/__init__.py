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
from repro_torch.graphs.graph import Graph, build_csr, from_edges, pad_graph, to_networkx
from repro_torch.graphs.partition import pad_to_multiple, partition_edges, partition_rows

__all__ = [
    "Graph", "build_csr", "from_edges", "pad_graph", "to_networkx",
    "GRAPH_SUITE", "GraphSpec", "delaunay_like", "erdos_renyi", "generate", "grid2d",
    "powerlaw", "preferential_attachment", "random_regular", "rmat", "web_like",
    "partition_edges", "partition_rows", "pad_to_multiple",
]
