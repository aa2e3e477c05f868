from repro_torch.graphs.generators import erdos_renyi, grid2d, random_regular
from repro_torch.graphs.graph import Graph, from_edges

__all__ = ["Graph", "from_edges", "grid2d", "erdos_renyi", "random_regular"]
