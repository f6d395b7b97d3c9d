"""Graph substrate of the port: CSR structures, generators, orderings,
bitset packing. Host numpy code (the k-core peel on a torch device), a
standalone copy of the reference package's graph layer (importing the
reference would load JAX)."""
from repro_torch.graph.csr import CSRGraph, from_edge_list, induced_subgraph
from repro_torch.graph.generators import (
    erdos_renyi,
    barabasi_albert,
    random_geometric,
    grid_road,
    moon_moser,
    complete_graph,
    caveman,
    kronecker,
)
from repro_torch.graph.order import (degeneracy_order, core_numbers,
                                     kcore_peel_torch)

__all__ = [
    "CSRGraph",
    "from_edge_list",
    "induced_subgraph",
    "erdos_renyi",
    "barabasi_albert",
    "random_geometric",
    "grid_road",
    "moon_moser",
    "complete_graph",
    "caveman",
    "kronecker",
    "degeneracy_order",
    "core_numbers",
    "kcore_peel_torch",
]
