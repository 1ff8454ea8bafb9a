from kgc_gcn_torch.data.batching import QueryBank, make_banks, make_query_bank
from kgc_gcn_torch.data.dataset import KGDataset, build_dataset, load_dataset
from kgc_gcn_torch.data.graph import Graph, GraphHalf, build_graph

__all__ = [
    "KGDataset", "build_dataset", "load_dataset",
    "Graph", "GraphHalf", "build_graph",
    "QueryBank", "make_banks", "make_query_bank",
]
