"""Execution across ranks: which rank holds which nodes, the circulant
neighbour exchange and the node gathers of the consensus round."""
from repro_torch.distributed.exchange import (HostStaging, Pending,
                                              circulant_into,
                                              circulant_start, gather_nodes,
                                              gather_pod, segments)
from repro_torch.distributed.grid import RankGrid, trivial_grid

__all__ = ["HostStaging", "Pending", "RankGrid", "circulant_into",
           "circulant_start", "gather_nodes", "gather_pod", "segments",
           "trivial_grid"]
