"""Execution across ranks: which rank holds which nodes, the circulant
neighbour exchange and the node gathers of the consensus round."""
from repro_torch.distributed.exchange import (HostStaging, circulant_into,
                                              gather_nodes, gather_pod,
                                              segments)
from repro_torch.distributed.grid import RankGrid, trivial_grid

__all__ = ["HostStaging", "RankGrid", "circulant_into", "gather_nodes",
           "gather_pod", "segments", "trivial_grid"]
