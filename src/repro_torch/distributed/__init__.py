"""Execution across ranks: which rank holds which nodes, the circulant
neighbour exchange and the node gathers of the consensus round, the
``(data, model)`` mesh and its rules (``sharding``), and a node's
parameters and moments sharded over its in-pod ranks (``fsdp``)."""
from repro_torch.distributed.exchange import (HostStaging, Pending,
                                              all_gather, all_to_all,
                                              circulant_into,
                                              circulant_start, gather_nodes,
                                              gather_pod, segments)
from repro_torch.distributed.grid import RankGrid, trivial_grid
from repro_torch.distributed.sharding import (Mesh, MeshStats, current_mesh,
                                              local_mesh, use_mesh)

__all__ = ["HostStaging", "Mesh", "MeshStats", "Pending", "RankGrid",
           "all_gather", "all_to_all", "circulant_into", "circulant_start",
           "current_mesh", "gather_nodes", "gather_pod", "local_mesh",
           "segments", "trivial_grid", "use_mesh"]
