"""Graphs and the paper's penalty schedules."""
from repro_torch.core.graph import (TOPOLOGIES, Graph, build_graph,
                                    connected_components, drop_node)
from repro_torch.core.penalty import (SCHEMES, PenaltyConfig, PenaltyState,
                                      budget_exhausted, compute_tau,
                                      effective_eta, init_penalty_state,
                                      update_penalty)

__all__ = ["SCHEMES", "TOPOLOGIES", "Graph", "PenaltyConfig", "PenaltyState",
           "budget_exhausted", "build_graph", "compute_tau",
           "connected_components", "drop_node", "effective_eta",
           "init_penalty_state", "update_penalty"]
