"""Graphs and the paper's penalty schedules."""
from repro_torch.core.graph import TOPOLOGIES, Graph, build_graph
from repro_torch.core.penalty import (SCHEMES, PenaltyConfig, PenaltyState,
                                      compute_tau, effective_eta,
                                      init_penalty_state, update_penalty)

__all__ = ["SCHEMES", "TOPOLOGIES", "Graph", "PenaltyConfig", "PenaltyState",
           "build_graph", "compute_tau", "effective_eta",
           "init_penalty_state", "update_penalty"]
