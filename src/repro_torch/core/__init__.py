"""Core: the paper's consensus-ADMM engine with adaptive penalty schedules."""
from repro_torch.core.admm import (ConsensusADMM, ConsensusState,
                                   consensus_error)
from repro_torch.core.graph import (TOPOLOGIES, Graph, build_graph,
                                    chain_graph, cluster_graph,
                                    complete_graph, connected_components,
                                    drop_node, expander_graph, ring_graph,
                                    star_graph, torus_graph)
from repro_torch.core.penalty import (SCHEMES, PenaltyConfig, PenaltyState,
                                      budget_exhausted, compute_tau,
                                      effective_eta, init_penalty_state,
                                      update_penalty)
from repro_torch.core.residuals import (Residuals, local_residuals,
                                        neighbor_mean, node_eta)

__all__ = [
    "ConsensusADMM", "ConsensusState", "consensus_error",
    "Graph", "TOPOLOGIES", "build_graph", "chain_graph", "cluster_graph",
    "complete_graph", "connected_components", "drop_node", "expander_graph",
    "ring_graph", "star_graph", "torus_graph",
    "SCHEMES", "PenaltyConfig", "PenaltyState", "budget_exhausted",
    "compute_tau", "effective_eta", "init_penalty_state", "update_penalty",
    "Residuals", "local_residuals", "neighbor_mean", "node_eta",
]
