"""Dynamic topology: edge gating, layout-preserving churn and rewiring,
and the async executor's staleness clocks (port of ``repro/topology``)."""
from repro_torch.topology.schedulers import (SCHEDULERS, TopologyConfig,
                                             budget_gate, update_topology)
from repro_torch.topology.state import (TopologyState, active_degree,
                                        active_edge_fraction, advance,
                                        compose_mask, from_numpy,
                                        init_topology_state, sym_age,
                                        tick_age)
from repro_torch.topology.runtime import (TopologyRuntime, rotation_masks,
                                          spanning_backbone)

__all__ = [
    "SCHEDULERS", "TopologyConfig", "budget_gate", "update_topology",
    "TopologyState", "active_degree", "active_edge_fraction", "advance",
    "compose_mask", "from_numpy", "init_topology_state", "sym_age",
    "tick_age",
    "TopologyRuntime", "rotation_masks", "spanning_backbone",
]
