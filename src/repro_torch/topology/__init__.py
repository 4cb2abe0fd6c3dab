"""Dynamic topology: edge gating, layout-preserving churn and rewiring
(port of ``repro/topology``; the staleness clocks ``tick_age`` and
``sym_age`` come with the async slice)."""
from repro_torch.topology.schedulers import (SCHEDULERS, TopologyConfig,
                                             budget_gate, update_topology)
from repro_torch.topology.state import (TopologyState, active_degree,
                                        active_edge_fraction, advance,
                                        compose_mask, from_numpy,
                                        init_topology_state)
from repro_torch.topology.runtime import (TopologyRuntime, rotation_masks,
                                          spanning_backbone)

__all__ = [
    "SCHEDULERS", "TopologyConfig", "budget_gate", "update_topology",
    "TopologyState", "active_degree", "active_edge_fraction", "advance",
    "compose_mask", "from_numpy", "init_topology_state",
    "TopologyRuntime", "rotation_masks", "spanning_backbone",
]
