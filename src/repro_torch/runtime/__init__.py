"""Runtime fault tolerance: retries, straggler detection, elastic churn."""
from repro_torch.runtime.fault_tolerance import (ElasticController,
                                                 ElasticEvent, RetryPolicy,
                                                 StragglerMonitor,
                                                 aged_out_nodes,
                                                 node_durations,
                                                 shrink_penalty_state,
                                                 with_retries)

__all__ = ["ElasticController", "ElasticEvent", "RetryPolicy",
           "StragglerMonitor", "aged_out_nodes", "node_durations",
           "shrink_penalty_state", "with_retries"]
