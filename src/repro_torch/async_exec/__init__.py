"""Bounded-staleness async consensus executor (port of
``repro/async_exec``): the wire ledger, the round clock and the host
loop. The round itself is ``ConsensusTrainer.consensus_step_async``."""
from repro_torch.async_exec.clock import RoundClock, straggler_compute
from repro_torch.async_exec.executor import AsyncExecutor
from repro_torch.async_exec.ledger import (AsyncConfig, WireLedger,
                                           from_numpy, init_wire_ledger,
                                           wire_row_dtype, wire_width)

__all__ = [
    "AsyncConfig", "AsyncExecutor", "RoundClock", "WireLedger",
    "from_numpy", "init_wire_ledger", "straggler_compute", "wire_row_dtype",
    "wire_width",
]
