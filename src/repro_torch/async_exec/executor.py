"""Host loop of bounded-staleness consensus rounds (port of
``repro/async_exec/executor.py``).

``AsyncExecutor`` joins the trainer's ``consensus_step_async`` (the round:
wire ledger, staleness clocks, the edge-gated kernel with zero-kick
absorption) to the ``RoundClock`` event model (which nodes advance this
fleet tick, which payloads landed) and keeps the modelled wall clock. All
numerics live in the trainer, all timing in the clock.
"""
from __future__ import annotations

import numpy as np

from repro_torch.async_exec.clock import RoundClock
from repro_torch.obs import export as obs_export
from repro_torch.obs.trace import host_span_factory


class AsyncExecutor:
    """Drives a ``ConsensusTrainer`` with bounded-staleness rounds.

    Args:
      trainer: a ``repro_torch.optim.ConsensusTrainer`` built with
        ``ConsensusConfig(async_exec=AsyncConfig(...))``.
      clock: a ``RoundClock``; None models a homogeneous fleet (every
        payload always arrives).
    """

    def __init__(self, trainer, clock: RoundClock | None = None):
        if trainer.async_cfg is None:
            raise ValueError("trainer was built without ConsensusConfig."
                             "async_exec — nothing to execute")
        self.trainer = trainer
        self.cfg = trainer.async_cfg
        if clock is None:
            clock = RoundClock(compute_s=np.ones(trainer.num_nodes),
                               wire_s=0.0, offsets=tuple(trainer.offsets))
        if clock.num_nodes != trainer.num_nodes:
            raise ValueError(f"clock models {clock.num_nodes} nodes, "
                             f"trainer has {trainer.num_nodes}")
        self.clock = clock
        self._hspan = host_span_factory(
            trainer.obs_on and trainer.obs_cfg.with_spans)

    def consensus_round(self, state, probe_batch):
        """One fleet tick: clock -> (arrivals, advance) -> the round.

        With ``max_staleness=0`` the executor waits for everything: every
        payload arrives and every node advances, the synchronous round.
        The clock's host arrays go to the trainer, which moves them to its
        device once.
        """
        j = self.trainer.num_nodes
        deg = max(len(self.trainer.offsets), 1)
        if self.cfg.max_staleness == 0:
            arrivals = np.ones((deg, j), dtype=bool)
            advance = None
            self.clock.time_s += self.clock.sync_round_s
            self.clock.ticks += 1
        else:
            arrivals, advance = self.clock.tick()
        with self._hspan("round/async"):
            return self.trainer.consensus_step_async(state, probe_batch,
                                                     arrivals, advance)

    @property
    def async_elapsed_s(self) -> float:
        """Modelled wall clock spent so far. Ticks and synchronous rounds
        are not interchangeable (a tick advances only some nodes), so
        executors compare by progress to a target, not by rounds."""
        return float(self.clock.time_s)

    def summary(self) -> dict:
        c = self.clock
        rounds = np.asarray(c.rounds_done, dtype=np.int64)
        # per-node lag behind the fleet's front-runner, in rounds
        lag = (rounds.max() - rounds) if rounds.size else rounds
        return {
            "ticks": int(c.ticks),
            "rounds_done": rounds.tolist(),
            "round_lag": lag.tolist(),
            "lag_p50": float(np.percentile(lag, 50)) if lag.size else 0.0,
            "lag_p90": float(np.percentile(lag, 90)) if lag.size else 0.0,
            "lag_p100": float(lag.max()) if lag.size else 0.0,
            "async_elapsed_s": round(self.async_elapsed_s, 6),
            "sync_round_s": round(c.sync_round_s, 6),
            "tick_s": round(c.tick_s, 6),
            "max_staleness": self.cfg.max_staleness,
        }

    def export_timeline(self, path: str) -> str:
        """Write the clock's modelled timeline as a Chrome/Perfetto trace
        (``obs.export.write_roundclock_trace``): per-node compute and wire
        tracks from the clock's event model, to load next to a measured
        ``--profile-rounds`` trace."""
        return obs_export.write_roundclock_trace(self.clock, path)
