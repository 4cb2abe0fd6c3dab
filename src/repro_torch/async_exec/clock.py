"""Discrete-event round clock for the bounded-staleness executor (the
port's own copy of ``repro/async_exec/clock.py``; host numpy, the same
event model).

The numerics of an async round are exact: stale payloads really feed the
fused round. What one process cannot produce is the wall clock of a fleet
with nodes of different speeds. ``RoundClock`` models it: J nodes, node i
taking ``compute_s[i]`` seconds per consensus round (H local steps and the
round) and ``wire_s`` seconds for a payload to cross the network.

One ``tick()`` advances the time by the fastest node's round and reports,
for that fleet tick,

  * ``advance`` [J] — which nodes completed a round (a 2x slow node
    advances every other tick);
  * ``arrivals`` [deg, J] — which directed edges' payloads landed fresh
    since the receiver's last read (a sender's newest landed payload
    supersedes older unread ones).

Timing model: async rounds overlap the exchange with compute, so a node's
round takes its compute time and a payload sent at a round's end lands
``wire_s`` later; a synchronous round barriers on the slowest node and
then exchanges, ``sync_round_s = max(compute_s) + wire_s``. The times are
modelled, not measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RoundClock:
    """Event clock for one fleet. Mutable: ``tick()`` advances it."""

    compute_s: np.ndarray          # [J] per-node seconds per round
    wire_s: float                  # network latency of one payload
    offsets: tuple                 # the trainer's offset schedule

    def __post_init__(self):
        self.compute_s = np.asarray(self.compute_s, dtype=float)
        j = self.num_nodes
        if (self.compute_s <= 0).any():
            raise ValueError("compute_s must be positive")
        self.time_s = 0.0
        self.ticks = 0
        self.rounds_done = np.zeros(j, dtype=int)
        self.next_done = self.compute_s.copy()      # first completion times
        # last send id consumed per (receiver, sender); the initial params
        # are send id 0, landed at t=0 and unread (-1), so the first read
        # of every edge is fresh and the zero-filled ledger is never used
        self.last_read = np.full((j, j), -1, dtype=int)

    @property
    def num_nodes(self) -> int:
        return int(self.compute_s.shape[0])

    @property
    def tick_s(self) -> float:
        """Async fleet tick: the fastest node's round time."""
        return float(self.compute_s.min())

    @property
    def sync_round_s(self) -> float:
        """Synchronous round: barrier on the slowest node, then exchange."""
        return float(self.compute_s.max()) + float(self.wire_s)

    def _latest_landed(self, t: float) -> np.ndarray:
        """[J] newest send id of each node landed by time t: send id k (the
        node's k-th completed round) lands at ``k * compute_s + wire_s``,
        id 0 (the initial params) at 0."""
        k = np.floor((t - self.wire_s) / self.compute_s).astype(int)
        return np.maximum(k, 0)

    def tick(self) -> tuple[np.ndarray, np.ndarray]:
        """Advance one fleet tick -> (arrivals [deg, J], advance [J])."""
        j = self.num_nodes
        self.time_s += self.tick_s
        self.ticks += 1
        eps = 1e-9 * max(self.tick_s, 1.0)
        advance = self.next_done <= self.time_s + eps
        self.rounds_done[advance] += 1
        self.next_done[advance] += self.compute_s[advance]

        landed = self._latest_landed(self.time_s)
        arrivals = np.zeros((max(len(self.offsets), 1), j), dtype=bool)
        idx = np.arange(j)
        for d, off in enumerate(self.offsets):
            senders = (idx + off) % j
            fresh = advance & (landed[senders] > self.last_read[idx, senders])
            arrivals[d] = fresh
            self.last_read[idx[fresh], senders[fresh]] = landed[
                senders[fresh]]
        return arrivals, advance


def straggler_compute(num_nodes: int, *, base_s: float = 1.0,
                      victim: int = 0, factor: float = 2.0) -> np.ndarray:
    """[J] per-node round times with one node ``factor`` times slower."""
    c = np.full(num_nodes, base_s, dtype=float)
    c[victim] = base_s * factor
    return c
