"""Device-resident metrics ring: per-round telemetry with no per-round host
sync (port of ``repro/obs/ring.py``).

The consensus round computes its metrics on the device; reading them back
every round would synchronise the host with the device once per round. The
ring avoids it: a fixed-capacity ``[cap, NUM_COLUMNS]`` f32 buffer rides in
``TrainState`` on the trainer's device, and each round appends its
``obs.schema.metrics_row`` in place: the slot ``head % cap`` is computed on
the device and written with ``index_copy_`` (indexing with a 0-dim CUDA
tensor from Python could read it back to the host). The host drains the
ring every K rounds (``ObsConfig.drain_every``).

Buffer discipline (the reference's):

  * ``head`` counts appends MONOTONICALLY; the write slot is ``head % cap``.
    Draining never writes the ring: the host keeps its own cursor (the last
    drained head) and reads the rows in ``[cursor, head)``.
  * overflow is explicit: if more than ``cap`` rounds ran since the last
    drain, the oldest rows were overwritten and ``drain`` reports how many
    were dropped. Size ``cap >= drain_every`` to never drop.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import schema


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs for the observability subsystem (``ConsensusConfig.obs``).

    Attributes:
      enabled: master switch. ``ObsConfig(enabled=False)`` runs exactly the
        round of ``obs=None``: the same launches, the same numbers.
      ring_capacity: rows in the device metrics ring. Must be >=
        ``drain_every`` or steady-state drains drop rows (allowed but
        reported).
      drain_every: host drain cadence in CONSENSUS ROUNDS.
      with_spans: wrap the round's phases (pack, exchange, decode, probe,
        fused kernel, penalty) and the host round calls in
        ``torch.profiler.record_function`` spans (``obs.trace``).
      with_node_ring: carry the per-node telemetry ring
        (``obs.node_ring``: ``[cap, J, NODE_COLUMNS]``) next to the scalar
        ring: per-node residuals, objective, penalty row means, staleness
        ages, liveness and wire bytes, which the health monitor
        (``obs.health``) and the dashboard's heatmaps read. Shares
        ``ring_capacity``/``drain_every``.
    """

    enabled: bool = True
    ring_capacity: int = 256
    drain_every: int = 8
    with_spans: bool = True
    with_node_ring: bool = True

    def __post_init__(self):
        if self.ring_capacity < 1:
            raise ValueError(f"ring_capacity {self.ring_capacity} < 1")
        if self.drain_every < 1:
            raise ValueError(f"drain_every {self.drain_every} < 1")


class MetricsRing(NamedTuple):
    """Fixed-capacity metrics buffer (rides in ``TrainState``)."""

    buf: torch.Tensor    # [cap, schema.NUM_COLUMNS] f32 — slot = k % cap
    head: torch.Tensor   # [] int32 — MONOTONIC append count (next write id)


def init_ring(capacity: int, device: torch.device | str = "cpu"
              ) -> MetricsRing:
    return MetricsRing(
        buf=torch.zeros((int(capacity), schema.NUM_COLUMNS),
                        dtype=torch.float32, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device))


def append_in_place(buf: torch.Tensor, head: torch.Tensor,
                    row: torch.Tensor) -> None:
    """Write ``row`` into slot ``head % cap`` of ``buf`` and count it, all
    on the device: no value comes back to the host."""
    slot = torch.remainder(head, buf.shape[0]).to(torch.int64).view(1)
    buf.index_copy_(0, slot, row[None].to(buf.dtype))
    head.add_(1)


def ring_append(ring: MetricsRing, row: torch.Tensor) -> MetricsRing:
    """Append one ``[NUM_COLUMNS]`` row in place; returns the ring."""
    append_in_place(ring.buf, ring.head, row)
    return ring


def drain_buffer(buf: torch.Tensor, head: torch.Tensor, cursor: int
                 ) -> tuple[np.ndarray, int, int]:
    """The rows of ``buf`` appended in ``[cursor, head)``, oldest first, as
    ``(rows, head, dropped)``; reads the device once."""
    head = int(head)
    cap = int(buf.shape[0])
    n_new = head - cursor
    if n_new <= 0:
        return np.zeros((0,) + tuple(buf.shape[1:]), np.float32), head, 0
    dropped = max(0, n_new - cap)
    take = n_new - dropped
    host = buf.detach().cpu().numpy()
    idx = np.arange(head - take, head) % cap
    return host[idx], head, dropped


def drain(ring: MetricsRing, cursor: int) -> tuple[np.ndarray, int, int]:
    """Host-side read of every row appended since ``cursor``.

    Returns ``(rows, new_cursor, dropped)`` with ``rows`` a
    ``[n, NUM_COLUMNS]`` numpy array in CHRONOLOGICAL order, ``new_cursor``
    the head to pass next time, and ``dropped`` the count of rows
    overwritten before this drain could read them (0 unless more than
    ``cap`` rounds ran since the last drain). A pure read: the ring is
    never written.
    """
    return drain_buffer(ring.buf, ring.head, cursor)


def drain_rows(ring: MetricsRing, cursor: int
               ) -> tuple[list[dict], int, int]:
    """``drain`` + per-row dict conversion (``obs.schema.row_to_dict``)."""
    rows, new_cursor, dropped = drain(ring, cursor)
    return [schema.row_to_dict(r) for r in rows], new_cursor, dropped


def from_numpy(arrays: dict, device: torch.device | str) -> MetricsRing:
    """A ring from host arrays (``buf``, ``head``), e.g. the reference's
    ``MetricsRing`` fields, so that a run carried over mid-way keeps its
    rows and its head."""
    return MetricsRing(
        buf=torch.as_tensor(np.asarray(arrays["buf"], np.float32),
                            device=device).clone(),
        head=torch.as_tensor(np.asarray(arrays["head"], np.int32),
                             device=device).clone())
