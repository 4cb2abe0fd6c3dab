"""Device-resident PER-NODE telemetry ring: who is diverging, not just
whether (port of ``repro/obs/node_ring.py``).

The scalar ``obs.ring`` holds one ``[NUM_COLUMNS]`` row per round; this
ring holds one ``[J, NUM_NODE_COLUMNS]`` slab per round next to it, in a
``[cap, J, NUM_NODE_COLUMNS]`` f32 buffer on the trainer's device: each
node's residuals, local objective, penalty row mean, staleness age,
liveness and advance flags and received wire bytes, appended on every round
path through ``ConsensusTrainer._finish_round``. The column registry is
``obs.schema.NODE_COLUMNS``.

The buffer discipline is the scalar ring's (``obs.ring``): a monotonic
head, the slot computed on the device, a host cursor, pure-read drains and
an explicit dropped count. The slab is J times wider, which is why the
ring has its own switch (``ObsConfig.with_node_ring``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import ring as obs_ring
from repro_torch.obs import schema


class NodeRing(NamedTuple):
    """Fixed-capacity per-node buffer (rides in ``TrainState``)."""

    buf: torch.Tensor    # [cap, J, NUM_NODE_COLUMNS] f32 — slot = k % cap
    head: torch.Tensor   # [] int32 — MONOTONIC append count (next write id)


def init_node_ring(capacity: int, num_nodes: int,
                   device: torch.device | str = "cpu") -> NodeRing:
    return NodeRing(
        buf=torch.zeros((int(capacity), int(num_nodes),
                         schema.NUM_NODE_COLUMNS), dtype=torch.float32,
                        device=device),
        head=torch.zeros((), dtype=torch.int32, device=device))


def node_ring_append(ring: NodeRing, row: torch.Tensor) -> NodeRing:
    """Append one ``[J, NUM_NODE_COLUMNS]`` slab in place, exactly like the
    scalar ring; returns the ring."""
    obs_ring.append_in_place(ring.buf, ring.head, row)
    return ring


def drain(ring: NodeRing, cursor: int) -> tuple[np.ndarray, int, int]:
    """Host-side pure read of every slab appended since ``cursor``:
    ``(rows [n, J, NUM_NODE_COLUMNS] oldest first, new_cursor, dropped)``,
    as ``obs.ring.drain``."""
    return obs_ring.drain_buffer(ring.buf, ring.head, cursor)


def drain_node_rows(ring: NodeRing, cursor: int
                    ) -> tuple[list[dict], int, int]:
    """``drain`` + per-slab dict conversion (``schema.node_row_to_dict``)."""
    rows, new_cursor, dropped = drain(ring, cursor)
    return [schema.node_row_to_dict(r) for r in rows], new_cursor, dropped


def from_numpy(arrays: dict, device: torch.device | str) -> NodeRing:
    """A node ring from host arrays (``buf``, ``head``), as
    ``obs.ring.from_numpy``."""
    return NodeRing(*obs_ring.from_numpy(arrays, device))
