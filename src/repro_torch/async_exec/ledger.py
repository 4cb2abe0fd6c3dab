"""In-flight wire state for the bounded-staleness async executor (port of
``repro/async_exec/ledger.py``).

The synchronous round consumes every graph offset's payload fresh. The
async round instead keeps a **wire ledger**: the last payload consumed per
directed edge, ``[deg, J, W]`` raw wire rows in the codec's dtype
(quantized payloads keep their scale bytes in-band), so that a late
neighbour's row can be consumed again at zero recompute. The discipline is
most-recent-wins: a fresh arrival overwrites the receiver's slot.

With a sharded layout (``slayout``, ``flatten.ShardedLayout``) a row is
the sharded wire: ``S`` self-contained slab messages of
``shard_wire_width`` elements, each with its own scale bytes, as the
reference lays it out. A rank holds its own rows: ``[deg, J / R, W]`` for
a block of nodes, ``[deg, 1, shard_wire_width]`` for a slab rank (its
slab's message of its node, ``slab=True``), so that staleness absorption
reads only bytes the rank holds.

The per-edge staleness clocks are ``topology.TopologyState.age``; the
ledger is only the payload buffer they describe, plus ``w_prev``, the
weights each edge applied last round (an edge that ages out absorbs its
final force at exactly that weight), replicated ``[J, J]`` on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import wire


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs for the bounded-staleness executor.

    Attributes:
      max_staleness: how many rounds old a consumed payload may be. 0 waits
        for everything: the async round is the synchronous one. N >= 1 lets
        a node proceed on payloads up to N rounds old; an edge whose payload
        ages past N is gated (zero math, its force zero-kick absorbed) until
        a fresh payload lands.
      stale_gamma: damping strength — a stale edge applies
        eta / (1 + gamma * age) (``core.penalty.staleness_damping``).
    """

    max_staleness: int = 1
    stale_gamma: float = 0.5

    def __post_init__(self):
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness {self.max_staleness} < 0")
        if self.stale_gamma < 0.0:
            raise ValueError(f"stale_gamma {self.stale_gamma} < 0")


class WireLedger(NamedTuple):
    """The last-consumed wire rows, and last round's applied weights."""

    wires: torch.Tensor    # [deg, J, W] raw wire rows, one per offset
    round: torch.Tensor    # [] int32 — async rounds completed
    w_prev: torch.Tensor   # [J, J] f32 — weights applied last round


def wire_width(layout, compression: str, slayout=None) -> int:
    """Elements per wire row (quantized payloads carry their scale bytes);
    ``compression`` is any codec name or the legacy ``"none"``. With
    ``slayout`` the sharded row: ``S`` slab messages side by side."""
    return wire.get_codec(compression, layout, slayout).wire_width


def wire_row_dtype(layout, compression: str) -> torch.dtype:
    return wire.get_codec(compression, layout).wire_dtype


def init_wire_ledger(layout, deg: int, num_nodes: int,
                     compression: str = "none", slayout=None, codec=None, *,
                     device: torch.device | str, rows: int | None = None,
                     slab: bool = False) -> WireLedger:
    """Zero-filled ledger on ``device``. The round clock makes the first
    read of every edge fresh, so the zeros are never consumed. Rows are
    sized and typed by ``codec`` (a ``repro_torch.wire`` codec, as the
    trainer passes it) or by the codec that ``compression`` and
    ``slayout`` name. ``rows`` node rows (default all ``num_nodes``), each
    one slab message wide with ``slab`` (a sharded codec only)."""
    if codec is None:
        codec = wire.get_codec(compression, layout, slayout)
    if slab and codec.slayout is None:
        raise ValueError("init_wire_ledger: slab rows need a sharded codec")
    width = codec.shard_wire_width if slab else codec.wire_width
    return WireLedger(
        wires=torch.zeros((max(deg, 1), num_nodes if rows is None else rows,
                           width), dtype=codec.wire_dtype, device=device),
        round=torch.zeros((), dtype=torch.int32, device=device),
        w_prev=torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                           device=device))


def from_numpy(np_ledger: Any, device: torch.device | str, *,
               nodes: tuple[int, int] | None = None,
               shard: tuple[int, int] | None = None) -> WireLedger:
    """The reference's ``WireLedger`` as numpy arrays (a NamedTuple or a
    mapping with its field names) -> the port's ledger on ``device``. A
    bfloat16 wire keeps its bits. ``nodes`` ``(lo, hi)`` keeps a rank's
    node rows; ``shard`` ``(s, shard_wire_width)`` cuts each sharded row
    ``[S * w]`` to slab s's message, a slab rank's row."""
    def get(name):
        v = np_ledger[name] if isinstance(np_ledger, dict) \
            else getattr(np_ledger, name)
        return np.array(v, copy=True)

    wires = get("wires")
    if nodes is not None:
        wires = wires[:, nodes[0]:nodes[1]]
    if shard is not None:
        s, w = shard
        wires = wires[..., s * w:(s + 1) * w]
    wires = np.ascontiguousarray(wires)
    if wires.dtype.name == "bfloat16":
        w = torch.from_numpy(wires.view(np.int16)).view(torch.bfloat16)
    else:
        w = torch.from_numpy(wires)
    return WireLedger(
        wires=w.to(device),
        round=torch.as_tensor(get("round"), device=device).to(torch.int32),
        w_prev=torch.as_tensor(get("w_prev"), device=device).to(
            torch.float32))
