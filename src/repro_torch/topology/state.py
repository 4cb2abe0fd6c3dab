"""Dynamic-topology state for the consensus trainer (port of
``repro/topology/state.py``).

``TopologyState`` carries a per-edge active mask (``[J, J]``, like
``PenaltyState``) plus per-edge epoch counters and node liveness, so edges
can drop, revive and rewire between ADMM rounds while every buffer keeps
its shape: the round consumes the mask as data.

Composition of the mask (all [J, J] bool, symmetric, zero diagonal):

    mask = (pattern & adj  |  backbone  |  repair) & alive_i & alive_j

  * ``pattern``  — what the scheduler decided this epoch
    (``topology.schedulers``);
  * ``backbone`` — a static spanning subgraph that is never gated, the
    connectivity guarantee (on the state so churn can rewrite it);
  * ``repair``   — extra edges the churn runtime activates when a node loss
    breaks the backbone (``topology.runtime``);
  * ``node_alive`` — row/col liveness; a dead node's edges are all inactive
    (a "ghost row": buffers keep their [J, ...] shape, only the mask
    changes).

Epoch counters increment whenever an edge flips active<->inactive.

``age`` (staleness clocks) belongs to the async executor and stays zero on
the synchronous path. ``kick`` holds pending zero-kick weights: when the
scheduler gates an edge at the END of round t, the round can only absorb
that edge's final consensus force into the dual at round t+1 (its
neighbor's parameters are on the wire then); ``kick[i, j]`` carries the
symmetrized penalty weight of each newly gated edge across the round
boundary.

The reference's PRNG key becomes ``seed``, an int: the ``random`` scheduler
seeds a ``torch.Generator`` from ``(seed, epoch)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class TopologyState(NamedTuple):
    """Per-edge topology state. All [J, J] except node_alive [J] and t []."""

    mask: torch.Tensor        # [J, J] bool — edges active for the NEXT round
    backbone: torch.Tensor    # [J, J] bool — never-gated spanning subgraph
    repair: torch.Tensor      # [J, J] bool — churn-activated rewiring edges
    node_alive: torch.Tensor  # [J]    bool — liveness (ghost rows if False)
    epoch: torch.Tensor       # [J, J] int32 — per-edge flip counters
    seed: int                 # random scheduler's seed (the reference's key)
    t: torch.Tensor           # []     int32 epoch counter
    age: torch.Tensor         # [J, J] int32 — staleness clocks (async only)
    kick: torch.Tensor        # [J, J] f32 — pending zero-kick weights


def init_topology_state(adj: np.ndarray, backbone: np.ndarray, *,
                        device: torch.device | str,
                        seed: int = 0) -> TopologyState:
    """Fresh state: every graph edge active, everyone alive, epoch zero."""
    adj = np.asarray(adj, dtype=bool)
    j = adj.shape[0]
    return TopologyState(
        mask=torch.as_tensor(adj, device=device),
        backbone=torch.as_tensor(np.asarray(backbone, dtype=bool),
                                 device=device),
        repair=torch.zeros((j, j), dtype=torch.bool, device=device),
        node_alive=torch.ones((j,), dtype=torch.bool, device=device),
        epoch=torch.zeros((j, j), dtype=torch.int32, device=device),
        seed=int(seed),
        t=torch.zeros((), dtype=torch.int32, device=device),
        age=torch.zeros((j, j), dtype=torch.int32, device=device),
        kick=torch.zeros((j, j), dtype=torch.float32, device=device))


def compose_mask(pattern: torch.Tensor, state: TopologyState,
                 adj: torch.Tensor) -> torch.Tensor:
    """Apply the mask composition rule (module docstring) to a pattern."""
    alive = state.node_alive
    m = (pattern & adj) | (state.backbone | state.repair)
    return m & alive[:, None] & alive[None, :]


def advance(state: TopologyState, new_mask: torch.Tensor) -> TopologyState:
    """Install a new mask, bumping per-edge epochs where edges flipped."""
    flipped = (new_mask != state.mask).to(torch.int32)
    return state._replace(mask=new_mask, epoch=state.epoch + flipped,
                          t=state.t + 1)


def tick_age(state: TopologyState, fresh: torch.Tensor) -> TopologyState:
    """Advance the staleness clocks: reset where ``fresh`` [J, J], else +1.

    Only the async round calls this (once per round); on the synchronous
    path every payload is fresh and ``age`` stays zero.
    """
    age = torch.where(fresh, 0, state.age + 1).to(torch.int32)
    return state._replace(age=age)


def sym_age(state: TopologyState) -> torch.Tensor:
    """[J, J] int32 — symmetrized staleness, the max over both directions,
    so that weights built from it stay symmetric."""
    return torch.maximum(state.age, state.age.T)


def active_degree(state: TopologyState) -> torch.Tensor:
    """[J] float32 — number of active edges per node."""
    return state.mask.to(torch.float32).sum(dim=1)


def active_edge_fraction(state: TopologyState,
                         adj: torch.Tensor) -> torch.Tensor:
    """Scalar — active edges as a fraction of the static graph's edges."""
    adj_n = torch.clamp_min(adj.to(torch.float32).sum(), 1.0)
    return state.mask.to(torch.float32).sum() / adj_n


def from_numpy(np_state: Any, device: torch.device | str, *,
               seed: int = 0) -> TopologyState:
    """The reference's ``TopologyState`` as numpy arrays (a NamedTuple or a
    mapping with its field names) -> the port's state on ``device``.

    The reference's PRNG key has no counterpart in torch; ``seed`` takes
    its place (it only matters to the ``random`` scheduler).
    """
    def get(name):
        v = np_state[name] if isinstance(np_state, dict) \
            else getattr(np_state, name)
        return np.asarray(v)

    def t(name, dtype):
        return torch.as_tensor(np.array(get(name), copy=True),
                               device=device).to(dtype)

    return TopologyState(
        mask=t("mask", torch.bool), backbone=t("backbone", torch.bool),
        repair=t("repair", torch.bool), node_alive=t("node_alive",
                                                     torch.bool),
        epoch=t("epoch", torch.int32), seed=int(seed),
        t=t("t", torch.int32), age=t("age", torch.int32),
        kick=t("kick", torch.float32))
