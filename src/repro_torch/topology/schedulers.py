"""Edge-gating schedulers for the dynamic topology (port of
``repro/topology/schedulers.py``).

A scheduler decides which graph edges take part in the NEXT consensus
round. It sees the penalty state (for the paper's §4 budget semantics), the
local residuals and the epoch counter, and returns a [J, J] bool *pattern*
that ``topology.state.compose_mask`` combines with the never-gated
backbone, churn repairs and node liveness.

Schedulers:

  * ``static``      — the full graph every epoch.
  * ``budget``      — paper §4 made literal: an edge deactivates once its
                      NAP budget is exhausted (cum_tau >= T_ij in BOTH
                      directions) and both endpoints sit below the consensus
                      tolerance; a budget top-up (eq. 10) revives it.
  * ``random``      — Bernoulli edge activation with keep probability
                      ``activation_p``, redrawn every ``period`` epochs. The
                      draw comes from a ``torch.Generator`` seeded from
                      ``(seed, t // period)``, so it depends on the epoch
                      alone, as the reference's ``fold_in`` draw does; its
                      bits differ from JAX's.
  * ``round_robin`` — rotates through the graph's permutation rounds (edge
                      coloring): each epoch activates one matching.
  * ``stale``       — bounded-staleness gating for the async executor: an
                      edge is active while the symmetrized age of its
                      payloads is within ``max_staleness``.

Connectivity: the backbone keeps the masked graph connected by
construction (see ``topology.state``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.penalty import PenaltyState, budget_exhausted
from repro_torch.topology.state import (TopologyState, advance, compose_mask,
                                        sym_age)

SCHEDULERS = ("static", "budget", "random", "round_robin", "stale")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Dynamic-topology knobs (the reference's fields and defaults).

    Attributes:
      scheduler: one of ``SCHEDULERS``. ``static`` + ``churn=False`` (the
        default) keeps the trainer on the ungated round.
      churn: layout-preserving node churn — the trainer exchanges over the
        offset *superset* (graph offsets + ``spare_offsets``) and a lost
        node becomes a masked ghost row.
      gate_tol: ``budget`` — an edge may only deactivate once both
        endpoints' primal residual norms are below this.
      activation_p: ``random`` — per-edge Bernoulli keep probability.
      period: epochs between redraws (``random``) / rotations
        (``round_robin``).
      spare_offsets: extra circulant offsets in the exchange superset for
        churn repair; () = auto ((2, J-2) when churn is on).
      skip_dead_offsets: an offset with no active edge and no pending kick
        skips its roll and its probe.
      max_staleness: ``stale`` — the bound on the symmetrized age.
      seed: seed of the ``random`` scheduler.
    """

    scheduler: str = "static"
    churn: bool = False
    gate_tol: float = 1e-4
    activation_p: float = 0.5
    period: int = 1
    spare_offsets: tuple = ()
    skip_dead_offsets: bool = True
    max_staleness: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"scheduler {self.scheduler!r} not in {SCHEDULERS}")
        if not 0.0 < self.activation_p <= 1.0:
            raise ValueError(f"activation_p {self.activation_p} not in (0,1]")
        if self.period < 1:
            raise ValueError(f"period {self.period} < 1")

    @property
    def is_dynamic(self) -> bool:
        """Whether the trainer needs the masked (edge-gated) round."""
        return self.scheduler != "static" or self.churn

    @property
    def can_gate(self) -> bool:
        """Whether the scheduler can flip a graph edge off mid-run; only
        then does the round pass zero-kick weights to the kernel (a static
        schedule, even with churn, keeps the kick-free round)."""
        return self.scheduler != "static"

    def validate_penalty(self, penalty_cfg) -> None:
        """Reject scheduler/penalty pairings that silently do nothing."""
        if self.scheduler == "budget" and not penalty_cfg.uses_budget:
            raise ValueError(
                f"budget topology scheduler needs a budget-spending penalty "
                f"scheme (nap/vp_nap), got {penalty_cfg.scheme!r} — its "
                f"gate would never fire and the mask would stay static")


def budget_gate(penalty: PenaltyState, r_norm: torch.Tensor,
                gate_tol: float,
                prev_off: torch.Tensor | None = None) -> torch.Tensor:
    """[J, J] bool — edges the §4 budget semantics says may deactivate.

    True where BOTH directed budgets are exhausted (cum_tau >= T_ij) AND
    both endpoints' local primal residuals are below ``gate_tol``.
    ``prev_off`` (edges gated last epoch) latches the gate: a gated edge
    stays gated while exhausted even if residuals drift back up; revival
    happens only through a budget top-up (eq. 10).
    """
    exhausted = budget_exhausted(penalty)
    exhausted = exhausted & exhausted.T
    close = r_norm < gate_tol
    gate = close[:, None] & close[None, :]
    if prev_off is not None:
        gate = gate | prev_off
    return exhausted & gate


def random_pattern(seed: int, epoch: int, j: int, p: float) -> torch.Tensor:
    """[J, J] bool symmetric Bernoulli(p) keep pattern of one epoch, drawn
    on the CPU from a generator seeded by ``(seed, epoch)``."""
    mixed = np.random.SeedSequence((int(seed), int(epoch))).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed))
    u = torch.triu(torch.rand((j, j), generator=gen), 1)
    return (u + u.T) < p


def update_topology(cfg: TopologyConfig, state: TopologyState, *,
                    adj: torch.Tensor,
                    penalty: PenaltyState | None = None,
                    r_norm: torch.Tensor | None = None,
                    rotation: torch.Tensor | None = None) -> TopologyState:
    """One scheduler epoch: decide the pattern, compose, advance counters.

    Args:
      adj: [J, J] bool — the static graph adjacency, on the state's device.
      penalty / r_norm: required for ``budget``.
      rotation: [R, J, J] bool stack of rotation patterns, required for
        ``round_robin`` (``TopologyRuntime`` builds it).
    """
    adj = adj.to(torch.bool)

    if cfg.scheduler == "static":
        pattern = adj

    elif cfg.scheduler == "budget":
        if penalty is None or r_norm is None:
            raise ValueError("the budget scheduler needs penalty and r_norm")
        prev_off = adj & ~state.mask       # backbone edges never appear here
        pattern = adj & ~budget_gate(penalty, r_norm.to(torch.float32),
                                     cfg.gate_tol, prev_off)

    elif cfg.scheduler == "random":
        # one host read of the epoch counter: the draw depends on it alone
        epoch = int(state.t) // cfg.period
        keep = random_pattern(state.seed, epoch, adj.shape[0],
                              cfg.activation_p)
        pattern = adj & keep.to(adj.device)

    elif cfg.scheduler == "round_robin":
        if rotation is None:
            raise ValueError("round_robin needs rotation masks")
        phase = (state.t // cfg.period) % rotation.shape[0]
        pattern = adj & rotation[phase.long()]

    elif cfg.scheduler == "stale":
        # bounded staleness: gate while either direction's payload is older
        # than the bound; a fresh arrival (age reset by tick_age) revives
        # the edge the same epoch — no latch, staleness is self-healing
        pattern = adj & (sym_age(state) <= cfg.max_staleness)

    else:  # pragma: no cover
        raise AssertionError(cfg.scheduler)

    return advance(state, compose_mask(pattern, state, adj))
