"""Adaptive penalty schedules for consensus ADMM (port of
``repro/core/penalty.py``).

All six schemes of Song, Yoon & Pavlovic (AAAI 2016):

  * ``fixed``  — standard ADMM, constant eta.
  * ``vp``     — §3.1 residual balancing (eq. 4) on local residuals (eq. 5),
                 homogeneous reset to eta0 after ``t_reset`` iterations.
  * ``ap``     — §3.2 per-edge eta_ij = eta0 (1 + tau_ij) from normalized
                 objective probes (eq. 6–8).
  * ``nap``    — §3.3 AP gated by a per-edge budget on the spent |tau|
                 (eq. 9) with a geometric top-up (eq. 10–11).
  * ``vp_ap``  — §3.4 eq. (12), reset at t_max.
  * ``vp_nap`` — §3.4 eq. (12) gated by the NAP budget.

State is dense ``[J, J]`` (edge e_ij at [i, j]) masked by the adjacency.
Every update is row-local: node i reads only F[i, :], r[i] and s[i]. The
functions are plain tensor code; the config is an ordinary argument.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

SCHEMES = ("fixed", "vp", "ap", "nap", "vp_ap", "vp_nap")


@dataclasses.dataclass(frozen=True)
class PenaltyConfig:
    """Hyper-parameters for the penalty schedule (see the reference's
    docstring for the paper's defaults and ``relative_beta``)."""

    scheme: str = "fixed"
    eta0: float = 10.0
    mu: float = 10.0
    tau_fixed: float = 1.0
    t_max: int = 50
    t_reset: int = 50
    budget_init: float = 1.0
    alpha: float = 0.5
    beta: float = 1e-3
    relative_beta: bool = True
    eta_min: float = 1e-6
    eta_max: float = 1e6

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"scheme {self.scheme!r} not in {SCHEMES}")

    @property
    def is_edge_based(self) -> bool:
        return self.scheme in ("ap", "nap", "vp_ap", "vp_nap")

    @property
    def uses_residuals(self) -> bool:
        return self.scheme in ("vp", "vp_ap", "vp_nap")

    @property
    def uses_objective_probes(self) -> bool:
        return self.scheme in ("ap", "nap", "vp_ap", "vp_nap")

    @property
    def uses_budget(self) -> bool:
        return self.scheme in ("nap", "vp_nap")


class PenaltyState(NamedTuple):
    """Per-edge penalty state. All tensors are [J, J] except f_prev [J]."""

    eta: torch.Tensor        # current per-edge penalty eta_ij
    cum_tau: torch.Tensor    # spent budget sum_u |tau_ij^u|       (eq. 9 lhs)
    budget: torch.Tensor     # budget upper bound T_ij^t           (eq. 10)
    n_incr: torch.Tensor     # int32 top-up counter n              (eq. 10)
    f_prev: torch.Tensor     # [J] f_i(theta_i^{t-1}) for the beta test
    t: torch.Tensor          # [] int32 iteration counter


def init_penalty_state(cfg: PenaltyConfig, num_nodes: int, *,
                       device: torch.device | str,
                       dtype: torch.dtype = torch.float32) -> PenaltyState:
    j = num_nodes
    return PenaltyState(
        eta=torch.full((j, j), cfg.eta0, dtype=dtype, device=device),
        cum_tau=torch.zeros((j, j), dtype=dtype, device=device),
        budget=torch.full((j, j), cfg.budget_init, dtype=dtype,
                          device=device),
        n_incr=torch.zeros((j, j), dtype=torch.int32, device=device),
        f_prev=torch.full((j,), float("inf"), dtype=dtype, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def compute_tau(adj: torch.Tensor, f_self: torch.Tensor,
                f_nbr: torch.Tensor) -> torch.Tensor:
    """Per-edge tau_ij from normalized objective probes (eq. 7–8).

    adj: [J, J] bool; f_self: [J] = f_i(theta_i); f_nbr: [J, J] with
    F[i, j] = f_i(theta_j). Returns [J, J] tau in [-1/2, 1], zero off the
    edges.
    """
    fi = torch.finfo(f_nbr.dtype)
    big = torch.tensor(fi.max, dtype=f_nbr.dtype, device=f_nbr.device)
    nbr_masked_min = torch.where(adj, f_nbr, big)
    nbr_masked_max = torch.where(adj, f_nbr, -big)
    # eq. (8): extremes over {f_i(theta_i)} U {f_i(theta_j) : j in B_i}
    f_min = torch.minimum(f_self, nbr_masked_min.amin(dim=1))
    f_max = torch.maximum(f_self, nbr_masked_max.amax(dim=1))
    denom = torch.clamp_min(f_max - f_min, fi.tiny)
    # eq. (7): kappa in [1, 2]
    kappa_self = (f_self - f_min) / denom + 1.0
    kappa_nbr = (f_nbr - f_min[:, None]) / denom[:, None] + 1.0
    tau = kappa_self[:, None] / torch.clamp_min(kappa_nbr, 1.0) - 1.0
    # degenerate neighborhoods => tau = 0. The [J] mask broadcasts along
    # the LAST axis, exactly as the reference's jnp.where does.
    tau = torch.where(denom <= fi.tiny * 2, 0.0, tau)
    return torch.where(adj, tau, 0.0).to(f_nbr.dtype)


def _clip(cfg: PenaltyConfig, eta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(eta, cfg.eta_min, cfg.eta_max)


def _residual_scale(cfg: PenaltyConfig, r_norm, s_norm, dtype):
    """eq. (12): x2 / x0.5 per node row by residual balance ([J, 1])."""
    up = (r_norm > cfg.mu * s_norm)[:, None]
    dn = (s_norm > cfg.mu * r_norm)[:, None]
    two = torch.tensor(2.0, dtype=dtype, device=r_norm.device)
    half = torch.tensor(0.5, dtype=dtype, device=r_norm.device)
    one = torch.tensor(1.0, dtype=dtype, device=r_norm.device)
    return torch.where(up, two, torch.where(dn, half, one))


def update_penalty(cfg: PenaltyConfig, state: PenaltyState, *,
                   adj: torch.Tensor,
                   f_self: torch.Tensor | None = None,
                   f_nbr: torch.Tensor | None = None,
                   r_norm: torch.Tensor | None = None,
                   s_norm: torch.Tensor | None = None) -> PenaltyState:
    """One penalty-schedule step. Call once per ADMM (outer) iteration.

    Residuals (r_norm, s_norm: [J]) are required for vp/vp_ap/vp_nap;
    objective probes (f_self: [J], f_nbr: [J, J]) for ap/nap/vp_ap/vp_nap.
    """
    j = state.eta.shape[0]
    dtype = state.eta.dtype
    dev = state.eta.device
    adj = adj.to(device=dev, dtype=torch.bool)
    t = state.t

    if cfg.uses_objective_probes:
        if f_self is None or f_nbr is None:
            raise ValueError(f"scheme {cfg.scheme!r} needs f_self and f_nbr")
        tau = compute_tau(adj, f_self.to(dtype), f_nbr.to(dtype))
    else:
        tau = torch.zeros((j, j), dtype=dtype, device=dev)

    if cfg.uses_residuals:
        if r_norm is None or s_norm is None:
            raise ValueError(f"scheme {cfg.scheme!r} needs r_norm and s_norm")
        r_norm = r_norm.to(dtype)
        s_norm = s_norm.to(dtype)

    cum_tau, budget, n_incr = state.cum_tau, state.budget, state.n_incr
    eta0_full = torch.full((j, j), cfg.eta0, dtype=dtype, device=dev)

    if cfg.scheme == "fixed":
        eta = state.eta

    elif cfg.scheme == "vp":
        # eq. (4) with local residuals (eq. 5) and fixed tau; node i applies
        # its factor to its whole row
        grow = torch.full((j,), 1.0 + cfg.tau_fixed, dtype=dtype, device=dev)
        up = r_norm > cfg.mu * s_norm
        dn = s_norm > cfg.mu * r_norm
        factor = torch.where(up, grow,
                             torch.where(dn, 1.0 / grow,
                                         torch.ones_like(grow)))
        eta = state.eta * factor[:, None]
        # §3.1: heterogeneous frozen penalties oscillate => homogeneous reset
        eta = torch.where(t >= cfg.t_reset, eta0_full, eta)

    elif cfg.scheme == "ap":
        # eq. (6): anchored at eta0 every step, frozen to eta0 after t_max
        eta = torch.where(t < cfg.t_max, cfg.eta0 * (1.0 + tau), eta0_full)

    elif cfg.scheme == "nap":
        # eq. (9): anchored at eta0, gated per edge by the spent budget
        within = cum_tau < budget
        eta = torch.where(within, cfg.eta0 * (1.0 + tau), eta0_full)
        cum_tau = cum_tau + torch.where(within, tau.abs(), 0.0)

    elif cfg.scheme == "vp_ap":
        scale = _residual_scale(cfg, r_norm, s_norm, dtype)
        changed = scale != 1.0
        eta = torch.where(changed, state.eta * (1.0 + tau) * scale, state.eta)
        eta = torch.where(t >= cfg.t_max, eta0_full, eta)

    elif cfg.scheme == "vp_nap":
        scale = _residual_scale(cfg, r_norm, s_norm, dtype)
        within = cum_tau < budget
        apply = within & (scale != 1.0)
        eta = torch.where(apply, state.eta * (1.0 + tau) * scale, state.eta)
        # the budget pays |tau| plus log2 of the residual scaling, keeping
        # the eq. (11) bound intact
        spend = tau.abs() + torch.log2(scale).abs()
        cum_tau = cum_tau + torch.where(apply, spend, 0.0)

    else:  # pragma: no cover
        raise AssertionError(cfg.scheme)

    if cfg.uses_budget:
        # eq. (10): top up T_ij by alpha^n * T while f_i still moves > beta
        delta_f = (f_self - state.f_prev).abs()
        if cfg.relative_beta:
            delta_f = delta_f / (state.f_prev.abs() + 1e-12)
        moving = (delta_f > cfg.beta) & torch.isfinite(state.f_prev)
        exhausted = cum_tau >= budget
        topup = exhausted & moving[:, None] & adj
        # eq. (11): the initial T is the n=1 term of the geometric series,
        # so top-ups start at alpha^1 T
        budget = budget + torch.where(
            topup, (cfg.alpha ** (n_incr.to(dtype) + 1.0)) * cfg.budget_init,
            0.0)
        n_incr = n_incr + topup.to(torch.int32)

    eta = torch.where(adj, _clip(cfg, eta), cfg.eta0)
    f_prev = f_self.to(dtype) if f_self is not None else state.f_prev
    return PenaltyState(eta=eta, cum_tau=cum_tau, budget=budget,
                        n_incr=n_incr, f_prev=f_prev, t=t + 1)


def staleness_damping(age: torch.Tensor, gamma: float) -> torch.Tensor:
    """Per-edge damping factor 1 / (1 + gamma * age) for stale consensus,
    all in float32 (``gamma`` a float32 tensor). ``age`` should be the
    symmetrized clock (``topology.sym_age``), so that the damped weights
    stay symmetric; ``age == 0`` gives exactly 1.0."""
    a = age.to(torch.float32)
    return 1.0 / (1.0 + torch.tensor(gamma, dtype=torch.float32,
                                     device=a.device) * a)


def effective_eta(cfg: PenaltyConfig, state: PenaltyState,
                  adj: torch.Tensor, *, age: torch.Tensor | None = None,
                  stale_gamma: float = 0.5) -> torch.Tensor:
    """eta applied to edge (i, j) this iteration, zero on non-edges; with
    ``age`` (the [J, J] staleness clocks) damped by
    ``staleness_damping(age, stale_gamma)``, the async executor's view."""
    del cfg
    eta = torch.where(adj.to(torch.bool), state.eta, 0.0)
    if age is not None:
        eta = eta * staleness_damping(age, stale_gamma)
    return eta


def freeze_penalty(advance: torch.Tensor, new: PenaltyState,
                   old: PenaltyState) -> PenaltyState:
    """Per-EDGE freeze for a fleet tick where only ``advance`` nodes ran.

    Edge entry [i, j] keeps the NEW value iff either endpoint advanced, and
    the OLD one only when both were frozen, so that a frozen node's incident
    entries keep adapting in both directions. ``f_prev`` stays per node: a
    frozen node ran no probe.
    """
    adv = advance.to(torch.bool)
    keep_new = adv[:, None] | adv[None, :]               # [J, J]

    def edges(a, b):
        return torch.where(keep_new, a, b)

    return new._replace(
        eta=edges(new.eta, old.eta),
        cum_tau=edges(new.cum_tau, old.cum_tau),
        budget=edges(new.budget, old.budget),
        n_incr=edges(new.n_incr, old.n_incr),
        f_prev=torch.where(adv, new.f_prev, old.f_prev))


def budget_exhausted(state: PenaltyState) -> torch.Tensor:
    """[J, J] bool — directed edges whose eq. (9) budget is spent.

    The topology's ``budget`` scheduler deactivates an edge when BOTH
    directions are exhausted; a top-up (eq. 10) raises T_ij above cum_tau
    and revives it.
    """
    return state.cum_tau >= state.budget
