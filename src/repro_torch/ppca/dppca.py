"""Distributed PPCA (Yoon & Pavlovic, NIPS'12) with the paper's adaptive
penalty schedules: §4 / Algorithm 1 (port of ``repro/ppca/dppca.py``).

Every node i holds local observations X_i [N_i, D] and local parameters
Theta_i = {W_i, mu_i, a_i}; consensus constraints tie the parameters across
the communication graph. One ADMM iteration (Algorithm 1):

  1. E-step (local, same as centralized PPCA)
  2. M-step with consensus terms (eq. 15 and its W/a analogues)
  3. broadcast Theta_i to neighbors
  4. dual updates  Lam_i += 1/2 sum_j eta_ij (W_i - W_j)  (and gamma, beta)
  5. penalty update eta_ij / budget T_ij via the configured scheme (eq. 4–12)

All node states are stacked on a leading J axis and the per-node math runs
as batched tensor code over it; neighbor reductions are masked products with
the dense adjacency, and the [J, J] objective probes f_i(Theta_j) broadcast
X_i against (W_j, mu_j, a_j).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import residuals as res_lib
from repro_torch.core.graph import Graph
from repro_torch.core.penalty import (PenaltyConfig, PenaltyState,
                                      init_penalty_state, update_penalty)
from repro_torch.ppca import ppca as cp


class DPPCAState(NamedTuple):
    W: torch.Tensor       # [J, D, M]
    mu: torch.Tensor      # [J, D]
    a: torch.Tensor       # [J]
    Lam: torch.Tensor     # [J, D, M]  multiplier for W
    gam: torch.Tensor     # [J, D]     multiplier for mu
    bet: torch.Tensor     # [J]        multiplier for a
    theta_bar: dict       # previous neighbor means (eq. 5 dual residual)
    penalty: PenaltyState
    t: torch.Tensor


def _dual(mult: torch.Tensor, th: torch.Tensor,
          eta_sym: torch.Tensor) -> torch.Tensor:
    """mult_i + 1/2 sum_j eta_sym_ij (th_i - th_j)."""
    flat = th.reshape(th.shape[0], -1)
    diff = eta_sym.sum(1)[:, None] * flat - eta_sym @ flat
    return mult + 0.5 * diff.reshape(th.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class DPPCA:
    """D-PPCA with configurable penalty schedule."""

    latent_dim: int
    graph: Graph
    penalty_cfg: PenaltyConfig
    probe_midpoint: bool = False   # §3.2: probe at rho_ij instead of theta_j

    @cached_property
    def _adj(self) -> dict:
        return {}

    def _adj_on(self, device: torch.device) -> torch.Tensor:
        a = self._adj.get(device)
        if a is None:
            a = self._adj[device] = torch.as_tensor(self.graph.adj,
                                                    device=device)
        return a

    # ------------------------------------------------------------------ init
    def init(self, x: torch.Tensor, generator: torch.Generator
             ) -> DPPCAState:
        """x: [J, N_i, D] local observations (evenly split). W is drawn
        standard-normal from ``generator`` on its device (a CPU generator
        gives the same init on every device) and moved to x's."""
        j, _, d = x.shape
        W = torch.randn((j, d, self.latent_dim), generator=generator,
                        dtype=x.dtype, device=generator.device).to(x.device)
        mu = x.mean(dim=1)
        a = torch.ones((j,), dtype=x.dtype, device=x.device)
        bar = res_lib.neighbor_mean({"W": W, "mu": mu, "a": a},
                                    self._adj_on(x.device))
        return DPPCAState(
            W=W, mu=mu, a=a, Lam=torch.zeros_like(W),
            gam=torch.zeros_like(mu), bet=torch.zeros_like(a),
            theta_bar=bar,
            penalty=init_penalty_state(self.penalty_cfg, j, device=x.device,
                                       dtype=x.dtype),
            t=torch.zeros((), dtype=torch.int32, device=x.device))

    # ------------------------------------------------------------- iteration
    def step(self, state: DPPCAState, x: torch.Tensor
             ) -> tuple[DPPCAState, dict]:
        j, n_i, d = x.shape
        adj = self._adj_on(x.device)
        eta = state.penalty.eta * adj.to(x.dtype)      # zero off-edges
        eta_sum = eta.sum(dim=1)                       # [J] sum_j eta_ij
        es3 = eta_sum[:, None, None]
        a3 = state.a[:, None, None]

        # ---- (1) E-step on every node --------------------------------------
        stats = cp.e_step(cp.PPCAParams(state.W, state.mu, state.a), x)

        # ---- (2) M-step with consensus -------------------------------------
        # W:  [a_i sum_n xc Ez^T - 2 Lam_i + sum_j eta_ij (W_i + W_j)]
        #     [a_i sum_n Ezz + 2 sum_j eta_ij I]^{-1}
        pull_W = torch.einsum("ij,jdm->idm", eta, state.W) + es3 * state.W
        xc = x - state.mu[:, None, :]
        num = a3 * (xc.mT @ stats.Ez) - 2.0 * state.Lam + pull_W   # [J, D, M]
        eye = torch.eye(self.latent_dim, dtype=x.dtype, device=x.device)
        den = a3 * stats.Ezz.sum(1) + 2.0 * es3 * eye
        W_new = torch.linalg.solve(den, num.mT).mT

        # mu (paper eq. 15)
        pull_mu = eta @ state.mu + eta_sum[:, None] * state.mu     # [J, D]
        num = state.a[:, None] * (x - stats.Ez @ W_new.mT).sum(1) \
            - 2.0 * state.gam + pull_mu
        mu_new = num / (n_i * state.a + 2.0 * eta_sum)[:, None]

        # a: positive root of
        #   4*es*a^2 + (s_i + 4 bet_i - 2 sum_j eta_ij(a_i + a_j)) a - N D = 0
        pull_a = eta @ state.a + eta_sum * state.a                 # [J]
        s = cp._sq_err(x - mu_new[:, None, :], W_new, stats.Ez, stats.Ezz)
        b = s + 4.0 * state.bet - 2.0 * pull_a
        c2 = 4.0 * eta_sum
        nd = float(n_i * d)
        root = (-b + torch.sqrt(b * b + 4.0 * c2 * nd)) / (2.0 * c2 + 1e-30)
        no_consensus = nd / torch.clamp_min(b, 1e-12)   # es == 0 fallback
        a_new = torch.clamp_min(torch.where(c2 > 1e-12, root, no_consensus),
                                1e-8)

        # ---- (3)+(4) broadcast & dual updates -------------------------------
        # the duals use the SYMMETRIZED per-edge penalty: with directed
        # eta_ij != eta_ji the raw update breaks the sum_i lambda_i = 0
        # invariant that the convergence argument relies on
        eta_sym = 0.5 * (eta + eta.T)
        Lam_new = _dual(state.Lam, W_new, eta_sym)
        gam_new = _dual(state.gam, mu_new, eta_sym)
        bet_new = _dual(state.bet, a_new, eta_sym)

        # ---- residuals (eq. 5) over the full parameter tree -----------------
        theta = {"W": W_new, "mu": mu_new, "a": a_new}
        eta_node = res_lib.node_eta(state.penalty.eta, adj)
        rr = res_lib.local_residuals(theta, state.theta_bar, adj, eta_node)

        # ---- (5) penalty update ---------------------------------------------
        f_self = cp.nll(cp.PPCAParams(W_new, mu_new, a_new), x)
        f_nbr = None
        if self.penalty_cfg.uses_objective_probes:
            # F[i, j] = f_i(Theta_j): x_i [J, 1, N, D] against Theta_j [1, J]
            Wj, muj, aj = W_new[None], mu_new[None], a_new[None]
            if self.probe_midpoint:
                Wj = 0.5 * (W_new[:, None] + Wj)
                muj = 0.5 * (mu_new[:, None] + muj)
                aj = 0.5 * (a_new[:, None] + aj)
            f_nbr = cp.nll(cp.PPCAParams(Wj, muj, aj), x[:, None])

        penalty_new = update_penalty(
            self.penalty_cfg, state.penalty, adj=adj, f_self=f_self,
            f_nbr=f_nbr, r_norm=rr.r_norm, s_norm=rr.s_norm)

        new_state = DPPCAState(
            W=W_new, mu=mu_new, a=a_new, Lam=Lam_new, gam=gam_new,
            bet=bet_new, theta_bar=rr.theta_bar, penalty=penalty_new,
            t=state.t + 1)
        metrics = {
            "objective": f_self.sum(),
            "f_self": f_self,
            "r_max": rr.r_norm.max(),
            "s_max": rr.s_norm.max(),
            "eta_mean": res_lib.node_eta(penalty_new.eta, adj).mean(),
        }
        return new_state, metrics

    # ------------------------------------------------------------------- run
    def run(self, state: DPPCAState, x: torch.Tensor, *,
            max_iters: int = 1000, rel_tol: float = 1e-3, min_iters: int = 5
            ) -> tuple[DPPCAState, dict]:
        """Paper §5 criterion: relative change of the total objective < tol;
        one read of the device per iteration."""
        hist = {"objective": [], "r_max": [], "eta_mean": []}
        prev = None
        iters = max_iters
        for it in range(max_iters):
            state, mtr = self.step(state, x)
            obj, r_max, eta_mean = torch.stack([
                mtr["objective"].double(), mtr["r_max"].double(),
                mtr["eta_mean"].double()]).tolist()
            hist["objective"].append(obj)
            hist["r_max"].append(r_max)
            hist["eta_mean"].append(eta_mean)
            if prev is not None and it + 1 >= min_iters:
                if abs(obj - prev) / (abs(prev) + 1e-12) < rel_tol:
                    iters = it + 1
                    break
            prev = obj
        hist["iterations"] = iters
        return state, hist


def max_subspace_angle(W_nodes: torch.Tensor, W_ref: torch.Tensor
                       ) -> torch.Tensor:
    """Paper metric: max over nodes of the largest principal angle
    (degrees)."""
    return torch.rad2deg(cp.subspace_angle(W_nodes, W_ref).max())


def state_from_numpy(np_state: Mapping[str, np.ndarray],
                     device: torch.device | str) -> DPPCAState:
    """The reference's ``DPPCAState`` flattened to numpy -> the port's state
    on ``device``. Keys: the array fields by name (``W``, ``mu``, ``a``,
    ``Lam``, ``gam``, ``bet``, ``t``), ``theta_bar/<W|mu|a>`` and
    ``penalty/<PenaltyState field>``. Dtypes are kept."""
    def conv(v):
        return torch.as_tensor(np.array(v, copy=True), device=device)

    arrays = {f: conv(np_state[f]) for f in
              ("W", "mu", "a", "Lam", "gam", "bet", "t")}
    return DPPCAState(
        **arrays, theta_bar=tree_lib.from_flat(np_state, "theta_bar", conv),
        penalty=PenaltyState(*(conv(np_state[f"penalty/{f}"])
                               for f in PenaltyState._fields)))
