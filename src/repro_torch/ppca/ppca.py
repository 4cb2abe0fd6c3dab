"""Centralized Probabilistic PCA (Tipping & Bishop, 1999): EM and the closed
form (port of ``repro/ppca/ppca.py``).

The model:  x = W z + mu + eps,   z ~ N(0, I_M),  eps ~ N(0, a^{-1} I_D)
with noise *precision* a (the paper's convention, §4.1).

Every function takes leading batch axes on all of its arguments (``W``
[..., D, M], ``mu`` [..., D], ``a`` [...], ``x`` [..., N, D]) and
broadcasts them, so D-PPCA runs the per-node math on its node axis, and
its objective probes on a [J, J] grid, with batched ``torch.linalg``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PPCAParams(NamedTuple):
    W: torch.Tensor     # [..., D, M] projection
    mu: torch.Tensor    # [..., D]    mean
    a: torch.Tensor     # [...]       noise precision (1/sigma^2)


class EStats(NamedTuple):
    Ez: torch.Tensor    # [..., N, M]     posterior means  E[z_n]
    Ezz: torch.Tensor   # [..., N, M, M]  posterior second moments


def init_params(generator: torch.Generator, d: int, m: int,
                dtype: torch.dtype = torch.float32) -> PPCAParams:
    """Standard-normal W drawn from ``generator`` (on its device), zero mean,
    unit precision."""
    dev = generator.device
    return PPCAParams(
        W=torch.randn((d, m), generator=generator, dtype=dtype, device=dev),
        mu=torch.zeros((d,), dtype=dtype, device=dev),
        a=torch.ones((), dtype=dtype, device=dev))


def _eye(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)


def e_step(params: PPCAParams, x: torch.Tensor) -> EStats:
    """Posterior stats (paper eq. 13): M = W^T W + a^{-1} I."""
    W, mu, a = params
    Mmat = W.mT @ W + _eye(W) / a[..., None, None]
    Minv = torch.linalg.inv(Mmat)
    xc = x - mu[..., None, :]
    Ez = xc @ W @ Minv.mT                                   # [..., N, M]
    Ezz = (Minv / a[..., None, None])[..., None, :, :] \
        + Ez[..., :, :, None] * Ez[..., :, None, :]          # [..., N, M, M]
    return EStats(Ez=Ez, Ezz=Ezz)


def _sq_err(xc, W, Ez, Ezz) -> torch.Tensor:
    """sum_n E||xc_n - W z_n||^2 under the posterior, per batch entry."""
    return ((xc * xc).sum((-2, -1))
            - 2.0 * ((xc @ W) * Ez).sum((-2, -1))
            + (Ezz * (W.mT @ W)[..., None, :, :]).sum((-3, -2, -1)))


def m_step(stats: EStats, x: torch.Tensor, params: PPCAParams) -> PPCAParams:
    """Standard (unconstrained) M-step."""
    Ez, Ezz = stats
    n, d = x.shape[-2:]
    mu = (x - Ez @ params.W.mT).mean(dim=-2)
    xc = x - mu[..., None, :]
    W = torch.linalg.solve(Ezz.sum(-3), (xc.mT @ Ez).mT).mT       # [.., D, M]
    a = (n * d) / torch.clamp_min(_sq_err(xc, W, Ez, Ezz), 1e-12)
    return PPCAParams(W=W, mu=mu, a=a)


def nll(params: PPCAParams, x: torch.Tensor) -> torch.Tensor:
    """Exact negative log-likelihood under C = W W^T + a^{-1} I, per batch
    entry.

    Uses the Woodbury and determinant-lemma forms, so the cost is
    O(N D M + M^3): stable for D up to thousands (the SfM transposed layout
    has D = #points).
    """
    W, mu, a = params
    n, d = x.shape[-2:]
    m = W.shape[-1]
    Mmat = W.mT @ W + _eye(W) / a[..., None, None]          # [..., M, M]
    # |C| = a^{-(D-M)} |W^T W + a^{-1} I|
    _, logdet_M = torch.linalg.slogdet(Mmat)
    logdet_C = -(d - m) * torch.log(a) + logdet_M
    xc = x - mu[..., None, :]
    # tr(C^{-1} S_total) with C^{-1} = a (I - W Mmat^{-1} W^T)
    xW = xc @ W                                              # [..., N, M]
    sol = torch.linalg.solve(Mmat, xW.mT).mT                 # [..., N, M]
    quad = a * ((xc * xc).sum((-2, -1)) - (xW * sol).sum((-2, -1)))
    return 0.5 * (n * d * math.log(2.0 * math.pi) + n * logdet_C + quad)


def fit_em(params: PPCAParams, x: torch.Tensor, max_iters: int = 200
           ) -> tuple[PPCAParams, torch.Tensor]:
    """Plain EM for a fixed number of iterations; returns the final
    parameters and the NLL after each iteration [max_iters]."""
    trace = []
    for _ in range(max_iters):
        params = m_step(e_step(params, x), x, params)
        trace.append(nll(params, x))
    return params, torch.stack(trace)


def fit_svd(x: torch.Tensor, m: int) -> PPCAParams:
    """Closed-form ML solution (Tipping & Bishop): the global optimum. W is
    fixed only up to the sign of each column (the SVD's choice)."""
    n, d = x.shape
    mu = x.mean(0)
    xc = x - mu[None]
    _, s, vt = torch.linalg.svd(xc, full_matrices=False)
    evals = (s * s) / n                             # eigenvalues of S
    sigma2 = evals[m:].sum() / max(d - m, 1)
    W = vt[:m].mT * torch.sqrt(torch.clamp_min(evals[:m] - sigma2, 0.0))[None]
    return PPCAParams(W=W, mu=mu, a=1.0 / torch.clamp_min(sigma2, 1e-12))


def subspace_angle(Wa: torch.Tensor, Wb: torch.Tensor) -> torch.Tensor:
    """Largest principal angle (radians) between span(Wa) and span(Wb)
    [..., D, M], per batch entry."""
    qa, _ = torch.linalg.qr(Wa)
    qb, _ = torch.linalg.qr(Wb)
    s = torch.linalg.svdvals(qa.mT @ qb)
    return torch.arccos(torch.clamp(s.amin(dim=-1), -1.0, 1.0))
