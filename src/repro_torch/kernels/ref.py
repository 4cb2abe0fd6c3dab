"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``).

These are what the CPU tests hold against the reference and what
``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def consensus_round_ref(theta, lam, bar_prev, wires, scales, e_sym,
                        alpha, eta_sum, eta_node, *,
                        block_leaf, block_size: int,
                        bar_w=None, inv_deg=None, kick_w=None,
                        scales_per_block: bool = False):
    """Whole-round flat-buffer consensus update, ungated or edge-gated.

    theta [J, total] (f32 or bf16), lam / bar_prev [J, total] f32, wires
    [deg, J, total] (theta's dtype or int8), scales [deg, J, L] f32 per-leaf
    dequant scales, e_sym [deg, J], alpha / eta_sum / eta_node [J].
    ``block_leaf`` is the layout's [num_blocks] block->leaf table.

    Reductions run blockwise in the kernel's order (block partials first,
    then the sum per node) so that the kernel and this version agree to
    float32 round-off. Returns (theta_new, lam_new, bar f32, r_sq [J],
    s_sq [J]); the inputs are left untouched.

    Edge-gated round (``bar_w`` [deg, J] and ``inv_deg`` [J], together):
    the gates weight the neighbor-mean sum and ``inv_deg`` (1 / active
    degree, 0 for an isolated or ghost node) replaces 1/deg. Zero-kick
    (``kick_w`` [deg, J], gated round only): the dual also absorbs
    ``0.5 * sum_d kick_w[d] * (theta - x_d)`` at the round-start theta.
    The gated sums run over d in increasing order, one rounding per
    multiply and add, exactly as the CUDA kernel does. Per-block scales
    belong to the fp8 slice.
    """
    if (bar_w is None) != (inv_deg is None):
        raise ValueError("bar_w and inv_deg travel together")
    if kick_w is not None and bar_w is None:
        raise ValueError("kick_w needs the gated round (bar_w, inv_deg)")
    if scales_per_block:
        raise NotImplementedError(
            "per-block scales come with the fp8 wire slice")
    j, total = theta.shape
    deg = wires.shape[0]
    dev = theta.device
    f32 = torch.float32
    bl = torch.as_tensor(block_leaf, dtype=torch.long, device=dev)
    srows = scales.to(f32)[..., bl]                    # [deg, J, nblocks]
    scale_vec = torch.repeat_interleave(srows, block_size, dim=-1)
    x = wires.to(f32) * scale_vec                      # [deg, J, total]
    if bar_w is None:
        e = e_sym.to(f32)[..., None]
        nbr_w = (e * x).sum(dim=0)
        bar = x.sum(dim=0) * (1.0 / deg)
    else:
        e = e_sym.to(f32)
        w = torch.as_tensor(bar_w, dtype=f32, device=dev)
        nbr_w = torch.zeros((j, total), dtype=f32, device=dev)
        nbr_p = torch.zeros((j, total), dtype=f32, device=dev)
        for d in range(deg):
            nbr_w = nbr_w + e[d][:, None] * x[d]
            nbr_p = nbr_p + w[d][:, None] * x[d]
        bar = nbr_p * torch.as_tensor(inv_deg, dtype=f32,
                                      device=dev)[:, None]
    eta_sum = torch.as_tensor(eta_sum, dtype=f32, device=dev)
    nbr = nbr_w / torch.clamp_min(eta_sum, 1e-12)[:, None]
    theta32 = theta.to(f32)
    lam32 = lam.to(f32)
    alpha = torch.as_tensor(alpha, dtype=f32, device=dev)[:, None]
    theta_new = theta32 - alpha * (2.0 * lam32
                                   + eta_sum[:, None] * (theta32 - nbr))
    lam_new = lam32 + 0.5 * eta_sum[:, None] * (theta_new - nbr)
    if kick_w is not None:
        k = torch.as_tensor(kick_w, dtype=f32, device=dev)
        kick_x = torch.zeros((j, total), dtype=f32, device=dev)
        ksum = torch.zeros((j,), dtype=f32, device=dev)
        for d in range(deg):
            kick_x = kick_x + k[d][:, None] * x[d]
            ksum = ksum + k[d]
        lam_new = lam_new + 0.5 * (ksum[:, None] * theta32 - kick_x)

    def blocksum(v):
        return v.reshape(j, -1, block_size).sum(dim=-1).sum(dim=-1)

    r_sq = blocksum((theta_new - bar) ** 2)
    dbar = bar - bar_prev.to(f32)
    eta_node = torch.as_tensor(eta_node, dtype=f32, device=dev)
    s_sq = eta_node ** 2 * blocksum(dbar * dbar)
    return (theta_new.to(theta.dtype), lam_new.to(lam.dtype), bar, r_sq,
            s_sq)
