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
    """Whole-round flat-buffer consensus update (the ungated round).

    theta [J, total] (f32 or bf16), lam / bar_prev [J, total] f32, wires
    [deg, J, total] (theta's dtype or int8), scales [deg, J, L] f32 per-leaf
    dequant scales, e_sym [deg, J], alpha / eta_sum / eta_node [J].
    ``block_leaf`` is the layout's [num_blocks] block->leaf table.

    Reductions run blockwise in the kernel's order (block partials first,
    then the sum per node) so that the kernel and this version agree to
    float32 round-off. Returns (theta_new, lam_new, bar f32, r_sq [J],
    s_sq [J]); the inputs are left untouched.

    The edge-gated (``bar_w``/``inv_deg``), zero-kick (``kick_w``) and
    per-block-scale variants belong to later slices.
    """
    if bar_w is not None or inv_deg is not None or kick_w is not None:
        raise NotImplementedError(
            "edge-gated / zero-kick rounds come with the dynamic-topology "
            "slice")
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
    e = e_sym.to(f32)[..., None]
    nbr_w = (e * x).sum(dim=0)
    bar = x.sum(dim=0) * (1.0 / deg)
    eta_sum = torch.as_tensor(eta_sum, dtype=f32, device=dev)
    nbr = nbr_w / torch.clamp_min(eta_sum, 1e-12)[:, None]
    theta32 = theta.to(f32)
    lam32 = lam.to(f32)
    alpha = torch.as_tensor(alpha, dtype=f32, device=dev)[:, None]
    theta_new = theta32 - alpha * (2.0 * lam32
                                   + eta_sum[:, None] * (theta32 - nbr))
    lam_new = lam32 + 0.5 * eta_sum[:, None] * (theta_new - nbr)

    def blocksum(v):
        return v.reshape(j, -1, block_size).sum(dim=-1).sum(dim=-1)

    r_sq = blocksum((theta_new - bar) ** 2)
    dbar = bar - bar_prev.to(f32)
    eta_node = torch.as_tensor(eta_node, dtype=f32, device=dev)
    s_sq = eta_node ** 2 * blocksum(dbar * dbar)
    return (theta_new.to(theta.dtype), lam_new.to(lam.dtype), bar, r_sq,
            s_sq)
