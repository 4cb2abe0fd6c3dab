"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``).

These are what the CPU tests hold against the reference and what
``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, head-major.

    q, k, v: [B, H, S, hd] (K/V already repeated to the query heads). The
    logits are taken in the inputs' dtype, widened to f32 and scaled by
    1/sqrt(hd) (an f32 scalar); masked logits are set to -1e30; the
    softmax is f32 and its probabilities are cast to q's dtype before the
    product with v. Returns [B, H, S, hd] in q's dtype.
    """
    s, hd = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(float(hd))              # applied in f32
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def rwkv6_scan_ref(r, k, v, log_w, u, s0):
    """The WKV6 recurrence, one step at a time, in f32.

    r, k, v: [B, H, T, hd]; log_w: [B, H, T, hd] (log decay, <= 0);
    u: [H, hd] bonus; s0: [B, H, hd, hd] (key x value). Per step
        y_t = r_t^T (S + diag(u) k_t v_t^T);   S = diag(w_t) S + k_t v_t^T
    with w_t = exp(log_w_t). Returns (y [B, H, T, hd] in r's dtype,
    S_final [B, H, hd, hd] f32).
    """
    f32 = torch.float32
    w = torch.exp(log_w.to(f32))
    s = s0.to(f32)
    uu = u[None, :, :, None]
    rs, ks, vs = (t.to(f32) for t in (r, k, v))
    ys = []
    for t in range(r.shape[2]):
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rs[:, :, t], s + uu * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2).to(r.dtype), s


def consensus_round_ref(theta, lam, bar_prev, wires, scales, e_sym,
                        alpha, eta_sum, eta_node, *,
                        block_leaf, block_size: int,
                        bar_w=None, inv_deg=None, kick_w=None,
                        scales_per_block: bool = False,
                        partials: bool = False):
    """Whole-round flat-buffer consensus update, ungated or edge-gated.

    theta [J, total] (f32 or bf16), lam / bar_prev [J, total] f32, wires
    [deg, J, total] (theta's dtype, int8, or an fp8 type), scales
    [deg, J, L] f32 per-leaf dequant scales, e_sym [deg, J], alpha /
    eta_sum / eta_node [J]. ``block_leaf`` is the layout's [num_blocks]
    block->leaf table. With ``scales_per_block`` (the fp8 wires) the scale
    rows are [deg, J, num_blocks], indexed by the block id with no
    block->leaf lookup. Every wire type upcasts to f32 exactly.

    Reductions run blockwise in the kernel's order: per block, ``r`` the
    sum of ``(theta' - bar)^2`` and ``s`` ``eta_node^2`` times the sum of
    ``(bar - bar_prev)^2``, then the sum of the blocks per node, so that
    the kernel and this version agree to float32 round-off. Returns
    (theta_new, lam_new, bar f32, r_sq [J], s_sq [J]), or with ``partials``
    the block partials r_sq, s_sq [J, nblocks] that sum to them; the inputs
    are left untouched.

    Edge-gated round (``bar_w`` [deg, J] and ``inv_deg`` [J], together):
    the gates weight the neighbor-mean sum and ``inv_deg`` (1 / active
    degree, 0 for an isolated or ghost node) replaces 1/deg. Zero-kick
    (``kick_w`` [deg, J], gated round only): the dual also absorbs
    ``0.5 * sum_d kick_w[d] * (theta - x_d)`` at the round-start theta.
    The sums over the offsets run over d in increasing order, one rounding
    per multiply and add, exactly as the CUDA kernel does, so that the two
    agree bit for bit in theta', lam' and bar.
    """
    if (bar_w is None) != (inv_deg is None):
        raise ValueError("bar_w and inv_deg travel together")
    if kick_w is not None and bar_w is None:
        raise ValueError("kick_w needs the gated round (bar_w, inv_deg)")
    j, total = theta.shape
    deg = wires.shape[0]
    dev = theta.device
    f32 = torch.float32
    if scales_per_block:
        srows = scales.to(f32)                         # [deg, J, nblocks]
    else:
        bl = torch.as_tensor(block_leaf, dtype=torch.long, device=dev)
        srows = scales.to(f32)[..., bl]
    scale_vec = torch.repeat_interleave(srows, block_size, dim=-1)
    x = wires.to(f32) * scale_vec                      # [deg, J, total]
    e = e_sym.to(f32)
    w = None if bar_w is None else torch.as_tensor(bar_w, dtype=f32,
                                                   device=dev)
    nbr_w = torch.zeros((j, total), dtype=f32, device=dev)
    nbr_p = torch.zeros((j, total), dtype=f32, device=dev)
    for d in range(deg):
        nbr_w = nbr_w + e[d][:, None] * x[d]
        nbr_p = nbr_p + (x[d] if w is None else w[d][:, None] * x[d])
    if bar_w is None:
        bar = nbr_p * (1.0 / deg)
    else:
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

    def blocks(v):                                  # [J, nblocks]
        return v.reshape(j, -1, block_size).sum(dim=-1)

    r_sq = blocks((theta_new - bar) ** 2)
    dbar = bar - bar_prev.to(f32)
    eta_node = torch.as_tensor(eta_node, dtype=f32, device=dev)
    s_sq = (eta_node * eta_node)[:, None] * blocks(dbar * dbar)
    if not partials:
        r_sq, s_sq = r_sq.sum(dim=1), s_sq.sum(dim=1)
    return (theta_new.to(theta.dtype), lam_new.to(lam.dtype), bar, r_sq,
            s_sq)


def consensus_update_ref(theta, lam, nbr_avg, bar, bar_prev, *, eta_sum,
                         eta_node, step_size, block_size: int = 65536):
    """Flat consensus update with a precomputed neighbor mean (the
    reference's ``consensus_update`` kernel and its oracle).

    theta, lam, nbr_avg, bar, bar_prev: flat [N] vectors (theta and lam f32
    or bf16, the others f32); eta_sum, eta_node, step_size: scalars, taken
    as f32. N need not be a multiple of the block size: padding with zeros
    is a fixed point of the update and adds nothing to the sums.

        theta' = theta - step (2 lam + eta_sum (theta - nbr_avg))
        lam'   = lam + (0.5 eta_sum) (theta' - nbr_avg)
        r_sq   = sum (theta' - bar)^2              (f32 theta')
        s_sq   = sum_b eta_node^2 sum_{i in b} (bar - bar_prev)^2

    Both sums are taken per block of ``min(block_size, N)`` elements first
    and then over the blocks, the reference kernel's order. Returns
    (theta' in theta's dtype, lam' in lam's dtype, r_sq [], s_sq []); the
    inputs are left untouched.
    """
    (n,) = theta.shape
    dev = theta.device
    f32 = torch.float32
    eta_sum, eta_node, step = (torch.as_tensor(x, dtype=f32, device=dev)
                               for x in (eta_sum, eta_node, step_size))
    theta32 = theta.to(f32)
    lam32 = lam.to(f32)
    nbr = nbr_avg.to(f32)
    bar32 = bar.to(f32)
    theta_new = theta32 - step * (2.0 * lam32 + eta_sum * (theta32 - nbr))
    lam_new = lam32 + (0.5 * eta_sum) * (theta_new - nbr)
    bs = min(block_size, n)
    pad = -n % bs

    def blocks(v):
        return torch.nn.functional.pad(v, (0, pad)).reshape(-1, bs)

    r_sq = blocks((theta_new - bar32) ** 2).sum(dim=1).sum()
    dbar = bar32 - bar_prev.to(f32)
    s_sq = (eta_node * eta_node * blocks(dbar * dbar).sum(dim=1)).sum()
    return theta_new.to(theta.dtype), lam_new.to(lam.dtype), r_sq, s_sq
