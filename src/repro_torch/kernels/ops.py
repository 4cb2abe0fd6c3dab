"""Public wrappers of the port's kernels.

A tensor's device picks the path, nothing else: CPU tensors go to the plain
PyTorch version in ``kernels/ref.py``; CUDA tensors go to the hand-written
kernel, or the call raises. No path falls back to the other.

Each wrapper counts its kernel launches in plain integer attributes, so that
a run can show that it went through the kernel:
``consensus_round.launches`` (the ungated round),
``consensus_round.masked_launches`` (the edge-gated one),
``consensus_round.per_block_launches`` (those of either with per-block
scales, the fp8 wires; counted in one of the first two as well),
``consensus_update.launches``, ``flash_attention.launches`` (the model
layout's and the head-major wrapper's launches of either attention
kernel), ``flash_attention.tc_launches`` (those of the tensor-core one,
bf16 at head dim 64, 80, 112 or 128; counted in ``launches`` as well) and
``rwkv6_scan.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import consensus_update as _cu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_scan as _rw

ATTN_BLOCK = 128    # the reference kernel's block: S % min(128, S) == 0
SCAN_CHUNK = 32     # the reference scan's default chunk


def _device_path(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def _flash(q, k, v, causal: bool, window: int, layout: str):
    s = q.shape[1] if layout == "bshd" else q.shape[2]
    blk = min(ATTN_BLOCK, s)
    if s % blk:
        raise ValueError(f"flash_attention: sequence {s} is not a multiple "
                         f"of the block {blk}")
    if _device_path("flash_attention", q):
        out = _fa.launch(q, k, v, causal=causal, window=window,
                         layout=layout)
        flash_attention.launches += 1
        if _fa.route(q.dtype, q.shape[3]) == "tc":
            flash_attention.tc_launches += 1
        return out
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:                    # query head h reads KV head h // n_rep
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    out = _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return out.transpose(1, 2) if layout == "bshd" else out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal (optionally sliding-window) GQA attention in the model layout
    (the reference's ``repro.kernels.ops.flash_attention``).

    q: [B, S, H, hd]; k, v: [B, S, K, hd] with H a multiple of K.
    Returns [B, S, H, hd] in q's dtype. S must be a multiple of
    ``min(128, S)``, as the reference's kernel asserts. The reference's
    ``block_q``/``block_k`` are its TPU tiling and have no counterpart:
    the CUDA kernels tile by their own sizes and compute the same function.
    On the card, bf16 at head dim 64, 80, 112 or 128 runs the tensor-core
    kernel (p rounded to bf16 for p.v) and the rest (float32, bf16 at hd
    16 or 32) the "cc" kernel, whose TF32 products in three parts keep
    about f32's precision (``kernels.flash_attention.route``).
    """
    return _flash(q, k, v, causal, window, "bshd")


flash_attention.launches = 0
flash_attention.tc_launches = 0


def flash_attention_hmajor(q, k, v, *, causal: bool = True,
                           window: int = 0):
    """Head-major ``flash_attention``: q [B, H, S, hd], k/v [B, K, S, hd]
    (the reference's ``flash_attention_hmajor``). Its launches count in
    ``flash_attention.launches`` (and ``tc_launches``)."""
    return _flash(q, k, v, causal, window, "bhsd")


def rwkv6_scan(r, k, v, w, u, s0, *, chunk: int = SCAN_CHUNK):
    """Chunked WKV6 scan in the model layout (the reference's
    ``repro.kernels.ops.rwkv6_scan``).

    r, k, v: [B, T, H, hd] in the model dtype; w: [B, T, H, hd] decay in
    (0, 1); u: [H, hd] bonus; s0: [B, H, hd, hd] f32. The log decay is
    ``log(max(w, 1e-38))`` in f32. T must be a multiple of
    ``min(chunk, T)``. Returns (y [B, T, H, hd] in r's dtype,
    S_final [B, H, hd, hd] f32).
    """
    t = r.shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"rwkv6_scan: T {t} is not a multiple of the "
                         f"chunk {chunk}")
    log_w = torch.log(torch.clamp_min(w, 1e-38)).to(torch.float32)
    if _device_path("rwkv6_scan", r):
        out = _rw.launch(r, k, v, log_w, u, s0, chunk=chunk)
        rwkv6_scan.launches += 1
        return out
    y, s = _ref.rwkv6_scan_ref(*(x.transpose(1, 2) for x in (r, k, v, log_w)),
                               u, s0)
    return y.transpose(1, 2), s


rwkv6_scan.launches = 0


def consensus_round(theta, lam, bar_prev, wires, scales, e_sym,
                    alpha, eta_sum, eta_node, *, block_leaf, block_size: int,
                    bar_w=None, inv_deg=None, kick_w=None,
                    scales_per_block: bool = False, partials: bool = False):
    """Whole-round fused consensus update over the flat buffer (the
    reference's ``repro.kernels.ops.consensus_round``).

    Args:
      theta: [J, total] f32 or bf16 node parameters (total = blocks * bs).
      lam, bar_prev: [J, total] f32 duals and last round's neighbor means.
      wires: [deg, J, total] rolled wire payloads, theta's dtype, int8 or
        an fp8 type (float8_e4m3fn, float8_e5m2); row d holds
        theta_{(i+off_d) % J} at node i.
      scales: [deg, J, L] f32 per-leaf dequant scales (ones for a native
        wire), or [deg, J, num_blocks] per-block ones with
        ``scales_per_block``.
      e_sym: [deg, J] f32 symmetrized per-edge penalties (zero on gated
        edges).
      alpha, eta_sum, eta_node: [J] f32 per-node scalars.
      block_leaf: [num_blocks] int32 owning leaf id per block (the layout
        table); every id must lie in [0, L), which the caller checks once
        where it builds the table. Not read with per-block scales.
      block_size: elements per block; must divide total.
      bar_w: optional [deg, J] f32 edge gates (1 = active) weighting the
        neighbor mean — the dynamic topology's mask.
      inv_deg: optional [J] f32, 1 / active degree (0 for isolated or ghost
        nodes); given together with ``bar_w``. Both None: the ungated round.
      kick_w: optional [deg, J] f32 zero-kick weights (gated round only):
        the dual also absorbs ``0.5 * sum_d kick_w[d] * (theta - x_d)``.
      scales_per_block: block b dequantizes with ``scales[..., b]`` (the
        fp8 codecs' granularity) instead of ``scales[..., block_leaf[b]]``.
      partials: return r_sq and s_sq as the ``[J, nblocks]`` block
        partials whose sum over dim 1 gives the ``[J]`` values (the
        kernel's on a CUDA tensor, the plain version's on the CPU). A
        caller that holds a block of the nodes, or a slab of the blocks,
        gathers these and sums them as the one-process call does, so the
        bits do not depend on how the rows or the blocks are split.

    Returns (theta_new [J, total], lam_new [J, total], bar [J, total] f32,
    r_sq [J], s_sq [J]). On a CUDA tensor the kernel writes theta_new, lam_new
    and bar IN PLACE over theta, lam and bar_prev and returns those tensors;
    on the CPU the plain version returns new tensors.
    """
    dev = theta.device
    if dev.type == "cpu":
        out = _ref.consensus_round_ref(
            theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum,
            eta_node, block_leaf=block_leaf, block_size=block_size,
            bar_w=bar_w, inv_deg=inv_deg, kick_w=kick_w,
            scales_per_block=scales_per_block, partials=partials)
        return out
    if dev.type != "cuda":
        raise ValueError(f"consensus_round: no kernel for device {dev}")
    rsq, ssq = _cu.launch(theta, lam, bar_prev, wires, scales, e_sym, alpha,
                          eta_sum, eta_node, block_leaf, block_size,
                          bar_w=bar_w, inv_deg=inv_deg, kick_w=kick_w,
                          scales_per_block=scales_per_block)
    if bar_w is None:
        consensus_round.launches += 1
    else:
        consensus_round.masked_launches += 1
    if scales_per_block:
        consensus_round.per_block_launches += 1
    if partials:
        return theta, lam, bar_prev, rsq, ssq
    return theta, lam, bar_prev, rsq.sum(dim=1), ssq.sum(dim=1)


consensus_round.launches = 0
consensus_round.masked_launches = 0
consensus_round.per_block_launches = 0


def consensus_update(theta, lam, nbr_avg, bar, bar_prev, *, eta_sum,
                     eta_node, step_size, block_size: int = 65536):
    """Flat consensus update with a precomputed neighbor mean (the
    reference's ``repro.kernels.ops.consensus_update``).

    theta, lam (f32 or bf16), nbr_avg, bar, bar_prev (f32): flat [N]
    vectors, N any length; eta_sum, eta_node, step_size: scalars (f32).
    Returns (theta_new [N], lam_new [N], r_sq [], s_sq []), see
    ``ref.consensus_update_ref``. On a CUDA tensor the kernel writes
    theta_new and lam_new IN PLACE over theta and lam and returns those
    tensors; on the CPU the plain version returns new tensors.
    """
    dev = theta.device
    kw = dict(eta_sum=eta_sum, eta_node=eta_node, step_size=step_size,
              block_size=block_size)
    if dev.type == "cpu":
        return _ref.consensus_update_ref(theta, lam, nbr_avg, bar, bar_prev,
                                         **kw)
    if dev.type != "cuda":
        raise ValueError(f"consensus_update: no kernel for device {dev}")
    rsq, ssq = _cu.launch_update(theta, lam, nbr_avg, bar, bar_prev, **kw)
    consensus_update.launches += 1
    return theta, lam, rsq.sum(), ssq.sum()


consensus_update.launches = 0
