"""Mamba2-style selective SSM head, the SSM half of Hymba blocks (port of
``repro/models/ssm.py``).

Per head h with state size N (discretized, dt > 0 via softplus):
    h_t = exp(-dt_t * exp(A_log)) * h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t @ C_t + D_skip * x_t
with B_t, C_t shared across heads (n_groups=1) and a SiLU gate z. The
depthwise causal conv of Mamba is omitted, as in the reference.

The recurrence is a loop over time steps in plain PyTorch, as the
reference's ``lax.scan`` (it has no kernel for it). dt, the decay and the
state are float32; the update ``dt x B`` is formed in float32 (JAX's
promotion of the activations' dtype with float32), and y is cast back to
the activations' dtype before the ``D_skip`` term.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef


class SSMState(NamedTuple):
    h: torch.Tensor     # [B, H, hd, N] f32


def ssm_defs(cfg: ArchConfig, dtype) -> dict:
    d, di, n, hh = cfg.d_model, cfg.q_dim, cfg.ssm_state, cfg.n_heads
    return {
        "w_x": ParamDef((d, di), dtype, logical_axes=("fsdp", "heads_flat")),
        "w_z": ParamDef((d, di), dtype, logical_axes=("fsdp", "heads_flat")),
        "w_b": ParamDef((d, n), dtype, logical_axes=("fsdp", None)),
        "w_c": ParamDef((d, n), dtype, logical_axes=("fsdp", None)),
        "w_dt": ParamDef((d, hh), dtype, logical_axes=("fsdp", None)),
        "dt_bias": ParamDef((hh,), dtype, init="zeros"),
        "a_log": ParamDef((hh,), dtype, init="zeros"),
        "d_skip": ParamDef((hh,), dtype, init="ones"),
        "w_out": ParamDef((di, d), dtype,
                           logical_axes=("heads_flat", "fsdp")),
    }


def _proj(cfg: ArchConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    hh, hd = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    xi = (x @ p["w_x"]).reshape(b, s, hh, hd)
    z = x @ p["w_z"]
    bt = x @ p["w_b"]                                     # [B, S, N]
    ct = x @ p["w_c"]
    pre = (x @ p["w_dt"]).to(f32) + p["dt_bias"].to(f32)  # [B, S, H]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))     # jax softplus
    decay = torch.exp(-dt * torch.exp(p["a_log"].to(f32)))
    return xi, z, bt, ct, dt, decay


def ssm_apply(cfg: ArchConfig, p: dict, x: torch.Tensor,
              state: SSMState | None = None
              ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence scan. x: [B, S, D]. Returns (y, final state)."""
    b, s, _ = x.shape
    hh, hd, n = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    f32 = torch.float32
    xi, z, bt, ct, dt, decay = _proj(cfg, p, x)
    h = state.h if state is not None else torch.zeros(
        (b, hh, hd, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        upd = (dt[:, t, :, None] * xi[:, t])[..., None] \
            * bt[:, t, None, None, :]                    # [B, H, hd, N] f32
        h = decay[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhdn,bn->bhd", h, ct[:, t].to(f32)))
    y = torch.stack(ys, dim=1).to(x.dtype)               # [B, S, H, hd]
    y = y + p["d_skip"][None, None, :, None] * xi
    y = y.reshape(b, s, -1) * F.silu(z)
    return y @ p["w_out"], SSMState(h=h)


def ssm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
               state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """Single-token step. x: [B, 1, D]."""
    return ssm_apply(cfg, p, x, state)
