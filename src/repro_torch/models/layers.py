"""Shared building blocks: norms, RoPE, SwiGLU MLP, embeddings (port of
``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain, cast back to x's dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def rope_table(seq_len: int, head_dim: int, theta: float, *,
               device: torch.device | str, dtype=torch.float32):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / (theta ** exps)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs[None, :]                  # [S, half]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [S, hd//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- MLP ------
def mlp_defs(cfg: ArchConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamDef((d, f), dtype, logical_axes=("fsdp", "mlp")),
        "wi_up": ParamDef((d, f), dtype, logical_axes=("fsdp", "mlp")),
        "wo": ParamDef((f, d), dtype, logical_axes=("mlp", "fsdp")),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


# ----------------------------------------------------------- embeddings -----
def embed_defs(cfg: ArchConfig, dtype) -> dict:
    out = {"embed": ParamDef((cfg.vocab, cfg.d_model), dtype, init="embed",
                             scale=0.02, logical_axes=("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), dtype,
                                  logical_axes=("fsdp", "vocab"))
    return out


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["embed"])


def unembed(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w
