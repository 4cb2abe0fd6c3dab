"""Shared building blocks: norms, RoPE, SwiGLU MLP, embeddings (port of
``repro/models/layers.py``).

The ``*_tp`` forms are the tensor-parallel serve path's
(``launch.steps.make_serve_fns``): ``parts`` holds one entry for each
model shard the process computes (``distributed.fsdp.Served``), and a
leaf that the arch rules put on ``model`` is that shard's block (its
vocab rows, d_ff columns). Where the rules leave it whole, the product is
computed whole, once.
"""
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


def mlp_apply_tp(cfg: ArchConfig, mesh, parts: list[dict],
                 x: torch.Tensor) -> torch.Tensor:
    """The MLP on each shard's d_ff columns (``wi_gate``/``wi_up``) and
    rows (``wo``, row-parallel), the partials summed over ``model``."""
    if parts[0]["wi_gate"].shape[-1] == cfg.d_ff:
        return mlp_apply(parts[0], x)
    return mesh.model_sum([mlp_apply(p, x) for p in parts])


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


def embed_tokens_tp(cfg: ArchConfig, mesh, parts: list[torch.Tensor],
                    tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on each shard's vocab rows, zeros for the ids outside
    them, summed over ``model``: exact, as one shard holds each id."""
    rows = parts[0].shape[0]
    if rows == cfg.vocab:
        return F.embedding(tokens, parts[0])
    outs = []
    for m, table in zip(mesh.shards("model"), parts):
        ids = tokens - m * rows
        inside = (ids >= 0) & (ids < rows)
        e = F.embedding(ids.clamp(0, rows - 1), table)
        outs.append(torch.where(inside[..., None], e, 0))
    return mesh.model_sum(outs)


def unembed_tp(cfg: ArchConfig, mesh, parts: list[torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """The logits of each shard's vocab columns (``lm_head``, or the tied
    ``embed``'s rows), all-gathered over ``model``."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    outs = [unembed(cfg, {key: w}, x) for w in parts]
    vocab = parts[0].shape[0 if cfg.tie_embeddings else 1]
    if vocab == cfg.vocab:
        return outs[0]
    return torch.cat(mesh.model_gather(outs), dim=-1)
