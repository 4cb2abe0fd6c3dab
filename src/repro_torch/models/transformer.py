"""Decoder stack, dense block (port of ``repro/models/transformer.py``).

Layers are stacked on a leading L axis as in the reference; the forward pass
loops over them in Python where the reference scans. There is no
rematerialization: at the depths this port trains (a few layers at full
width) the activations fit beside the state, so autograd keeps them.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (embed_defs, embed_tokens, mlp_apply,
                                       mlp_defs, rms_norm, unembed)
from repro_torch.models.params import ParamDef, is_def
from repro_torch.device import torch_dtype


def _check_dense(cfg: ArchConfig):
    if cfg.rwkv or cfg.ssm_state or cfg.moe is not None \
            or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense transformer block is ported")


def block_defs(cfg: ArchConfig, dtype) -> dict:
    _check_dense(cfg)
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), dtype, init="zeros"),
        "ln2": ParamDef((d,), dtype, init="zeros"),
        "attn": attn_lib.attn_defs(cfg, dtype),
        "mlp": mlp_defs(cfg, dtype),
    }


def stacked_defs(cfg: ArchConfig, dtype) -> dict:
    """All model parameters; block leaves get a leading layer axis."""
    blocks = tree_lib.tree_map(
        lambda p: ParamDef((cfg.n_layers,) + p.shape, p.dtype, p.init,
                           p.scale),
        block_defs(cfg, dtype), is_leaf=is_def)
    out = dict(embed_defs(cfg, dtype))
    out["blocks"] = blocks
    out["final_norm"] = ParamDef((cfg.d_model,), dtype, init="zeros")
    return out


def _block_full(cfg: ArchConfig, p: dict, x: torch.Tensor, cos, sin
                ) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_lib.attention(cfg, p["attn"], h, cos, sin)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2)


def forward(cfg: ArchConfig, params: dict, *, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence forward to logits. tokens [B, S]."""
    _check_dense(cfg)
    x = embed_tokens(params, tokens).to(torch_dtype(cfg.dtype))
    cos, sin = attn_lib.make_rope(cfg, x.shape[1], device=x.device)
    for layer in range(cfg.n_layers):
        lp = tree_lib.tree_map(lambda a: a[layer], params["blocks"])
        x = _block_full(cfg, lp, x, cos, sin)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over labels >= 0 (f32)."""
    logits = forward(cfg, params, tokens=batch["tokens"]).to(torch.float32)
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    # masked labels (-1) gather index 0; the mask zeroes their term
    ll = torch.gather(logits, -1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = ((lse - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll, {"loss": nll, "tokens": mask.sum()}
