"""Causal (optionally sliding-window) GQA attention, training path (port of
``repro/models/attention.py``).

The public functions keep the reference's ``[B, S, H, hd]`` layout. Decode
and the flash kernel (``use_kernel=True``) come with the serving slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, rms_norm, rope_table
from repro_torch.models.params import ParamDef

NEG_INF = -1e30
ATTN_CHUNK = 1024       # query-chunk length for the full-sequence path


def attn_defs(cfg: ArchConfig, dtype) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": ParamDef((d, h, hd), dtype),
        "wk": ParamDef((d, k, hd), dtype),
        "wv": ParamDef((d, k, hd), dtype),
        "wo": ParamDef((h, hd, d), dtype),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((h, hd), dtype, init="zeros")
        out["bk"] = ParamDef((k, hd), dtype, init="zeros")
        out["bv"] = ParamDef((k, hd), dtype, init="zeros")
    if cfg.qk_norm:
        out["qn"] = ParamDef((hd,), dtype, init="zeros")
        out["kn"] = ParamDef((hd,), dtype, init="zeros")
    return out


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, k, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, hd).reshape(
        b, s, k * n_rep, hd)


def flash_ref(q, k, v, *, causal: bool, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q: [B,Sq,H,hd]; k,v: [B,Sk,H,hd] (post-GQA)."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(float(hd))
    scale = torch.tensor(scale, dtype=torch.float32, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_causal_attention(q, k, v, *, window: int = 0,
                             chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Memory-bounded causal attention over static query chunks: chunk i
    attends only to K/V up to its own end (and from the window's start)."""
    sq = q.shape[1]
    if sq <= chunk:
        return flash_ref(q, k, v, causal=True, window=window)
    if sq % chunk:
        raise ValueError(f"sequence {sq} is not a multiple of chunk {chunk}")
    outs = []
    for i in range(sq // chunk):
        q_blk = q[:, i * chunk:(i + 1) * chunk]
        k_end = (i + 1) * chunk
        k_start = max(0, i * chunk - window + 1) if window > 0 else 0
        k_start = (k_start // chunk) * chunk
        outs.append(flash_ref(q_blk, k[:, k_start:k_end], v[:, k_start:k_end],
                              causal=True, window=window,
                              q_offset=i * chunk - k_start))
    return torch.cat(outs, dim=1)


def attention(cfg: ArchConfig, p: dict, x: torch.Tensor, cos, sin,
              chunk: int | None = None) -> torch.Tensor:
    """Full-sequence path (train / prefill). x: [B, S, D]."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    out = chunked_causal_attention(q, k, v, window=cfg.sliding_window,
                                   chunk=chunk or ATTN_CHUNK)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def make_rope(cfg: ArchConfig, seq_len: int, *, device,
              dtype=torch.float32):
    return rope_table(seq_len, cfg.head_dim, cfg.rope_theta, device=device,
                      dtype=dtype)
