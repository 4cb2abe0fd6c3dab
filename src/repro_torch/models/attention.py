"""Causal (optionally sliding-window) GQA attention: train, prefill and
decode (port of ``repro/models/attention.py``).

The public functions keep the reference's ``[B, S, H, hd]`` layout. The
plain path (``chunked_causal_attention``) is what training runs; the flash
kernel (``kernels.ops.flash_attention``, hand-written CUDA on the card, its
plain version on the CPU) is the reference's hot-path replacement of the
full-sequence forward, switched on with ``use_kernel=True``, as the serve
launcher's prefill does. The one-token decode step is plain PyTorch, as
the reference's is.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, rms_norm, rope_table
from repro_torch.models.params import ParamDef

NEG_INF = -1e30
ATTN_CHUNK = 1024       # query-chunk length for the full-sequence path


class KVCache(NamedTuple):
    k: torch.Tensor     # [B, S_cache, K, hd]
    v: torch.Tensor     # [B, S_cache, K, hd]
    pos: torch.Tensor   # [] int32: next write position (ring for sliding)


def attn_defs(cfg: ArchConfig, dtype) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": ParamDef((d, h, hd), dtype,
                       logical_axes=("fsdp", "heads", None)),
        "wk": ParamDef((d, k, hd), dtype,
                       logical_axes=("fsdp", "kv_heads", None)),
        "wv": ParamDef((d, k, hd), dtype,
                       logical_axes=("fsdp", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), dtype,
                       logical_axes=("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((h, hd), dtype, init="zeros",
                             logical_axes=("heads", None))
        out["bk"] = ParamDef((k, hd), dtype, init="zeros",
                             logical_axes=("kv_heads", None))
        out["bv"] = ParamDef((k, hd), dtype, init="zeros",
                             logical_axes=("kv_heads", None))
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
              use_kernel: bool = False, chunk: int | None = None
              ) -> torch.Tensor:
    """Full-sequence path (train / prefill). x: [B, S, D]. K/V are repeated
    to the query heads before the attention, with or without the kernel,
    as in the reference."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window)
    else:
        out = chunked_causal_attention(q, k, v, window=cfg.sliding_window,
                                       chunk=chunk or ATTN_CHUNK)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ------------------------------------------------------------- decoding -----
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    """Sliding-window archs keep a ring buffer of ``window``, else full S."""
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     cache: KVCache, pos: int, rope_cos_full, rope_sin_full
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token step. x: [B, 1, D]; pos: absolute position (a host int).

    Updates ``cache`` IN PLACE (the reference returns an updated copy): the
    new key and value at the write position, ``pos + 1`` into
    ``cache.pos``. Returns (y [B, 1, D], cache).
    """
    q, k, v = _project_qkv(cfg, p, x)
    cos = rope_cos_full[pos:pos + 1]
    sin = rope_sin_full[pos:pos + 1]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    s_cache = cache.k.shape[1]
    write = pos % s_cache if cfg.sliding_window else pos
    cache.k[:, write] = k[:, 0]
    cache.v[:, write] = v[:, 0]

    n_rep = q.shape[2] // cache.k.shape[2]
    kr, vr = _repeat_kv(cache.k, n_rep), _repeat_kv(cache.v, n_rep)
    scale = 1.0 / math.sqrt(float(cfg.head_dim))    # applied in f32
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32) * scale
    kpos = torch.arange(s_cache, device=x.device)
    if cfg.sliding_window:
        valid = (kpos <= write) | (pos >= s_cache)   # ring buffer occupancy
    else:
        valid = kpos <= pos
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    cache.pos.fill_(pos + 1)
    return y, cache


def make_rope(cfg: ArchConfig, seq_len: int, *, device,
              dtype=torch.float32):
    return rope_table(seq_len, cfg.head_dim, cfg.rope_theta, device=device,
                      dtype=dtype)
