"""Causal (optionally sliding-window) GQA attention: train, prefill and
decode (port of ``repro/models/attention.py``).

The public functions keep the reference's ``[B, S, H, hd]`` layout. The
plain path (``chunked_causal_attention``) is what training runs; the flash
kernel (``kernels.ops.flash_attention``, hand-written CUDA on the card, its
plain version on the CPU) is the reference's hot-path replacement of the
full-sequence forward, switched on with ``use_kernel=True``, as the serve
launcher's prefill does. The one-token decode step is plain PyTorch, as
the reference's is.

``attention`` and ``decode_attention_tp`` take ``parts``, each computed
model shard's leaves: ``[p]`` for a whole layer (training, one device),
or the tensor-parallel serve path's shards (``distributed.fsdp.Served``,
``launch.steps.make_serve_fns``), whose partials of the row-parallel
``wo`` are summed over ``model`` (``Mesh.model_sum``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import add_f32
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


def _project_q(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, None]
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
    return q


def _project_kv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    if cfg.qk_norm:
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return k, v


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    return (_project_q(cfg, p, x),) + _project_kv(cfg, p, x)


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


def _kv_of_heads(cfg: ArchConfig, t: torch.Tensor, m: int, h_loc: int
                 ) -> torch.Tensor:
    """Of every kv head's ``t`` [B, S, K, hd], the one of each query head
    of model shard m (query head h reads kv head h // (H / K))."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if h_loc % n_rep == 0:
        k_loc = h_loc // n_rep
        return _repeat_kv(t[:, :, m * k_loc:(m + 1) * k_loc], n_rep)
    idx = torch.arange(m * h_loc, (m + 1) * h_loc, device=t.device) // n_rep
    return t.index_select(2, idx)


def attention(cfg: ArchConfig, mesh, parts: list[dict], x: torch.Tensor,
              cos, sin, use_kernel: bool = False, chunk: int | None = None
              ) -> torch.Tensor:
    """Full-sequence path (train / prefill). x: [B, S, D]. ``parts`` holds
    each computed model shard's leaves (``[p]``: the whole layer, for
    which ``mesh`` is not read). Each shard computes its query heads, its
    own kv heads where the rules put them on ``model`` (else every kv
    head is computed once and each query head's taken), the attention on
    them (the kernel with ``use_kernel``) and its rows of the row-parallel
    ``wo``; the partials are summed over ``model`` (``Mesh.model_sum``).
    K/V are repeated to the query heads before the attention, with or
    without the kernel, as in the reference."""
    h_loc = parts[0]["wq"].shape[-2]
    whole = h_loc == cfg.n_heads
    shards = [(0, parts[0])] if whole else zip(mesh.shards("model"), parts)
    kv_whole = parts[0]["wk"].shape[-2] == cfg.n_kv_heads
    if kv_whole:
        k_all, v_all = _project_kv(cfg, parts[0], x)
        k_all = apply_rope(k_all, cos, sin)
    outs = []
    for m, p in shards:
        q = apply_rope(_project_q(cfg, p, x), cos, sin)
        if kv_whole:
            k, v = (_kv_of_heads(cfg, t, m, h_loc) for t in (k_all, v_all))
        else:
            k, v = _project_kv(cfg, p, x)
            k = apply_rope(k, cos, sin)
            n_rep = h_loc // k.shape[2]
            k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if use_kernel:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, k, v, causal=True,
                                       window=cfg.sliding_window)
        else:
            out = chunked_causal_attention(q, k, v,
                                           window=cfg.sliding_window,
                                           chunk=chunk or ATTN_CHUNK)
        outs.append(torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    return outs[0] if whole else mesh.model_sum(outs)


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

    # a model shard's block of a whole cache is a strided view: its
    # products read a contiguous copy, as a rank's own cache is
    k_all, v_all = cache.k.contiguous(), cache.v.contiguous()
    n_rep = q.shape[2] // k_all.shape[2]
    kr, vr = _repeat_kv(k_all, n_rep), _repeat_kv(v_all, n_rep)
    logits = _decode_logits(cfg, q, kr)
    valid = _decode_valid(cfg, torch.arange(s_cache, device=x.device),
                          write, pos, s_cache)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    cache.pos.fill_(pos + 1)
    return y, cache


def _decode_logits(cfg: ArchConfig, q, kr) -> torch.Tensor:
    scale = 1.0 / math.sqrt(float(cfg.head_dim))    # applied in f32
    return torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32) * scale


def _decode_valid(cfg: ArchConfig, kpos, write: int, pos: int,
                  s_cache: int) -> torch.Tensor:
    """Which cache slots (global indices ``kpos``) hold a key."""
    if cfg.sliding_window:
        return (kpos <= write) | (pos >= s_cache)   # ring buffer occupancy
    return kpos <= pos


# --------------------------------------------------- tensor parallelism -----
def _all_heads(mesh, ts: list[torch.Tensor], split: bool) -> torch.Tensor:
    """Every head [B, 1, heads, hd] of each computed model shard's ``ts``:
    all-gathered over ``model`` where ``split``, else ``ts[0]``, whole."""
    return torch.cat(mesh.model_gather(ts), dim=2) if split else ts[0]


def decode_attention_tp(cfg: ArchConfig, mesh, parts: list[dict],
                        x: torch.Tensor, caches: list[KVCache], pos: int,
                        rope_cos_full, rope_sin_full, split: str
                        ) -> torch.Tensor:
    """The one-token step of the serve path (``parts`` as in
    ``attention``), on each model shard's block of the cache (``caches``, written IN PLACE), which
    ``decode_state_specs`` splits on ``split``:

      * ``"heads"`` (kv heads): each shard's own query and kv heads, the
        new key and value into its cache, ``wo`` row-parallel;
      * ``"seq"`` (cache slots; ring slots under a sliding window): shard
        m owns slots ``[m S/tp, (m+1) S/tp)``, and its owner writes the
        new key and value (every kv head's: the shards' gathered where
        ``model`` splits them); each shard attends every query head over
        its slots, in float32, and the partials (output, row max and
        normaliser) are merged by log-sum-exp in rank order; each shard
        keeps its query heads' output for its rows of ``wo``.

    Returns y [B, 1, D], alike on every model rank."""
    if split == "heads":
        return mesh.model_sum([
            decode_attention(cfg, p, x, c, pos, rope_cos_full,
                             rope_sin_full)[0]
            for p, c in zip(parts, caches)])
    cos = rope_cos_full[pos:pos + 1]
    sin = rope_sin_full[pos:pos + 1]
    h_loc = parts[0]["wq"].shape[-2]
    heads_split = h_loc < cfg.n_heads
    kv_split = parts[0]["wk"].shape[-2] < cfg.n_kv_heads
    q = _all_heads(mesh, [apply_rope(_project_q(cfg, p, x), cos, sin)
                          for p in (parts if heads_split else parts[:1])],
                   heads_split)
    kvs = [_project_kv(cfg, p, x) for p in (parts if kv_split else parts[:1])]
    k_new = _all_heads(mesh, [apply_rope(k, cos, sin) for k, _ in kvs],
                       kv_split)
    v_new = _all_heads(mesh, [v for _, v in kvs], kv_split)
    s_loc = caches[0].k.shape[1]
    s_cache = s_loc * mesh.model
    write = pos % s_cache if cfg.sliding_window else pos
    n_rep = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    packed = []
    for m, c in zip(mesh.shards("model"), caches):
        lo = m * s_loc
        if lo <= write < lo + s_loc:
            c.k[:, write - lo] = k_new[:, 0]
            c.v[:, write - lo] = v_new[:, 0]
        kr = _repeat_kv(c.k.contiguous(), n_rep)
        vr = _repeat_kv(c.v.contiguous(), n_rep)
        valid = _decode_valid(cfg, lo + torch.arange(s_loc, device=x.device),
                              write, pos, s_cache)[None, None, None, :]
        logits = torch.where(valid, _decode_logits(cfg, q, kr), NEG_INF)
        top = logits.amax(-1, keepdim=True)
        e = torch.where(valid, torch.exp(logits - top), 0.0)
        o = torch.einsum("bhqk,bkhd->bhqd", e, vr.to(torch.float32))
        packed.append(torch.cat([o, top, e.sum(-1, keepdim=True)], dim=-1))
    packed = mesh.model_gather(packed)              # [B, H, 1, hd + 2] each
    top = torch.stack([t[..., hd:hd + 1] for t in packed]).amax(0)
    scale = [torch.exp(t[..., hd:hd + 1] - top) for t in packed]
    num = add_f32([t[..., :hd] * w for t, w in zip(packed, scale)])
    den = add_f32([t[..., hd + 1:] * w for t, w in zip(packed, scale)])
    out = (num / den).to(x.dtype).transpose(1, 2)   # [B, 1, H, hd]
    caches[0].pos.fill_(pos + 1)
    if not heads_split:
        return torch.einsum("bshk,hkd->bsd", out, parts[0]["wo"])
    return mesh.model_sum([
        torch.einsum("bshk,hkd->bsd", out[:, :, m * h_loc:(m + 1) * h_loc],
                     p["wo"])
        for m, p in zip(mesh.shards("model"), parts)])


def make_rope(cfg: ArchConfig, seq_len: int, *, device,
              dtype=torch.float32):
    return rope_table(seq_len, cfg.head_dim, cfg.rope_theta, device=device,
                      dtype=dtype)
