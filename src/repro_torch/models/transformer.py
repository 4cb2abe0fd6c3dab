"""Decoder stack: block definitions, full-sequence forward, decode step
(port of ``repro/models/transformer.py``).

One generic block covers all the reference's families:
  * dense / moe / audio / vlm : pre-norm attention + (SwiGLU | MoE) FFN
  * hybrid (hymba)            : attention and SSM heads run in PARALLEL on
                                the same normed input, outputs averaged,
                                then FFN
  * ssm (rwkv6)               : RWKV time-mix + channel-mix (attention-free)

The audio and vision archs' frontends are stubs, as in the reference:
``forward`` takes precomputed frame or patch embeddings (``embeds``) in
place of tokens, and ``decode_step`` one embedding per sequence
(``embed_in``). Layers are stacked on a leading L axis as in the
reference; the forward pass and the decode step loop over them in Python
where the reference scans. Without a mesh of more than one shard there is
no rematerialization: at the depths this port trains on one device (a few
layers at full width) the activations fit beside the state, so autograd
keeps them.

Under an in-pod mesh (``distributed.fsdp``) a rank holds only its shards
of the parameters: ``forward`` and ``loss_fn`` take a ``read`` that gives
each layer's leaves gathered just before its block (``read.layer``) and
the embedding, final norm and LM head where they are read
(``read.leaf``), and with ``remat`` each layer (and the head with the
loss) runs under a checkpoint, so that its gathered leaves and
activations are freed after the forward and gathered and recomputed in
the backward: the counterpart of the reference's ``remat=True``. A tied
embedding is read once for both its uses. ``loss_fn`` with ``count``
divides the masked sum of its rows by the node's whole token count, so
that the data ranks' losses add up to the node's mean.

``forward`` takes ``use_kernel`` (the reference's ``forward`` does not):
it routes the reference's own switch on ``attention`` and ``time_mix`` to
their kernels, which the reference names the hot path of the
full-sequence forward. The serve launcher's prefill sets it; training
leaves it off, since neither kernel has a backward.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (current_mesh, current_rules,
                                              recomputing, use_mesh)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_defs, embed_tokens, mlp_apply,
                                       mlp_defs, rms_norm, unembed)
from repro_torch.models.params import ParamDef, is_def
from repro_torch.device import torch_dtype


def block_defs(cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    out: dict[str, Any] = {
        "ln1": ParamDef((d,), dtype, init="zeros"),
        "ln2": ParamDef((d,), dtype, init="zeros"),
    }
    if cfg.rwkv:
        out["rwkv"] = rwkv_lib.rwkv_defs(cfg, dtype)
        return out
    out["attn"] = attn_lib.attn_defs(cfg, dtype)
    if cfg.ssm_state:
        out["ssm"] = ssm_lib.ssm_defs(cfg, dtype)
    if cfg.moe is not None:
        out["moe"] = moe_lib.moe_defs(cfg, dtype)
    else:
        out["mlp"] = mlp_defs(cfg, dtype)
    return out


def stacked_defs(cfg: ArchConfig, dtype) -> dict:
    """All model parameters; block leaves get a leading layer axis."""
    blocks = tree_lib.tree_map(
        lambda p: ParamDef((cfg.n_layers,) + p.shape, p.dtype, p.init,
                           p.scale, logical_axes=(None,) + p.axes),
        block_defs(cfg, dtype), is_leaf=is_def)
    out = dict(embed_defs(cfg, dtype))
    out["blocks"] = blocks
    out["final_norm"] = ParamDef((cfg.d_model,), dtype, init="zeros")
    return out


def _block_full(cfg: ArchConfig, p: dict, x: torch.Tensor, cos, sin,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence block (train / prefill)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.rwkv:
        y, _, _ = rwkv_lib.time_mix(cfg, p["rwkv"], h, None,
                                    use_kernel=use_kernel)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y2, _ = rwkv_lib.channel_mix(cfg, p["rwkv"], h2, None)
        return x + y2
    y = attn_lib.attention(cfg, p["attn"], h, cos, sin,
                           use_kernel=use_kernel)
    if cfg.ssm_state:
        y_ssm, _ = ssm_lib.ssm_apply(cfg, p["ssm"], h)
        y = 0.5 * (y + y_ssm)            # hymba: parallel heads, averaged
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h2)


def _ffn(cfg: ArchConfig, p: dict, h: torch.Tensor,
         decode: bool = False) -> torch.Tensor:
    """The block's FFN: SwiGLU, or the MoE (under a mesh, the all-to-all
    path for full sequences and with ``decode`` the replicated one)."""
    if cfg.moe is not None:
        return moe_lib.moe_apply(cfg, p["moe"], h, decode=decode)
    return mlp_apply(p["mlp"], h)


def _layer(params: dict, layer: int) -> dict:
    return tree_lib.tree_map(lambda a: a[layer], params["blocks"])


class Whole:
    """Reads a whole parameter tree (``forward``'s default ``read``)."""

    @staticmethod
    def layer(params: dict, layer: int) -> dict:
        return _layer(params, layer)

    @staticmethod
    def leaf(params: dict, name: str) -> torch.Tensor:
        return params[name]


def _remat_context():
    return contextlib.nullcontext(), recomputing()


def _checkpointed(fn, remat: bool, *args):
    """``fn(*args)``, under a checkpoint when ``remat`` and autograd is on;
    the ambient mesh is installed again for the recomputation, which may
    run on the autograd engine's own thread."""
    mesh, rules = current_mesh(), current_rules()

    def run(*a):
        with use_mesh(mesh, rules):
            return fn(*a)
    if remat and torch.is_grad_enabled():
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, early_stop=False,
                          context_fn=_remat_context)
    return run(*args)


def _trunk(cfg: ArchConfig, params: dict, tokens, embeds, use_kernel: bool,
           read, remat: bool, embed) -> torch.Tensor:
    """The embedding and every block: the last hidden state."""
    if embeds is None:
        x = embed_tokens({"embed": embed if embed is not None
                          else read.leaf(params, "embed")}, tokens)
    else:
        x = embeds
    x = x.to(torch_dtype(cfg.dtype))
    cos = sin = None
    if not cfg.rwkv:
        cos, sin = attn_lib.make_rope(cfg, x.shape[1], device=x.device)

    def block(x, layer):
        return _block_full(cfg, read.layer(params, layer), x, cos, sin,
                           use_kernel=use_kernel)
    for layer in range(cfg.n_layers):
        x = _checkpointed(block, remat, x, layer)
    return x


def _head(cfg: ArchConfig, params: dict, x: torch.Tensor, read,
          embed) -> torch.Tensor:
    x = rms_norm(x, read.leaf(params, "final_norm"), cfg.norm_eps)
    w = {"embed": embed} if cfg.tie_embeddings \
        else {"lm_head": read.leaf(params, "lm_head")}
    return unembed(cfg, w, x)


def _tied_embed(cfg: ArchConfig, params: dict, read):
    """The embedding, read once, where both the lookup and the head use
    it; else None (each reads its own leaf where it needs it)."""
    if cfg.tie_embeddings:
        return read.leaf(params, "embed")
    return None


def forward(cfg: ArchConfig, params: dict, *,
            tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            use_kernel: bool = False, read=None,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward to logits. tokens [B, S] or embeds [B, S, D]
    (the frontend stubs' precomputed embeddings). ``read`` gives the
    leaves (``Whole`` by default; ``distributed.fsdp.Gathered`` on a rank
    that holds shards)."""
    read = read or Whole
    embed = _tied_embed(cfg, params, read)
    x = _trunk(cfg, params, tokens, embeds, use_kernel, read, remat, embed)
    return _head(cfg, params, x, read, embed)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            count: torch.Tensor | None = None, read=None,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over labels >= 0 (f32). The batch
    holds ``tokens`` or, for the frontend stubs, ``embeds``. With
    ``count`` the masked sum is divided by it (the node's token count)
    instead of by the batch's own."""
    read = read or Whole
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    embed = _tied_embed(cfg, params, read)
    x = _trunk(cfg, params, batch.get("tokens"), batch.get("embeds"), False,
               read, remat, embed)

    def head_nll(x, embed):
        logits = _head(cfg, params, x, read, embed).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        # masked labels (-1) gather index 0; the mask zeroes their term
        ll = torch.gather(logits, -1,
                          labels.clamp_min(0)[..., None].long())[..., 0]
        return ((lse - ll) * mask).sum()
    total = _checkpointed(head_nll, remat, x, embed)
    if count is None:
        count = torch.clamp_min(mask.sum(), 1.0)
    nll = total / count
    return nll, {"loss": nll, "tokens": mask.sum()}


# --------------------------------------------------------------- decode -----
class DecodeState(NamedTuple):
    cache: dict         # per-family state, leaves stacked [L, ...]
    pos: int            # absolute position of the next token (host int)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device) -> DecodeState:
    dt = torch_dtype(cfg.dtype)
    l = cfg.n_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.rwkv:
        hh, hd = cfg.n_heads, cfg.head_dim
        cache = {"rwkv": rwkv_lib.RWKVState(
            s=zeros((l, batch, hh, hd, hd), torch.float32),
            prev_tm=zeros((l, batch, cfg.d_model), dt),
            prev_cm=zeros((l, batch, cfg.d_model), dt))}
    else:
        kv = attn_lib.init_cache(cfg, batch, max_len, dt, device)
        cache = {"kv": attn_lib.KVCache(
            k=zeros((l,) + tuple(kv.k.shape), dt),
            v=zeros((l,) + tuple(kv.v.shape), dt),
            pos=zeros((l,), torch.int32))}
        if cfg.ssm_state:
            cache["ssm"] = ssm_lib.SSMState(h=zeros(
                (l, batch, cfg.n_heads, cfg.head_dim, cfg.ssm_state),
                torch.float32))
    return DecodeState(cache=cache, pos=0)


def decode_step(cfg: ArchConfig, params: dict, state: DecodeState,
                token: torch.Tensor | None, *, max_len: int,
                embed_in: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, DecodeState]:
    """One new token for every sequence. token: [B] int (or, for the
    frontend stubs, ``embed_in`` [B, D]). Returns (logits [B, V], the next
    state).

    The caches are updated IN PLACE (the reference returns new ones): the
    returned state holds the same tensors as ``state`` with ``pos + 1``.
    """
    x = embed_in[:, None, :] if embed_in is not None \
        else embed_tokens(params, token[:, None])
    x = x.to(torch_dtype(cfg.dtype))
    pos = state.pos
    if not cfg.rwkv:
        cos_full, sin_full = attn_lib.make_rope(cfg, max_len,
                                                device=x.device)
    for layer in range(cfg.n_layers):
        lp = _layer(params, layer)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.rwkv:
            st = state.cache["rwkv"]
            rc = rwkv_lib.RWKVState(s=st.s[layer], prev_tm=st.prev_tm[layer],
                                    prev_cm=st.prev_cm[layer])
            y, s_new, last_tm = rwkv_lib.time_mix(cfg, lp["rwkv"], h, rc)
            x = x + y
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            y2, last_cm = rwkv_lib.channel_mix(cfg, lp["rwkv"], h2, rc)
            x = x + y2
            rc.s.copy_(s_new)
            rc.prev_tm.copy_(last_tm)
            rc.prev_cm.copy_(last_cm)
            continue
        kv = state.cache["kv"]
        y, _ = attn_lib.decode_attention(
            cfg, lp["attn"], h,
            attn_lib.KVCache(k=kv.k[layer], v=kv.v[layer], pos=kv.pos[layer]),
            pos, cos_full, sin_full)
        if cfg.ssm_state:
            sc = state.cache["ssm"]
            y_ssm, ssm_new = ssm_lib.ssm_decode(
                cfg, lp["ssm"], h, ssm_lib.SSMState(h=sc.h[layer]))
            y = 0.5 * (y + y_ssm)
            sc.h[layer].copy_(ssm_new.h)
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, decode=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x)[:, 0, :]
    return logits, DecodeState(cache=state.cache, pos=pos + 1)
