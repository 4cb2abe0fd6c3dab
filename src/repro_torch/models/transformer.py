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

Training (``loss_fn``) and serving (``forward``, ``decode_step``) read
the parameters through a ``read``. Under an in-pod mesh
(``distributed.fsdp``) a rank holds only its shards of the parameters:
``loss_fn``'s ``read`` gives each layer's leaves gathered just before its
block (``read.layer``) and the embedding, final norm and LM head where
they are read (``read.leaf``), and with ``remat`` each layer (and the
head with the loss) runs under a checkpoint, so that its gathered leaves
and activations are freed after the forward and gathered and recomputed
in the backward: the counterpart of the reference's ``remat=True``. A
tied embedding is read once for both its uses. ``loss_fn`` with
``count`` divides the masked sum of its rows by the node's whole token
count, so that the data ranks' losses add up to the node's mean.

The serve path's ``read`` gives each leaf as a list, one entry for each
model shard the process computes: the whole tree as one shard
(``OneShard``, the default), or on a mesh ``distributed.fsdp.Served``
(``launch.steps.make_serve_fns``), with which ``forward`` and
``decode_step`` split each block over the ``model`` axis as the
reference's rules and constraints split it: the attention's query heads
(and kv heads where ``model`` divides them), the MLP's d_ff, the RWKV
time-mix's heads and channel-mix's d_ff, the MoE's experts (expert
parallel, on the replicated output of the attention's sum), the
embedding's and the head's vocab; the partials are summed over ``model``
after the attention and after the FFN (``Mesh.model_sum``), and the
logits all-gathered. ``decode_step`` runs on a rank's shard of the decode
state (``decode_state_specs``), or on the one-process mesh on each
shard's block of the whole state in turn. hymba's SSM heads do not split
on ``model`` (``check_servable``). Training and the serve path's prefill
run one block (``_block``): training's is the one-shard case, its layer's
whole leaves as ``[p]``.

``forward`` takes ``use_kernel`` (the reference's ``forward`` does not):
it routes the reference's own switch on ``attention`` and ``time_mix`` to
their kernels, which the reference names the hot path of the
full-sequence forward, on each model shard's heads. The serve launcher's
prefill sets it; training does not, since neither kernel has a backward.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (current_mesh, current_rules,
                                              fit_spec, local_mesh,
                                              recomputing, use_mesh)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_defs, embed_tokens,
                                       embed_tokens_tp, mlp_apply_tp,
                                       mlp_defs, rms_norm, unembed,
                                       unembed_tp)
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


def _ffn(cfg: ArchConfig, mesh, parts: list[dict], h: torch.Tensor,
         decode: bool = False) -> torch.Tensor:
    """The block's FFN: SwiGLU on each shard's d_ff, or the MoE (under a
    mesh, expert parallel: the all-to-all path, with ``decode`` the
    replicated one)."""
    if cfg.moe is not None:
        return moe_lib.moe_apply(cfg, [p["moe"] for p in parts], h,
                                 decode=decode)
    return mlp_apply_tp(cfg, mesh, [p["mlp"] for p in parts], h)


def _block(cfg: ArchConfig, mesh, parts: list[dict], x: torch.Tensor,
           cos, sin, use_kernel: bool = False) -> torch.Tensor:
    """A full-sequence block. ``parts``: each computed model shard's
    leaves of the layer, the block split over ``mesh``'s ``model`` axis;
    ``[p]`` for the whole layer (``mesh`` is then not read)."""
    p0 = parts[0]
    h = rms_norm(x, p0["ln1"], cfg.norm_eps)
    if cfg.rwkv:
        rp = [p["rwkv"] for p in parts]
        y, _, _ = rwkv_lib.time_mix(cfg, mesh, rp, h, None,
                                    use_kernel=use_kernel)
        x = x + y
        h2 = rms_norm(x, p0["ln2"], cfg.norm_eps)
        y2, _ = rwkv_lib.channel_mix(cfg, mesh, rp, h2, None)
        return x + y2
    y = attn_lib.attention(cfg, mesh, [p["attn"] for p in parts], h, cos,
                           sin, use_kernel=use_kernel)
    if cfg.ssm_state:                    # whole: model 1 (check_servable)
        y_ssm, _ = ssm_lib.ssm_apply(cfg, p0["ssm"], h)
        y = 0.5 * (y + y_ssm)            # hymba: parallel heads, averaged
    x = x + y
    h2 = rms_norm(x, p0["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, mesh, parts, h2)


def _block_full(cfg: ArchConfig, p: dict, x: torch.Tensor, cos, sin,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence block of training (whole leaves, under autograd)."""
    return _block(cfg, None, [p], x, cos, sin, use_kernel)


def _layer(params: dict, layer: int) -> dict:
    return tree_lib.tree_map(lambda a: a[layer], params["blocks"])


class Whole:
    """Reads a whole parameter tree (``loss_fn``'s default ``read``)."""

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


def _trunk(cfg: ArchConfig, params: dict, tokens, embeds, read, remat: bool,
           embed) -> torch.Tensor:
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
        return _block_full(cfg, read.layer(params, layer), x, cos, sin)
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
    x = _trunk(cfg, params, batch.get("tokens"), batch.get("embeds"), read,
               remat, embed)

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


# ---------------------------------------------------------- serving -----
def check_servable(cfg: ArchConfig, mesh) -> None:
    """Raise for an arch whose heads the serve path cannot split over
    ``model``: hymba's SSM (its ``heads_flat`` columns, 25 heads of 64 at
    model 2, are not cut at head boundaries), and an RWKV whose heads
    ``model`` does not divide."""
    tp = 1 if mesh is None else mesh.model
    if tp == 1:
        return
    if cfg.ssm_state or (cfg.rwkv and cfg.n_heads % tp):
        raise NotImplementedError(
            f"{cfg.arch_id}: serving on a mesh with model {tp} > 1 is not "
            "ported: its SSM or RWKV heads do not split at head boundaries "
            "over model (ROADMAP.md Queue 1, item 1(e): hymba's SSM heads "
            "on a mesh)")


class OneShard:
    """Reads a whole parameter tree as the serve path's one model shard
    (``forward``'s and ``decode_step``'s default ``read``, without a
    mesh; ``distributed.fsdp.Served`` on one)."""

    mesh = local_mesh(1, 1, "cpu")

    @staticmethod
    def layer(params: dict, layer: int) -> list[dict]:
        return [_layer(params, layer)]

    @staticmethod
    def leaf(params: dict, name: str) -> list[torch.Tensor]:
        return [params[name]]


def _serve_embed(cfg: ArchConfig, params: dict, read, tokens, embeds):
    """The input activations and the tied table's entries (else None)."""
    table = read.leaf(params, "embed") \
        if embeds is None or cfg.tie_embeddings else None
    x = embeds if embeds is not None \
        else embed_tokens_tp(cfg, read.mesh, table, tokens)
    return x.to(torch_dtype(cfg.dtype)), \
        (table if cfg.tie_embeddings else None)


def _serve_head(cfg: ArchConfig, params: dict, read, x, table):
    x = rms_norm(x, read.leaf(params, "final_norm")[0], cfg.norm_eps)
    w = table if cfg.tie_embeddings else read.leaf(params, "lm_head")
    return unembed_tp(cfg, read.mesh, w, x)


def forward(cfg: ArchConfig, params: dict, *,
            tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            use_kernel: bool = False, read=None) -> torch.Tensor:
    """Full-sequence forward to logits (the serve path's prefill). tokens
    [B, S] or embeds [B, S, D] (the frontend stubs' precomputed
    embeddings). ``read`` gives the leaves: ``OneShard`` by default, or
    ``distributed.fsdp.Served`` to split the blocks over a mesh's
    ``model`` axis."""
    read = read or OneShard
    mesh = read.mesh
    check_servable(cfg, mesh)
    x, table = _serve_embed(cfg, params, read, tokens, embeds)
    cos = sin = None
    if not cfg.rwkv:
        cos, sin = attn_lib.make_rope(cfg, x.shape[1], device=x.device)
    for layer in range(cfg.n_layers):
        x = _block(cfg, mesh, read.layer(params, layer), x, cos, sin,
                   use_kernel)
    return _serve_head(cfg, params, read, x, table)


# --------------------------------------------------------------- decode -----
class DecodeState(NamedTuple):
    cache: dict         # per-family state, leaves stacked [L, ...]
    pos: int            # absolute position of the next token (host int)


def _state_spec(cfg: ArchConfig, tp: int, batch_axes, field: str,
                nd: int) -> tuple:
    """One decode-state leaf's spec (``repro/launch/steps.py:107-126``)."""
    if field in ("k", "v"):             # KV cache [L, B, S, K, hd]
        if cfg.n_kv_heads % tp == 0 and not cfg.sliding_window:
            return (None, batch_axes, None, "model", None)
        return (None, batch_axes, "model", None, None)
    if field in ("s", "h"):             # rwkv [L, B, H, hd, hd]; ssm [.., N]
        if cfg.n_heads % tp == 0:
            return (None, batch_axes, "model", None, None)
        return (None, batch_axes, None, "model", None)
    if field in ("prev_tm", "prev_cm"):  # [L, B, D]
        return (None, batch_axes, None)
    return (None,) * nd


def decode_state_specs(cfg: ArchConfig, mesh, batch: int, max_len: int
                       ) -> tuple[DecodeState, DecodeState]:
    """The global decode state's shapes and dtypes (tensors on the
    ``meta`` device) and, leaf for leaf, its specs under the arch rules
    (the reference's ``decode_state_specs``, ``repro/launch/steps.py:98-142``,
    after ``fit_spec``): K/V on the kv heads where ``model`` divides them
    and there is no sliding window, else on the sequence (ring) slots;
    the RWKV and SSM states on their heads, else on head_dim; batch on
    ``data``; the rest, the per-layer write position among it,
    replicated. The state's host ``pos`` has the spec ``()``."""
    from repro_torch.models.model import arch_rules
    batch_axes = arch_rules(cfg, mesh)["batch"]
    state = init_decode_state(cfg, batch, max_len, "meta")
    cache = {name: type(entry)(*(
        fit_spec(mesh, t.shape, _state_spec(cfg, mesh.model, batch_axes, f,
                                            t.dim()))
        for f, t in zip(entry._fields, entry)))
        for name, entry in state.cache.items()}
    return state, DecodeState(cache=cache, pos=())


def decode_shard_shapes(cfg: ArchConfig, mesh, batch: int, max_len: int
                        ) -> dict:
    """The shape of a rank's shard of each cache leaf of the global decode
    state (``decode_state_specs``), as ``{family: {field: shape}}``."""
    from repro_torch.distributed.fsdp import shard_shape
    state, specs = decode_state_specs(cfg, mesh, batch, max_len)
    return {name: {f: shard_shape(t.shape, s, mesh) for f, t, s in zip(
        entry._fields, entry, specs.cache[name])}
        for name, entry in state.cache.items()}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device, mesh=None) -> DecodeState:
    """The empty decode state of ``batch`` sequences; on a rank of
    ``mesh``, with ``batch`` the global batch, this rank's shard of it
    only (``decode_shard_shapes``; the one-process mesh holds the whole
    state)."""
    if mesh is not None and not mesh.local:
        shapes = decode_shard_shapes(cfg, mesh, batch, max_len)
        whole = init_decode_state(cfg, batch, max_len, "meta")
        return DecodeState(cache={
            name: type(entry)(*(torch.zeros(shapes[name][f], dtype=t.dtype,
                                            device=device)
                                for f, t in zip(entry._fields, entry)))
            for name, entry in whole.cache.items()}, pos=0)
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


def _kv_split(cfg: ArchConfig, mesh, max_len: int) -> str:
    """The cache dimension ``decode_state_specs`` puts on ``model``:
    ``"heads"`` or ``"seq"`` (``"heads"`` on a model axis of 1)."""
    if mesh.model == 1:
        return "heads"
    s_cache = min(max_len, cfg.sliding_window or max_len)
    spec = fit_spec(mesh, (cfg.n_layers, mesh.data, s_cache, cfg.n_kv_heads,
                           cfg.head_dim),
                    _state_spec(cfg, mesh.model, None, "k", 5))
    if spec[3] == "model":
        return "heads"
    if spec[2] == "model":
        return "seq"
    raise ValueError(f"{cfg.arch_id}: a decode cache of "
                     f"{s_cache} slots "
                     f"and {cfg.n_kv_heads} kv heads does not split over "
                     f"{mesh.model} model ranks")


def _block_of(mesh, t: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """Model shard m's block of a state leaf along ``dim``: a rank's state
    is its shard already; the one-process mesh's is whole (a view)."""
    if not mesh.local or mesh.model == 1:
        return t
    size = t.shape[dim] // mesh.model
    return t.narrow(dim, m * size, size)


def decode_step(cfg: ArchConfig, params: dict, state: DecodeState,
                token: torch.Tensor | None, *, max_len: int,
                embed_in: torch.Tensor | None = None, read=None
                ) -> tuple[torch.Tensor, DecodeState]:
    """One new token for every sequence. token: [B] int (or, for the
    frontend stubs, ``embed_in`` [B, D]). Returns (logits [B, V], the next
    state).

    The caches are updated IN PLACE (the reference returns new ones): the
    returned state holds the same tensors as ``state`` with ``pos + 1``.
    ``read`` as in ``forward``: with ``distributed.fsdp.Served`` the step
    is split over ``model``, on a rank's shard of the state or on each
    shard's block of the one-process mesh's whole state in turn.
    """
    read = read or OneShard
    mesh = read.mesh
    check_servable(cfg, mesh)
    shards = mesh.shards("model")
    if embed_in is not None:
        x, table = _serve_embed(cfg, params, read, None,
                                embed_in[:, None, :])
    else:
        x, table = _serve_embed(cfg, params, read, token[:, None], None)
    pos = state.pos
    if not cfg.rwkv:
        split = _kv_split(cfg, mesh, max_len)
        dim = 2 if split == "heads" else 1      # of a layer's [B, S, K, hd]
        cos_full, sin_full = attn_lib.make_rope(cfg, max_len,
                                                device=x.device)
    for layer in range(cfg.n_layers):
        parts = read.layer(params, layer)
        p0 = parts[0]
        h = rms_norm(x, p0["ln1"], cfg.norm_eps)
        if cfg.rwkv:
            st = state.cache["rwkv"]
            rcs = [rwkv_lib.RWKVState(s=_block_of(mesh, st.s[layer], 1, m),
                                      prev_tm=st.prev_tm[layer],
                                      prev_cm=st.prev_cm[layer])
                   for m in shards]
            rp = [p["rwkv"] for p in parts]
            y, s_new, last_tm = rwkv_lib.time_mix(cfg, mesh, rp, h, rcs)
            x = x + y
            h2 = rms_norm(x, p0["ln2"], cfg.norm_eps)
            y2, last_cm = rwkv_lib.channel_mix(cfg, mesh, rp, h2, rcs[0])
            x = x + y2
            for rc, s_m in zip(rcs, s_new):
                rc.s.copy_(s_m)
            st.prev_tm[layer].copy_(last_tm)
            st.prev_cm[layer].copy_(last_cm)
            continue
        kv = state.cache["kv"]
        caches = [attn_lib.KVCache(k=_block_of(mesh, kv.k[layer], dim, m),
                                   v=_block_of(mesh, kv.v[layer], dim, m),
                                   pos=kv.pos[layer]) for m in shards]
        y = attn_lib.decode_attention_tp(
            cfg, mesh, [p["attn"] for p in parts], h, caches, pos, cos_full,
            sin_full, split)
        if cfg.ssm_state:                # whole: model 1 (check_servable)
            sc = state.cache["ssm"]
            y_ssm, ssm_new = ssm_lib.ssm_decode(
                cfg, p0["ssm"], h, ssm_lib.SSMState(h=sc.h[layer]))
            y = 0.5 * (y + y_ssm)
            sc.h[layer].copy_(ssm_new.h)
        x = x + y
        h2 = rms_norm(x, p0["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, mesh, parts, h2, decode=True)
    logits = _serve_head(cfg, params, read, x, table)[:, 0, :]
    return logits, DecodeState(cache=state.cache, pos=pos + 1)
