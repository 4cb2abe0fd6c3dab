"""Public model API (port of ``repro/models/model.py``): init, parameter
counts, sharding specs, loss, prefill and decode.

The audio and vision archs' frontends are stubs, as in the reference: they
take precomputed embeddings in place of tokens (``embeds`` [B, S, D] for a
training or prefill batch, ``embed_in`` [B, D] for a decode step).
``stub_embeds`` draws such embeddings, standard normal float32, as the
reference's ``make_batch`` and serve launcher draw them (from a
``torch.Generator``, so not the reference's numbers).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as plib
from repro_torch.models import transformer as tf


def arch_rules(cfg: ArchConfig, mesh) -> dict:
    """Per-arch logical->mesh rules (``repro/models/model.py:21-36``): the
    head, kv-head, flattened-head, mlp and vocab axes go to ``model`` only
    where ``model`` divides them. The reference's query heads are its
    ``eff_heads``, ``n_heads`` itself at its ``PAD_HEADS_MULT`` of 0."""
    tp = mesh.shape["model"] if mesh is not None else 1
    h_eff = cfg.n_heads
    heads_ok = h_eff % tp == 0 and h_eff > 0
    kv_ok = cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads > 0
    rules = shd.default_rules(kv_divisible=kv_ok, heads_divisible=heads_ok)
    # flattened head projections (SSM / RWKV) shard if q_dim divides
    rules["heads_flat"] = "model" if cfg.q_dim % max(tp, 1) == 0 else None
    if cfg.d_ff % max(tp, 1) != 0:
        rules["mlp"] = None
    if cfg.vocab % max(tp, 1) != 0:
        rules["vocab"] = None
    return rules


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    cfg: ArchConfig
    dtype: torch.dtype

    def param_defs(self) -> dict:
        return tf.stacked_defs(self.cfg, self.dtype)

    def init(self, gen: torch.Generator, device: torch.device | str,
             mesh=None, specs=None) -> dict:
        """The parameters drawn from ``gen``; on a rank of ``mesh``, only
        its experts of each expert leaf, or with ``specs`` its shards
        (``params.materialize``)."""
        return plib.materialize(gen, self.param_defs(), device, mesh=mesh,
                                specs=specs)

    def param_specs(self, rules: dict | None = None) -> dict:
        """The parameters' specs under ``rules`` (else the installed
        rules; ``repro/models/model.py:54-55``)."""
        return plib.spec_tree(self.param_defs(), rules)

    def param_count(self) -> int:
        return plib.count(self.param_defs())

    def active_param_count(self) -> int:
        """Per-token touched params (MoE experts scaled by top_k/E)."""
        total = 0
        for path, leaf in tree_lib.leaves_with_paths(self.param_defs(),
                                                     is_leaf=plib.is_def):
            n = int(np.prod(leaf.shape))
            if self.cfg.moe is not None and any(
                    k in ("wg", "wu", "wd") for k in path):
                n = n * self.cfg.moe.top_k // self.cfg.moe.num_experts
            total += n
        return total

    def loss(self, params: dict, batch: dict, **kw):
        """``transformer.loss_fn``: ``count``, ``read`` and ``remat`` for
        the in-pod sharded local step (``distributed.fsdp``)."""
        return tf.loss_fn(self.cfg, params, batch, **kw)

    def prefill(self, params: dict, batch: dict, use_kernel: bool = False,
                read=None) -> torch.Tensor:
        """Full-sequence logits of ``batch["tokens"]`` [B, S] (or
        ``batch["embeds"]`` [B, S, D]); with ``use_kernel`` the attention or
        time-mix runs its kernel (see ``transformer.forward``); with the
        serve reader ``read`` (``distributed.fsdp.Served``) split over the
        mesh's ``model`` axis."""
        return tf.forward(self.cfg, params, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), use_kernel=use_kernel,
                          read=read)

    def init_decode_state(self, batch: int, max_len: int,
                          device: torch.device | str, mesh=None
                          ) -> tf.DecodeState:
        """The empty decode state; on a rank of ``mesh`` (``batch`` the
        global batch) its shard only (``transformer.init_decode_state``)."""
        return tf.init_decode_state(self.cfg, batch, max_len, device,
                                    mesh=mesh)

    def decode_step(self, params: dict, state: tf.DecodeState,
                    token: torch.Tensor | None, *, max_len: int,
                    embed_in: torch.Tensor | None = None, read=None):
        return tf.decode_step(self.cfg, params, state, token,
                              max_len=max_len, embed_in=embed_in, read=read)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg, dtype=torch_dtype(cfg.dtype))


def stub_embeds(cfg: ArchConfig, shape: tuple[int, ...],
                gen: torch.Generator, device) -> torch.Tensor:
    """Frontend-stub embeddings of ``shape`` + (d_model,): standard normal,
    float32 (the model casts them to its dtype)."""
    return torch.randn(tuple(shape) + (cfg.d_model,), generator=gen,
                       dtype=torch.float32, device=device)
