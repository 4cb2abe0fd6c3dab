"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): the routing
and the reference's single-device path.

Routing: softmax gate in f32, top-k, the top-k weights renormalised
(Moonlight/Kimi convention), cast back to the activations' dtype. On one
device the reference runs its dense masked reference ``moe_ref``: every
expert on every token, weighted by the routing mask, with no token
dropped. Its expert-parallel paths (the fixed-capacity all-to-all
dispatch and the replicated decode path, ``repro/models/moe.py:80-182``)
need several devices and are not ported.

``moe_ref`` computes the reference's function, summed in another order:
the reference builds every expert's output ``[T, E, D]`` and then combines
them with the mask, which at kimi-k2's full width and 2,048 tokens is an
11.3 GB tensor. Here the mask's weights are folded into the gated hidden
activations ``[T, E, F]`` first, and one product ``[T, E*F] @ [E*F, D]``
sums over experts and hidden units at once (over a group of experts at a
time where all of them would not fit). In float32 the two orders agree
to round-off; in bf16 the reference rounds each expert's output to bf16
before the combine, this path rounds the weighted activations, so they
agree to a few bf16 ulps of the output (``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef


# elements of one expert group's [E_g, T, max(F, D)] intermediates
_GROUP_ELEMS = 1 << 30


def moe_defs(cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    e = cfg.moe
    return {
        "router": ParamDef((d, e.num_experts), dtype, scale=0.02),
        "wg": ParamDef((e.num_experts, d, e.expert_d_ff), dtype),
        "wu": ParamDef((e.num_experts, d, e.expert_d_ff), dtype),
        "wd": ParamDef((e.num_experts, e.expert_d_ff, d), dtype),
    }


def _route(cfg: ArchConfig, router_w: torch.Tensor, x: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D] -> (top-k ids [T, k] int64, renormalised weights [T, k]
    in x's dtype).

    Equal gates are taken lower expert id first, as ``jax.lax.top_k``
    takes them (``torch.topk`` promises no order among ties): a stable
    descending sort, then its first k.
    """
    gates = torch.softmax((x @ router_w.to(x.dtype)).to(torch.float32),
                          dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :cfg.moe.top_k], top_i[:, :cfg.moe.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_i, top_w.to(x.dtype)


def moe_ref(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense masked MoE. x: [B, S, D]."""
    b, s, d = x.shape
    e = cfg.moe
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    top_i, top_w = _route(cfg, p["router"], xt)
    # mask[t, ex] = the combined weight of expert ex for token t, added in
    # x's dtype (the k ids of a token are distinct)
    mask = torch.zeros((t, e.num_experts), dtype=x.dtype, device=x.device)
    mask = mask.scatter_add(1, top_i, top_w)
    # every expert on every token, a group of experts at a time, so that
    # the [E_g, T, F] intermediates stay bounded (kimi-k2's 384 experts at
    # 2,048 tokens would take 3.2 GB per tensor at once), the groups'
    # products summed in float32
    group = max(1, _GROUP_ELEMS // (t * max(e.expert_d_ff, d)))
    y = None
    for e0 in range(0, e.num_experts, group):
        sl = slice(e0, min(e0 + group, e.num_experts))
        n = sl.stop - sl.start
        xe = xt.expand(n, t, d)              # x broadcast over the group
        h = torch.bmm(xe, p["wg"][sl])
        u = torch.bmm(xe, p["wu"][sl])
        a = (F.silu(h) * u) * mask.T[sl, :, None]
        a = a.permute(1, 0, 2).reshape(t, n * e.expert_d_ff)
        part = a @ p["wd"][sl].reshape(n * e.expert_d_ff, d)
        y = part.float() if y is None else y + part
    return y.to(x.dtype).reshape(b, s, d)


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The reference's entry point. x: [B, S, D]. On one device the
    reference takes ``moe_ref`` for training, prefill and decode alike
    (``repro/models/moe.py:196-199``); so does the port, which has no
    expert-parallel path (the reference's ``decode`` switch picks between
    two of those)."""
    return moe_ref(cfg, p, x)
