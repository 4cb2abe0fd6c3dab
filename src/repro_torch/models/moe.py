"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): routing, the
reference's single-device path and its two expert-parallel (EP) paths.

Routing: softmax gate in f32, top-k, the top-k weights renormalised
(Moonlight/Kimi convention), cast back to the activations' dtype.
``moe_apply`` picks the path as the reference does: with no ambient mesh
(``distributed.sharding.use_mesh``), a ``model`` axis of 1, or a ``model``
axis that does not divide the experts, the dense masked ``moe_ref``
(every expert on every token, nothing dropped); otherwise EP over the
``model`` axis, with model rank m holding experts ``[m E/ep, (m+1) E/ep)``:

  * the all-to-all path (full-sequence blocks: training's forward and the
    prefill): rank (d, m) takes the batch rows of data index d and
    sequence slice m (the reference's ``P(batch, "model", None)``), routes
    its ``t_loc`` tokens and dispatches each (token, expert) pair to the
    expert's rank with a fixed capacity of ``max(k, int(t_loc * k / ep *
    capacity_factor))`` slots a destination: pairs ordered by destination
    (a stable sort), slot = the pair's rank among its destination's pairs,
    kept while slot < capacity; dropped pairs get weight zero. The rows go
    out by one all-to-all (with each slot's local expert id), through the
    grouped FFN, back by another, and are combined on the source rank; the
    output is all-gathered over the model axis to the whole sequence.
  * the replicated path (``decode=True``, the decode step): every model
    rank routes all of its data rows' tokens, computes only the pairs of
    its own experts, and the partial sums are added over the model axis.

The all-to-all path runs under autograd (the local step of training and
the probes, ``distributed.fsdp``), with the backward of each exchange
(``distributed.sharding.Mesh``): the all-gather of the outputs keeps this
rank's slice of the gradient (the model ranks compute alike after it);
the slice of the replicated x all-gathers the slices' gradients, so that
every model rank holds the whole ``dx``; the replicated router sums its
gradient over the model ranks in rank order; each all-to-all runs
backward as the same exchange of the gradients. A dropped pair moves no
row and gets a zero gradient; the slot-(0, 0) row, zeroed as the
reference writes it, passes none. A rank's tree holds its own experts
only (sharded parameters gathered over ``data``,
``params.shard_experts``) or all of them (a whole tree, as a probe of a
neighbour's parameters gives it): then it reads its slice.

Two of the reference's numbers are mirrored on purpose:

  * its dispatch scatters every pair, dropped ones as zero rows into slot
    (0, 0) of destination 0, and on its CPU backend the last write wins.
    So when a shard drops any pair, slot (0, 0) (the first kept pair to
    destination 0) is sent as a zero row with local expert id 0, and that
    pair contributes nothing. ``_dispatch_local`` writes the same.
  * its combine (``segment_sum``) and its ``psum`` have no fixed order on
    a card. The port sums each token's k pairs in top-k order, in f32, and
    the model ranks' partials in rank order (all-gathered, then added), so
    that ranks equal the one-process mesh bit for bit.

The grouped FFN (``_expert_ffn_ragged``, the reference's ``lax.ragged_dot``,
an XLA op and no Pallas kernel) loops over the local experts' contiguous
row ranges, one product per expert: reading the group sizes is one host
synchronisation per call, two a layer on a rank.

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
from repro_torch.distributed.sharding import (Mesh, current_mesh,
                                              is_recomputing)
from repro_torch.models.params import ParamDef


# elements of one expert group's [E_g, T, max(F, D)] intermediates
_GROUP_ELEMS = 1 << 30


def moe_defs(cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    e = cfg.moe
    return {
        "router": ParamDef((d, e.num_experts), dtype, scale=0.02),
        "wg": ParamDef((e.num_experts, d, e.expert_d_ff), dtype,
                       logical_axes=("experts", "fsdp", None)),
        "wu": ParamDef((e.num_experts, d, e.expert_d_ff), dtype,
                       logical_axes=("experts", "fsdp", None)),
        "wd": ParamDef((e.num_experts, e.expert_d_ff, d), dtype,
                       logical_axes=("experts", None, "fsdp")),
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


# ------------------------------------------------------------------ EP ------
def _expert_ffn_ragged(wg, wu, wd, x_sorted, group_sizes):
    """``lax.ragged_dot``'s SwiGLU: rows of ``x_sorted`` in contiguous
    groups, group e through expert e (``wg``/``wu``/``wd`` hold the local
    experts); rows past the last group are zero. One host sync (the group
    sizes)."""
    out = x_sorted.new_zeros((x_sorted.shape[0], wd.shape[-1]))
    at = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            xe = x_sorted[at:at + n]
            out[at:at + n] = (F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]
        at += n
    return out


def capacity(cfg: ArchConfig, t_loc: int, ep: int) -> int:
    """Slots a destination rank in the all-to-all path (Python ``int``
    truncation, as the reference)."""
    e = cfg.moe
    return max(e.top_k, int(t_loc * e.top_k / ep * e.capacity_factor))


def _dispatch_local(cfg, x_flat, top_i, top_w, ep, e_local, cap):
    """Slot assignment for the fixed-capacity dispatch: returns the send
    buffer ``[ep, cap, D]``, each slot's local expert id ``[ep, cap]``
    (int32) and the plan of the combine: for each pair in destination
    order its ``dest``, ``slot``, source token ``tok``, weight ``w`` (zero
    if dropped), ``ok`` (kept) and ``order`` (its index among the
    token-major pairs)."""
    t_loc, d = x_flat.shape
    k = cfg.moe.top_k
    dev = x_flat.device
    pair_tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    pair_exp = top_i.reshape(-1)
    pair_w = top_w.reshape(-1)
    pair_dest = torch.div(pair_exp, e_local, rounding_mode="floor")
    order = torch.sort(pair_dest, stable=True).indices
    sdest = pair_dest[order]
    counts = torch.bincount(pair_dest, minlength=ep)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sdest.shape[0], device=dev) - starts[sdest]
    ok = rank < cap
    slot_d = torch.where(ok, sdest, 0)
    slot_c = torch.where(ok, rank, 0)
    src_tok = pair_tok[order]
    # kept pairs own distinct slots; dropped ones write to a spare row past
    # the end, then (the reference's last write to slot (0, 0)) zero it
    flat = torch.where(ok, sdest * cap + rank, ep * cap)
    buf = x_flat.new_zeros((ep * cap + 1, d))
    buf[flat] = x_flat[src_tok]
    meta = torch.zeros(ep * cap + 1, dtype=torch.int32, device=dev)
    meta[flat] = (pair_exp[order] % e_local).to(torch.int32)
    buf, meta = buf[:-1].view(ep, cap, d), meta[:-1].view(ep, cap)
    dropped = ~ok.all()
    buf[0, 0] = torch.where(dropped, 0, buf[0, 0])
    meta[0, 0] = torch.where(dropped, 0, meta[0, 0])
    plan = {"dest": slot_d, "slot": slot_c, "tok": src_tok,
            "w": torch.where(ok, pair_w[order], 0), "ok": ok,
            "order": order}
    return buf, meta, plan


def _local_experts(p: dict | list, mesh: Mesh, m: int, e_local: int):
    """Model shard m's ``wg``, ``wu``, ``wd``: sliced from a whole tree
    (the one-process mesh's, or a whole tree on a rank); a rank's sharded
    tree holds only its own experts; a list holds each computed model
    shard's leaves (``transformer``'s blocks), or one whole tree."""
    if isinstance(p, list) and len(p) > 1:
        p = p[mesh.shards("model").index(m)]
        return [p[name] for name in ("wg", "wu", "wd")]
    if isinstance(p, list):
        p = p[0]
    ws = [p[name] for name in ("wg", "wu", "wd")]
    n = ws[0].shape[0]
    if n == e_local * mesh.model:
        return [w[m * e_local:(m + 1) * e_local] for w in ws]
    if mesh.local or n != e_local:
        raise ValueError(f"model rank {m} holds {n} experts, want its "
                         f"{e_local} or all {e_local * mesh.model}")
    return ws


def _router(p: dict | list) -> torch.Tensor:
    """The router (whole on every shard)."""
    return (p[0] if isinstance(p, list) else p)["router"]


def _record(mesh: Mesh, plans: list, t_loc: int) -> None:
    """Each shard's dropped pairs, and the tokens that lost a pair to the
    capacity or to the slot-(0, 0) overwrite, into ``mesh.stats``."""
    dropped, lost = [], []
    for plan in plans:
        gone = ~plan["ok"]
        over = (plan["ok"] & (plan["dest"] == 0) & (plan["slot"] == 0)
                & gone.any())
        hit = torch.zeros(t_loc, dtype=torch.int32, device=gone.device)
        hit.index_add_(0, plan["tok"], (gone | over).to(torch.int32))
        dropped.append(gone.sum())
        lost.append(hit > 0)
    mesh.stats.dropped.append(torch.stack(dropped))
    mesh.stats.lost.append(torch.stack(lost))


def _combine(cfg, y, plan, t_loc):
    """Each token's kept pairs' outputs, weighted and summed in top-k order
    in f32: ``[t_loc, D]``."""
    vals = y[plan["dest"], plan["slot"]].float() \
        * plan["w"].float()[:, None]
    out = torch.empty_like(vals)
    out[plan["order"]] = vals
    return out.view(t_loc, cfg.moe.top_k, -1).sum(1)


def _moe_a2a(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh: Mesh,
             axis: str) -> torch.Tensor:
    """The all-to-all path on one data index's rows x ``[b, S, D]``
    (``repro/models/moe.py:_moe_shard_a2a``, each model shard of this
    process in turn)."""
    b, s, d = x.shape
    ep = mesh.shape[axis]
    if s % ep:
        raise ValueError(f"moe a2a: sequence {s} does not split over "
                         f"{ep} model ranks")
    e_local = cfg.moe.num_experts // ep
    s_loc = s // ep
    t_loc = b * s_loc
    cap = capacity(cfg, t_loc, ep)
    shards = mesh.shards(axis)
    bufs, metas, plans = [], [], []
    for xm, router in zip(mesh.split(x, axis, 1),
                          mesh.replicate(_router(p), axis)):
        xm = xm.reshape(t_loc, d)
        top_i, top_w = _route(cfg, router, xm)
        buf, meta, plan = _dispatch_local(cfg, xm, top_i, top_w, ep,
                                          e_local, cap)
        bufs.append(buf)
        metas.append(meta)
        plans.append(plan)
    if mesh.stats is not None and not is_recomputing():
        _record(mesh, plans, t_loc)
    recvs = mesh.all_to_all(bufs, axis)
    ids = mesh.all_to_all(metas, axis)
    ys = []
    for m, recv, idm in zip(shards, recvs, ids):
        wg, wu, wd = _local_experts(p, mesh, m, e_local)
        idm = idm.reshape(-1).long()
        order = torch.sort(idm, stable=True).indices
        sizes = torch.bincount(idm, minlength=e_local)
        y_sorted = _expert_ffn_ragged(wg, wu, wd, recv.reshape(-1, d)[order],
                                      sizes)
        y = torch.empty_like(y_sorted)
        y[order] = y_sorted
        ys.append(y.view(ep, cap, d))
    backs = mesh.all_to_all(ys, axis)
    outs = [_combine(cfg, y, plan, t_loc).to(x.dtype).view(b, s_loc, d)
            for y, plan in zip(backs, plans)]
    full = mesh.all_gather(outs, axis)                  # [ep, b, s_loc, D]
    return full.permute(1, 0, 2, 3).reshape(b, s, d)


def _moe_repl(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh: Mesh,
              axis: str) -> torch.Tensor:
    """The replicated path on one data index's rows x ``[b, S, D]``
    (``repro/models/moe.py:_moe_shard_repl``): each model shard computes
    only its experts' pairs (the reference also runs the others, binned
    into its last expert, with weight zero), and the f32 partials are
    added in rank order."""
    b, s, d = x.shape
    k = cfg.moe.top_k
    ep = mesh.shape[axis]
    e_local = cfg.moe.num_experts // ep
    x_flat = x.reshape(-1, d)
    t_loc = x_flat.shape[0]
    top_i, top_w = _route(cfg, _router(p), x_flat)
    pair_tok = torch.arange(t_loc, device=x.device).repeat_interleave(k)
    pair_exp = top_i.reshape(-1)
    parts = []
    for m in mesh.shards(axis):
        wg, wu, wd = _local_experts(p, mesh, m, e_local)
        mine = torch.div(pair_exp, e_local, rounding_mode="floor") == m
        # other shards' pairs sort past the last group and are not computed
        local_id = torch.where(mine, pair_exp % e_local, e_local)
        order = torch.sort(local_id, stable=True).indices
        sizes = torch.bincount(local_id, minlength=e_local + 1)[:e_local]
        y_sorted = _expert_ffn_ragged(wg, wu, wd, x_flat[pair_tok[order]],
                                      sizes)
        w = torch.where(mine, top_w.reshape(-1), 0).float()
        vals = torch.empty((t_loc * k, d), dtype=torch.float32,
                           device=x.device)
        vals[order] = y_sorted.float() * w[order][:, None]
        parts.append(vals.view(t_loc, k, d).sum(1))
    gathered = mesh.all_gather(parts, axis)             # [ep, t_loc, D]
    out = gathered[0]
    for part in gathered[1:]:
        out = out + part
    return out.to(x.dtype).view(b, s, d)


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              decode: bool = False) -> torch.Tensor:
    """The reference's entry point. x: [B, S, D], the batch rows of one
    data index (a rank: its own; on the one-process mesh the caller runs
    each data index's rows in turn, as ``launch.steps.make_serve_fns``
    does).

    Reads the ambient mesh (``use_mesh``): without a mesh, with a
    ``model`` axis of 1 or one that does not divide the experts,
    ``moe_ref``; otherwise expert parallelism over ``model``, the
    all-to-all path, or with ``decode`` the replicated path. Nothing
    switches path on an error. The tensor-parallel serve path passes
    ``p`` as a list of each computed model shard's leaves (its experts;
    whole where ``moe_ref`` runs) and x replicated over ``model``.
    """
    mesh = current_mesh()
    axis = "model"
    if mesh is None or mesh.shape[axis] == 1 \
            or cfg.moe.num_experts % mesh.shape[axis] != 0:
        return moe_ref(cfg, p[0] if isinstance(p, list) else p, x)
    fn = _moe_repl if decode else _moe_a2a
    return fn(cfg, p, x, mesh, axis)
