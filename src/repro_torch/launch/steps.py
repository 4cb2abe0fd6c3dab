"""Train and serve step builders over a ``(data, model)`` mesh (port of
``repro/launch/steps.py``).

``make_train_fns`` returns the reference's ``(init_fn, step_fn,
abstract_state, state_shardings)``: plain AdamW training with no
consensus, the parameters and moments of rank ``(d, m)`` its shards under
the arch rules (``distributed.fsdp``), its local step on the rows of data
index ``d`` of the global batch, the gradients reduce-scattered onto the
shards (what the reference's ``grad_rs=True`` asks for: the port has no
other way, and takes no such switch), the clip reading the pod's global
norm. On the one-process mesh the state is the whole tree and
the step computes every data index in turn; the ranks equal it bit for
bit. As in the reference, it needs a mesh (``local_mesh(1, 1, device)``
is one device's plain step, the MoE on ``moe_ref``).

``make_serve_fns`` returns the reference's pair ``(prefill_fn,
decode_fn)``, each run under ``use_mesh`` and the arch rules. Both take
the global batch, as the reference's do, and return the global logits.
On a mesh, serving is tensor parallel over ``model`` as the reference's
rules split it (``models/transformer.py``): rank ``(d, m)`` holds its
shards of the parameters (``fsdp.specs_for``: FSDP on ``data``; heads,
kv heads, d_ff, vocab and experts on ``model``; ``fsdp.cut_for`` cuts a
whole tree, ``Model.init(mesh=, specs=)`` draws them) and its shard of
the decode state (``decode_state_specs``,
``Model.init_decode_state(mesh=)``). It computes the batch rows of data
index ``d`` (the reference's ``batch -> data`` rule), gathers each
layer's leaves over ``data`` only (``fsdp.Served``), computes its heads,
d_ff columns and vocab columns, adds the partials over ``model`` in rank
order in float32 (``Mesh.model_sum``), and all-gathers the logits over
``model`` and then ``data``. The MoE's experts stay expert parallel on
the same axis. The one-process mesh (``local_mesh``) takes the whole tree
and the whole state, and computes each ``(data, model)`` shard in turn at
the ranks' shapes: the ranks equal it bit for bit. hymba is refused at
``model > 1`` (``transformer.check_servable``). Without a mesh the steps
read whole parameters on one device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import Mesh, use_mesh
from repro_torch.models.model import Model, arch_rules
# decode_state_specs and decode_shard_shapes live here too, where the
# reference keeps its decode_state_specs
from repro_torch.models.transformer import (  # noqa: F401
    DecodeState, check_servable, decode_shard_shapes, decode_state_specs)
from repro_torch.optim import adamw as adamw_lib


class PlainTrainState(NamedTuple):
    params: Any                 # this rank's shards (the whole tree in
    #                             one process)
    opt: adamw_lib.AdamWState   # f32 moments shaped as params
    step: torch.Tensor          # [] int32


class LeafSharding(NamedTuple):
    """One leaf's spec (a mesh axis, or None, per dimension) and the shape
    of a rank's shard."""
    spec: tuple
    shard_shape: tuple[int, ...]


def make_train_fns(model: Model, mesh: Mesh, acfg: adamw_lib.AdamWConfig):
    """Returns ``(init_fn, step_fn, abstract_state, state_shardings)``.

    ``init_fn(gen, device)``: the state drawn from ``gen`` (a rank's
    shards, or the whole tree). ``step_fn(state, batch)``: one AdamW step
    on the global ``batch`` (``tokens`` or ``embeds``, ``labels``); the
    state is updated in place and returned with ``{"loss", "grad_norm",
    "lr"}``. ``abstract_state()``: the whole state's shapes and dtypes
    (tensors on the ``meta`` device). ``state_shardings()``: for every
    leaf of the state, a ``LeafSharding`` (the step and the moments' step
    replicated).
    """
    specs, gspecs = fsdp.specs_for(model, mesh)

    def init_fn(gen: torch.Generator, device=None) -> PlainTrainState:
        device = mesh.device if device is None else device
        params = model.init(gen, device, mesh=mesh, specs=specs)
        opt = adamw_lib.init(acfg, params)
        return PlainTrainState(params=params, opt=opt,
                               step=torch.zeros((), dtype=torch.int32,
                                                device=opt.step.device))

    def step_fn(state: PlainTrainState, batch: dict):
        loss, grads = fsdp.loss_and_grads(model, mesh, state.params, batch,
                                          gspecs)
        _, opt, m = adamw_lib.update(acfg, state.opt, state.params, grads,
                                     mesh=mesh, specs=specs)
        del grads
        new = PlainTrainState(params=state.params, opt=opt,
                              step=state.step + 1)
        return new, {"loss": loss, **m}

    def abstract_state() -> PlainTrainState:
        from repro_torch.models.params import is_def
        ap = tree_lib.tree_map(
            lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"),
            model.param_defs(), is_leaf=is_def)
        f32 = lambda x: torch.empty(x.shape, dtype=torch.float32,
                                    device="meta")
        step = torch.empty((), dtype=torch.int32, device="meta")
        return PlainTrainState(
            params=ap, opt=adamw_lib.AdamWState(
                step=step, m=tree_lib.tree_map(f32, ap),
                v=tree_lib.tree_map(f32, ap)), step=step)

    def state_shardings() -> PlainTrainState:
        from repro_torch.models.params import is_def
        rep = LeafSharding((), ())
        sh = tree_lib.tree_map(
            lambda d, s: LeafSharding(s, fsdp.shard_shape(d.shape, s, mesh)),
            model.param_defs(), specs, is_leaf=is_def)
        return PlainTrainState(params=sh, opt=adamw_lib.AdamWState(
            step=rep, m=sh, v=sh), step=rep)

    return init_fn, step_fn, abstract_state, state_shardings


def _data_shards(mesh: Mesh | None) -> list[tuple[int, int]]:
    """``(d, data)`` for each data index this process computes: on the
    one-process mesh every index, in turn; on a rank its own."""
    if mesh is None:
        return [(0, 1)]
    return [(d, mesh.data) for d in mesh.shards("data")]




def _join(mesh: Mesh | None, outs: list[torch.Tensor]) -> torch.Tensor:
    """The global batch's logits from each data index's: concatenated on
    the one-process mesh, all-gathered over the data axis on a rank."""
    if mesh is None or mesh.local:
        return outs[0] if len(outs) == 1 else torch.cat(outs)
    if mesh.data == 1:
        return outs[0]
    out = mesh.all_gather(outs, "data")
    return out.reshape((-1,) + tuple(out.shape[2:]))


def make_serve_fns(model: Model, mesh: Mesh | None, cell: ShapeCell):
    """Returns ``(prefill_fn, decode_fn)`` closed over ``mesh``.

    ``prefill_fn(params, batch, use_kernel=False)``: the logits ``[B, S,
    V]`` of the global ``batch`` (``tokens`` [B, S] or ``embeds``);
    ``use_kernel`` goes through to ``Model.prefill`` (on a mesh, the
    kernel runs on each model shard's heads).
    ``decode_fn(params, state, inputs)``: one step of ``inputs["token"]``
    [B] (or ``inputs["embed_in"]`` [B, D]) at ``max_len = cell.seq_len``;
    returns (logits [B, V], the next state). On a rank ``params`` and
    ``state`` are its shards (see the module docstring); on the
    one-process mesh, and without a mesh, the whole tree and state.
    """
    cfg = model.cfg
    if mesh is None:
        read, rules = None, None
    else:
        check_servable(cfg, mesh)
        read = fsdp.Served(mesh, fsdp.specs_for(model, mesh)[0])
        rules = arch_rules(cfg, mesh)

    def prefill_fn(params, batch, use_kernel: bool = False):
        outs = []
        for d, n in _data_shards(mesh):
            sub = {k: fsdp.rows(v, d, n) for k, v in batch.items()}
            with use_mesh(mesh, rules):
                outs.append(model.prefill(params, sub, use_kernel=use_kernel,
                                          read=read))
        return _join(mesh, outs)

    def decode_fn(params, state: DecodeState, inputs):
        local = mesh is not None and mesh.local and mesh.data > 1
        outs = []
        for d, n in _data_shards(mesh):
            sub = state
            if local:           # this index's rows: leaves [L, B, ...]
                sub = state._replace(cache={
                    name: type(entry)(*(fsdp.rows(t, d, n, 1) if t.dim() > 1
                                        else t for t in entry))
                    for name, entry in state.cache.items()})
            with use_mesh(mesh, rules):
                logits, _ = model.decode_step(
                    params, sub, fsdp.rows(inputs.get("token"), d, n),
                    max_len=cell.seq_len,
                    embed_in=fsdp.rows(inputs.get("embed_in"), d, n),
                    read=read)
            outs.append(logits)
        return _join(mesh, outs), state._replace(pos=state.pos + 1)

    return prefill_fn, decode_fn
