"""A node's parameters and AdamW moments sharded over its in-pod ``(data,
model)`` ranks: the FSDP, TP and EP of the local step (the port's
counterpart of the reference's ``param_specs`` under ``arch_rules``,
``repro/optim/consensus.py:271-333``, with the gradients always
reduce-scattered, ``grad_rs``, ``repro/launch/steps.py:24-106``).

Rank ``(d, m)`` of a ``distributed.sharding.Mesh`` stores, of every leaf,
the block that its spec (``specs``: the arch rules' spec of the leaf,
fitted to its shape) gives it: the ``d``-th of ``data`` equal parts along
the leaf's ``data`` dimension and the ``m``-th of ``model`` along its
``model`` dimension; a leaf with no such dimension is whole there
(replicated). Its AdamW moments are shards of the same shape. ``cut``
makes a rank's shards of a whole tree, ``join`` puts every rank's shards
back together.

The local step (``loss_and_grads``) on a rank runs the batch rows of data
index ``d``: every layer but the MoE whole on those rows, replicated over
the model axis, the MoE's experts parallel over ``model``
(``models/moe.py``). A layer's leaves are gathered just before its block
(``Gathered``, ``gather_leaf``) and again in the backward (the layer's
checkpoint). ``gather_leaf`` is an autograd function:

  * forward: all-gather the leaf over the axes of its spec, except the
    experts' ``model`` axis, which expert parallelism keeps sharded;
  * backward over ``model``: this rank's slice, with no sum: the model
    ranks computed the same gradient (the MoE's router sums its own over
    the model ranks first);
  * backward over ``data``: the data ranks' gradients of this rank's
    slice summed, as a reduce-scatter. It is written as an all-to-all of
    the gradient's chunks, summed in float32 in data-rank order and cast
    back: the bytes of a reduce-scatter, in a fixed order of sums (NCCL
    does not fix the order of its reduce-scatter). A leaf not sharded on
    ``data`` sums the data ranks' whole gradients the same way.

The loss divides each data index's masked sum by the node's whole token
count (``transformer.loss_fn(count=)``), and the data indices' losses are
added in rank order; the gradient norm adds each rank's sum of squares in
rank order, counting a leaf replicated over an axis on the rank at index 0
of that axis only, so that every element counts once.

The one-process counterpart (``Mesh.local``) holds the whole tree and
computes each data index's rows in turn, with the ranks' shapes (the MoE
runs every model shard, ``moe_apply``); it adds the data indices'
gradients in float32 in rank order, and sums the norm's partials of every
rank's shard in rank order: the ranks equal it bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed.sharding import (Mesh, add_f32, fit_spec,
                                              spec_axes, use_mesh)


# ------------------------------------------------------------- specs ----
def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, torch.Size)


def specs_for(model, mesh: Mesh) -> tuple[dict, dict]:
    """``(specs, gather_specs)`` of ``model``'s parameters on ``mesh``:
    each leaf's spec under ``arch_rules`` fitted to its shape, and the
    axes that a gather brings together (the spec without the experts'
    dimension, which expert parallelism keeps on ``model``)."""
    from repro_torch.models.model import arch_rules
    rules = arch_rules(model.cfg, mesh)
    defs = model.param_defs()
    specs = tree_lib.tree_map(
        lambda s, d: fit_spec(mesh, d.shape, s),
        model.param_specs(rules), defs, is_leaf=_is_spec)
    gather = tree_lib.tree_map(
        lambda s, d: tuple(None if ax == "experts" else e
                           for e, ax in zip(s, d.axes)),
        specs, defs, is_leaf=_is_spec)
    return specs, gather


def _dims(spec) -> list[tuple[int, str]]:
    """``(dim, axis)`` of each sharded dimension of ``spec``."""
    out = []
    for dim, entry in enumerate(spec):
        for ax in spec_axes(entry):
            out.append((dim, ax))
    return out


def shard_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    out = list(shape)
    for dim, ax in _dims(spec):
        out[dim] //= mesh.shape[ax]
    return tuple(out)


def shard_of(x: torch.Tensor, spec, mesh: Mesh,
             coords: tuple[int, int]) -> torch.Tensor:
    """Rank ``coords``' block of the whole leaf ``x`` (a view)."""
    for dim, ax in _dims(spec):
        n = mesh.shape[ax]
        size = x.shape[dim] // n
        x = x.narrow(dim, coords[("data", "model").index(ax)] * size, size)
    return x


def cut(tree: Any, specs: Any, mesh: Mesh,
        coords: tuple[int, int]) -> dict:
    """Rank ``coords``' shards of a whole tree (contiguous copies)."""
    return tree_lib.tree_map(
        lambda x, s: shard_of(x, s, mesh, coords).contiguous(), tree, specs)


def join(parts: dict, specs: Any, mesh: Mesh) -> dict:
    """The whole tree from every rank's shards (``parts[(d, m)]``)."""
    pl = tree_lib.leaves_with_paths(parts[(0, 0)])
    by_rank = {c: tree_lib.leaves(t) for c, t in parts.items()}
    out = []
    for n, ((_, leaf), spec) in enumerate(zip(
            pl, tree_lib.leaves(specs, is_leaf=_is_spec), strict=True)):
        shape = list(leaf.shape)
        for dim, ax in _dims(spec):
            shape[dim] *= mesh.shape[ax]
        whole = leaf.new_empty(shape)
        for c, leaves in by_rank.items():
            shard_of(whole, spec, mesh, c).copy_(leaves[n])
        out.append(whole)
    return tree_lib.unflatten([p for p, _ in pl], out)


def counted(spec, mesh: Mesh, coords: tuple[int, int]) -> bool:
    """Whether rank ``coords`` counts its block of a leaf of ``spec`` in a
    sum over the pod: a leaf replicated over an axis counts on the rank at
    index 0 of that axis only."""
    used = {ax for _, ax in _dims(spec)}
    return all(coords[i] == 0 for i, ax in enumerate(("data", "model"))
               if ax not in used and mesh.shape[ax] > 1)


def shard_bytes(model, mesh: Mesh) -> dict[str, int]:
    """The bytes a rank holds, reckoned from the specs (every rank's
    blocks are of one size): its parameter shards and its two float32
    moments of the same shapes."""
    specs, _ = specs_for(model, mesh)
    from repro_torch.models.params import is_def
    defs = tree_lib.leaves(model.param_defs(), is_leaf=is_def)
    n_param = n_elems = 0
    for d, spec in zip(defs, tree_lib.leaves(specs, is_leaf=_is_spec),
                       strict=True):
        n = 1
        for v in shard_shape(d.shape, spec, mesh):
            n *= v
        n_elems += n
        n_param += n * torch.empty((), dtype=d.dtype).element_size()
    return {"params": n_param, "moments": 2 * 4 * n_elems,
            "total": n_param + 8 * n_elems}


# ------------------------------------------------------------ gather ----
class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        t0 = mesh._tick()
        out = x
        for dim, ax in dims:
            parts = mesh.gather_axis(out.contiguous(), ax)
            out = torch.cat(parts.unbind(0), dim=dim)
        mesh._tock(t0, "gather")
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, dims = ctx.mesh, ctx.dims
        t0 = mesh._tick()
        data_dim = None
        for dim, ax in dims:
            if ax == "model":
                size = g.shape[dim] // mesh.model
                g = g.narrow(dim, mesh.index("model") * size, size)
            else:
                data_dim = dim
        g = reduce_data(g, mesh, data_dim)
        mesh._tock(t0, "rs")
        return g, None, None


def reduce_data(g: torch.Tensor, mesh: Mesh, dim: int | None
                ) -> torch.Tensor:
    """The data ranks' ``g`` summed (float32, data-rank order, cast back):
    along ``dim`` this rank's chunk only (an all-to-all of the chunks),
    or with ``dim`` None the whole (an all-gather)."""
    if mesh.data == 1:
        return g.contiguous()
    if dim is None:
        parts = mesh.gather_axis(g.contiguous(), "data").unbind(0)
    else:
        chunks = g.unflatten(dim, (mesh.data, -1)).movedim(dim, 0)
        parts = mesh.exchange(chunks.contiguous(), "data").unbind(0)
    return add_f32(parts).to(g.dtype)


def gather_leaf(x: torch.Tensor, mesh: Mesh, gspec) -> torch.Tensor:
    """This rank's shard ``x`` gathered over the axes of ``gspec`` (see
    the module docstring for its backward)."""
    dims = _dims(gspec)
    if not dims and mesh.data == 1:
        return x
    return _GatherLeaf.apply(x, mesh, dims)


class Gathered:
    """Reads a rank's shards, each gathered where the model reads it
    (``transformer.loss_fn``'s ``read``)."""

    def __init__(self, mesh: Mesh, gather_specs: dict):
        self.mesh = mesh
        self.gspecs = gather_specs

    def layer(self, params: dict, layer: int) -> dict:
        pl = tree_lib.leaves_with_paths(params["blocks"])
        specs = tree_lib.leaves(self.gspecs["blocks"], is_leaf=_is_spec)
        return tree_lib.unflatten(
            [p for p, _ in pl],
            [gather_leaf(x[layer], self.mesh, s[1:])
             for (_, x), s in zip(pl, specs, strict=True)])

    def leaf(self, params: dict, name: str) -> torch.Tensor:
        return gather_leaf(params[name], self.mesh, self.gspecs[name])


def _gather_dims(x: torch.Tensor, mesh: Mesh, dims) -> torch.Tensor:
    """``x`` all-gathered over each ``(dim, axis)`` of ``dims`` (no
    autograd), timed as a gather."""
    if not dims:
        return x
    t0 = mesh._tick()
    for dim, ax in dims:
        x = torch.cat(mesh.gather_axis(x.contiguous(), ax).unbind(0),
                      dim=dim)
    mesh._tock(t0, "gather")
    return x


@torch.no_grad()
def gather_whole(tree: Any, specs: Any, mesh: Mesh) -> dict:
    """A rank's shards gathered into the whole tree over every axis of
    their specs, the experts' ``model`` axis included (no autograd; the
    one-process mesh's tree is whole already)."""
    if mesh.local:
        return tree
    return tree_lib.tree_map(lambda x, s: _gather_dims(x, mesh, _dims(s)),
                             tree, specs)


class Served:
    """The serve steps' reader on a mesh (``transformer.forward`` and
    ``decode_step``'s ``read``): each leaf as a list with one entry for
    each model shard this process computes, in axis order, the tensor
    parallelism over ``model`` of ``launch.steps.make_serve_fns``.

    On a rank, which holds its shards (``specs``, from ``specs_for``), a
    leaf is all-gathered over ``data`` (its FSDP dimension) where the
    model reads it, and keeps its ``model`` dimension as this rank's
    shard: its heads, d_ff columns, vocab rows or experts. On the
    one-process mesh, which holds the whole tree, entry m is model shard
    m's block, a contiguous copy as a rank's gathered leaf is; a leaf with
    no ``model`` dimension is the whole one, shared by the entries."""

    def __init__(self, mesh: Mesh, specs: dict):
        self.mesh = mesh
        self.specs = specs

    def _parts(self, x: torch.Tensor, spec) -> list[torch.Tensor]:
        mesh = self.mesh
        if not mesh.local:
            return [_gather_dims(x, mesh, [(d, a) for d, a in _dims(spec)
                                           if a == "data" and mesh.data > 1])]
        on_model = tuple(e if "model" in spec_axes(e) else None
                         for e in spec)
        if not any(on_model) or mesh.model == 1:
            return [x] * mesh.model
        return [shard_of(x, on_model, mesh, (0, m)).contiguous()
                for m in mesh.shards("model")]

    def layer(self, params: dict, layer: int) -> list[dict]:
        pl = tree_lib.leaves_with_paths(params["blocks"])
        specs = tree_lib.leaves(self.specs["blocks"], is_leaf=_is_spec)
        cols = [self._parts(x[layer], s[1:])
                for (_, x), s in zip(pl, specs, strict=True)]
        paths = [p for p, _ in pl]
        return [tree_lib.unflatten(paths, [c[i] for c in cols])
                for i in range(len(cols[0]))]

    def leaf(self, params: dict, name: str) -> list[torch.Tensor]:
        return self._parts(params[name], self.specs[name])


def cut_for(model, tree: dict, mesh: Mesh) -> dict:
    """A whole tree (drawn, or ``params.from_jax``) cut into this rank's
    shards by ``model``'s specs under ``arch_rules`` (the one-process mesh
    keeps the whole tree)."""
    if mesh.local:
        return tree
    specs, _ = specs_for(model, mesh)
    return cut(tree, specs, mesh, mesh.coords)


# --------------------------------------------------------- local step ----
def rows(t: torch.Tensor | None, d: int, n: int, dim: int = 0):
    """Data index ``d``'s rows of ``t`` (``n`` indices along ``dim``)."""
    if t is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"batch {t.shape[dim]} does not split over {n} "
                         "data ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, d * size, size)


def loss_and_grads(model, mesh: Mesh, params: dict, batch: dict,
                   gather_specs: dict | None = None
                   ) -> tuple[torch.Tensor, dict]:
    """The node's loss (the masked mean over its whole batch) and its
    gradients: on a rank, of its shards (``params``; ``gather_specs`` from
    ``specs_for``), from its data index's rows of the node's ``batch``;
    on the one-process mesh, of the whole tree, from every data index's
    rows in turn. On a mesh of more than one shard the layers run under
    checkpoints (``remat``), which gather a layer's leaves again in the
    backward; a 1 x 1 mesh has nothing to gather and keeps its
    activations."""
    return _node_pass(model, mesh, params, batch, gather_specs, True)


@torch.no_grad()
def node_loss(model, mesh: Mesh, params: dict, batch: dict) -> torch.Tensor:
    """The node's loss under the mesh at a whole tree, with no gradient
    (the consensus round's probes; on a rank the MoE reads its own experts
    of the tree)."""
    return _node_pass(model, mesh, params, batch, None, False)[0]


def _node_pass(model, mesh, params, batch, gather_specs, grad: bool):
    from repro_torch.models.model import arch_rules
    rules = arch_rules(model.cfg, mesh)
    count = torch.clamp_min((batch["labels"] >= 0).to(torch.float32).sum(),
                            1.0)
    pl = tree_lib.leaves_with_paths(params)
    paths = [p for p, _ in pl]
    read = None if mesh.local or gather_specs is None \
        else Gathered(mesh, gather_specs)
    losses, acc = [], None
    for d in mesh.shards("data"):
        xs = [x.detach().requires_grad_() if grad else x for _, x in pl]
        sub = {k: rows(v, d, mesh.data) for k, v in batch.items()}
        with use_mesh(mesh, rules):
            loss, _ = model.loss(tree_lib.unflatten(paths, xs), sub,
                                 count=count, read=read,
                                 remat=grad and mesh.size > 1)
        losses.append(loss.detach())
        if not grad:
            continue
        # a leaf the loss does not read (the frontend stubs' embed table)
        # gets a zero gradient, as jax.grad gives it
        g = torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)
        del xs, loss
        if mesh.local and mesh.data > 1:
            acc = [x.float() for x in g] if acc is None \
                else [a + x.float() for a, x in zip(acc, g)]
        else:
            acc = list(g)
        del g
    if not mesh.local and mesh.data > 1:
        losses = list(mesh.gather_axis(losses[0], "data").unbind(0))
    loss = losses[0]
    for x in losses[1:]:
        loss = loss + x
    if not grad:
        return loss, None
    if mesh.local and mesh.data > 1:
        acc = [a.to(x.dtype) for a, (_, x) in zip(acc, pl)]
    return loss, tree_lib.unflatten(paths, acc)


def grad_norm(grads: dict, specs: dict, mesh: Mesh) -> torch.Tensor:
    """The global norm of the node's gradient, every element counted once:
    each rank's sum of squares of its counted shards (``counted``), the
    pod's sums added in rank order."""
    leaves = tree_lib.leaves(grads)
    spec_leaves = tree_lib.leaves(specs, is_leaf=_is_spec)
    dev = leaves[0].device

    def partial(coords, take):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for x, s in zip(leaves, spec_leaves, strict=True):
            if counted(s, mesh, coords):
                total = total + take(x, s).float().square().sum()
        return total
    if mesh.local:
        parts = [partial(c, lambda x, s: shard_of(x, s, mesh, c)
                         .contiguous()) for c in mesh.all_coords()]
    else:
        parts = mesh.gather_pod(partial(mesh.coords,
                                        lambda x, s: x)).unbind(0)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return torch.sqrt(total)
