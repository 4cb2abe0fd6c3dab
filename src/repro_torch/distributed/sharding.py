"""The in-pod ``(data, model)`` mesh, its logical rules and its collectives
(port of ``repro/distributed/sharding.py``).

The reference lays its devices on a named mesh and installs it with
``use_mesh`` (a context variable, with the logical->mesh rules), so that
model code can read the ambient mesh without threading a handle through
the model. The port keeps that interface. A ``Mesh`` here is this
process's place in a ``data x model`` grid of ``torch.distributed``
ranks: rank r sits at ``(r // model, r % model)`` (the reference's
``make_mesh`` order), and holds the process groups of its two axes and
of the whole grid. ``launch.mesh.init_mesh`` builds one for a plain run;
``launch.mesh.init_ranks`` builds one for each pod of a consensus run,
whose in-pod axes these are (the reference's ``("pod", "data",
"model")`` mesh with the ``pod`` axis given to the consensus ranks).

The rules (``default_rules``, and ``models.model.arch_rules`` per arch)
map a parameter's logical axes to mesh axes: ``fsdp -> data``, ``heads``,
``kv_heads``, ``mlp``, ``vocab`` and ``experts -> model``, ``batch ->
data``. ``logical_to_spec`` applies them; a spec is a tuple with, per
dimension, a mesh axis name, a tuple of names, or None. ``fit_spec`` drops
an axis that does not divide its dimension.

A mesh with no ranks (``local_mesh``) is one process computing the whole
``data x model`` split itself, shard by shard, with the per-shard
arithmetic of the ranks: the same shapes, the same exchanges (a transpose
in place of the all-to-all, a stack in place of the all-gather), the same
order of sums. The ranks equal it bit for bit; it is what the CPU tests
and the card's one-process checks run. Its data indices are run in turn by
the caller (``launch.steps``, ``distributed.fsdp``), its model shards by
``moe_apply``.

The collectives the expert-parallel path runs under autograd
(``Mesh.all_to_all``, ``all_gather``, ``split``, ``replicate``) carry
their backward: the reverse all-to-all; this rank's slice of the
gathered gradient; the slices' gradients all-gathered; the copies'
gradients summed in rank order.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.exchange import (HostStaging, all_gather,
                                              all_to_all)

AXES = ("data", "model")


def default_rules(*, kv_divisible: bool = True,
                  heads_divisible: bool = True) -> dict[str, Any]:
    """The reference's logical rules (``default_rules``). The port's mesh
    is one pod's (the consensus ranks are the pods), so ``batch`` maps to
    ``("data",)``, as inside the reference's pod-manual region; no port
    leaf has the ``seq`` axis, whose rule the reference leaves None."""
    return {
        "batch": ("data",),
        "vocab": "model",
        "heads": "model" if heads_divisible else None,
        "kv_heads": "model" if (kv_divisible and heads_divisible) else None,
        "mlp": "model",
        "experts": "model",
        "fsdp": "data",
        "none": None,
    }


COLLECTIVES = ("a2a", "gather", "rs", "sum")


@dataclasses.dataclass
class MeshStats:
    """What the mesh paths report, where a caller asks (a ``Mesh`` built
    with ``stats=MeshStats()``): per all-to-all layer, each shard's pairs
    dropped at capacity (``dropped``, a tensor of ints on the device, one
    entry a shard) and the tokens that lost a pair to the capacity, the
    slot-(0, 0) overwrite included (``lost``, ``[shards, t_loc]`` bool);
    and, keyed by ``COLLECTIVES`` (the all-to-all exchanges, the
    parameter gathers, the gradient reduce-scatters, the model-axis sums
    and gathers of tensor-parallel serving), the seconds spent in
    each kind and its calls, each timed by the host clock between two
    synchronisations of the device. A recomputed layer (the backward's
    checkpoint) records no drops a second time; its exchanges and gathers
    are timed. The synchronisations slow the step: time a step with no
    stats, and read these from another."""

    dropped: list = dataclasses.field(default_factory=list)
    lost: list = dataclasses.field(default_factory=list)
    seconds: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))

    def clear(self) -> None:
        self.dropped.clear()
        self.lost.clear()
        self.seconds.update(dict.fromkeys(COLLECTIVES, 0.0))
        self.calls.update(dict.fromkeys(COLLECTIVES, 0))


_RECOMPUTE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_recompute", default=False)


@contextlib.contextmanager
def recomputing():
    """Mark the code inside as a checkpoint's recomputation (it records no
    ``MeshStats`` drops)."""
    tok = _RECOMPUTE.set(True)
    try:
        yield
    finally:
        _RECOMPUTE.reset(tok)


def is_recomputing() -> bool:
    return _RECOMPUTE.get()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``data x model`` grid.

    ``coords`` is this rank's ``(d, m)``, or None for the one-process mesh
    that computes every shard. ``data_group`` holds the ranks that share
    this rank's model index (one per data index), ``model_group`` those
    that share its data index (one per model index), in axis order, and
    ``group`` the whole grid in rank order (``d * model + m``). Under gloo
    on a card the exchanges go through ``staging``'s pinned host buffers.
    """

    data: int
    model: int
    device: torch.device
    coords: tuple[int, int] | None = None
    backend: str = ""
    data_group: Any = None
    model_group: Any = None
    staging: HostStaging | None = None
    stats: MeshStats | None = None
    group: Any = None

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def local(self) -> bool:
        """One process computing every shard (no ranks)."""
        return self.coords is None

    def shards(self, axis: str) -> list[int]:
        """The indices along ``axis`` that this process computes."""
        if self.local:
            return list(range(self.shape[axis]))
        return [self.coords[AXES.index(axis)]]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[AXES.index(axis)]

    def all_coords(self) -> list[tuple[int, int]]:
        """Every ``(d, m)`` of the grid, in rank order."""
        return [(d, m) for d in range(self.data) for m in range(self.model)]

    # ---------------------------------------------- plain collectives ----
    def _all_to_all(self, ts: list[torch.Tensor], axis: str
                    ) -> list[torch.Tensor]:
        if self.local:
            return [torch.stack([t[j] for t in ts]) for j in range(len(ts))]
        return [self.exchange(ts[0], axis)]

    def _all_gather(self, ts: list[torch.Tensor], axis: str
                    ) -> torch.Tensor:
        if self.local:
            return torch.stack(ts)
        return self.gather_axis(ts[0], axis)

    def gather_axis(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``[n, *t.shape]``: this rank's ``t`` and those of the other
        ranks along ``axis``, in axis order (no autograd)."""
        return all_gather(t, self.shape[axis], self._group(axis),
                          self.backend, self.staging)

    def gather_pod(self, t: torch.Tensor) -> torch.Tensor:
        """``[data * model, *t.shape]``: ``t`` of every rank of the grid,
        in rank order (no autograd)."""
        return all_gather(t, self.size, self.group, self.backend,
                          self.staging)

    def model_sum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over the ``model`` axis of each model shard's partial
        (``parts``: one for each model shard this process computes, in
        axis order; a rank all-gathers the others'), added in rank order
        in float32 and cast back: alike on every model rank (no
        autograd)."""
        if self.model == 1:
            return parts[0]
        t0 = self._tick()
        if not self.local:
            parts = list(self.gather_axis(parts[0], "model").unbind(0))
        out = add_f32(parts).to(parts[0].dtype)
        self._tock(t0, "sum")
        return out

    def model_gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every model shard's tensor, in axis order (``parts`` as in
        ``model_sum``; no autograd)."""
        if self.local or self.model == 1:
            return list(parts)
        t0 = self._tick()
        out = list(self.gather_axis(parts[0], "model").unbind(0))
        self._tock(t0, "sum")
        return out

    def exchange(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The tiled all-to-all of one ``[n, ...]`` tensor over ``axis``
        (no autograd)."""
        return all_to_all(t, self._group(axis), self.backend, self.staging)

    # ------------------------------------- collectives under autograd ----
    def all_to_all(self, ts: list[torch.Tensor], axis: str
                   ) -> list[torch.Tensor]:
        """The reference's tiled ``all_to_all`` over ``axis``: ``ts`` holds,
        for each shard this process computes, a ``[n, ...]`` tensor whose
        row j goes to shard j; returns what each received, row j from shard
        j. Its backward is the same exchange of the gradients."""
        t0 = self._tick()
        if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
            out = list(_AllToAll.apply(self, axis, *ts))
        else:
            out = self._all_to_all(list(ts), axis)
        self._tock(t0, "a2a")
        return out

    def all_gather(self, ts: list[torch.Tensor], axis: str
                   ) -> torch.Tensor:
        """``[n, ...]``: the tensor of every shard along ``axis``, in axis
        order (each shard this process computes gives one of ``ts``). The
        ranks along ``axis`` then compute alike, so the backward keeps this
        shard's slice of the gradient."""
        if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
            return _AllGather.apply(self, axis, *ts)
        return self._all_gather(list(ts), axis)

    def split(self, x: torch.Tensor, axis: str, dim: int
              ) -> list[torch.Tensor]:
        """Each computed shard's slice of ``x`` (alike on every rank along
        ``axis``) along ``dim``; the backward all-gathers the slices'
        gradients, so that every rank along ``axis`` holds the whole
        gradient of ``x``."""
        if x.requires_grad and torch.is_grad_enabled():
            return list(_Split.apply(self, axis, dim, x))
        n = self.shape[axis]
        size = x.shape[dim] // n
        return [x.narrow(dim, i * size, size) for i in self.shards(axis)]

    def replicate(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """``x`` (alike on every rank along ``axis``) once for each computed
        shard; the backward sums the shards' gradients over ``axis`` in rank
        order."""
        if x.requires_grad and torch.is_grad_enabled():
            return list(_Replicate.apply(self, axis, x))
        return [x for _ in self.shards(axis)]

    def _group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def _tick(self) -> float | None:
        if self.stats is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _tock(self, t0: float | None, what: str) -> None:
        if t0 is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.seconds[what] += time.perf_counter() - t0
        self.stats.calls[what] += 1

    def close(self) -> None:
        """Destroy the process group, if there is one."""
        if not self.local:
            dist.destroy_process_group()


def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def add_f32(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of ``parts``, in order."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *ts):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(mesh._all_to_all(list(ts), axis))

    @staticmethod
    def backward(ctx, *gs):
        t0 = ctx.mesh._tick()
        out = ctx.mesh._all_to_all([g.contiguous() for g in gs], ctx.axis)
        ctx.mesh._tock(t0, "a2a")
        return (None, None) + tuple(out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *ts):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._all_gather(list(ts), axis)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh.local:
            return (None, None) + tuple(g.unbind(0))
        return None, None, g[mesh.index(ctx.axis)]


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, x):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = mesh.shape[axis]
        size = x.shape[dim] // n
        return tuple(x.narrow(dim, i * size, size).clone()
                     for i in mesh.shards(axis))

    @staticmethod
    def backward(ctx, *gs):
        mesh, dim = ctx.mesh, ctx.dim
        if mesh.local:
            whole = torch.cat(gs, dim=dim)
        else:
            parts = mesh.gather_axis(gs[0].contiguous(), ctx.axis)
            whole = torch.cat(parts.unbind(0), dim=dim)
        return None, None, None, whole


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.clone() for _ in mesh.shards(axis))

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        if mesh.local:
            parts = list(gs)
        else:
            parts = list(mesh.gather_axis(gs[0].contiguous(),
                                          ctx.axis).unbind(0))
        return None, None, _sum_in_order(parts)


def local_mesh(data: int, model: int, device: torch.device | str,
               stats: MeshStats | None = None) -> Mesh:
    """One process computing a ``data x model`` split whole, shard by
    shard (the counterpart of ``trivial_grid(J, shards=S)``)."""
    return Mesh(data=int(data), model=int(model), device=torch.device(device),
                stats=stats)


_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_RULES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_rules", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: dict | None = None):
    """Install ``mesh`` and its logical rules (``rules``, else
    ``default_rules``) for the code run inside."""
    tok1 = _MESH.set(mesh)
    tok2 = _RULES.set(rules if rules is not None else
                      (default_rules() if mesh is not None else None))
    try:
        yield
    finally:
        _MESH.reset(tok1)
        _RULES.reset(tok2)


def current_mesh() -> Mesh | None:
    return _MESH.get()


def current_rules() -> dict | None:
    return _RULES.get()


def axis_size(name: str) -> int:
    """The size of mesh axis ``name`` of the installed mesh (1 without
    one)."""
    mesh = _MESH.get()
    return 1 if mesh is None else mesh.shape[name]


def logical_to_spec(axes: Sequence[str | None],
                    rules: dict | None = None) -> tuple:
    """Logical axis names -> a spec under ``rules`` (else the installed
    rules; without any, every dimension unsharded)."""
    rules = rules if rules is not None else _RULES.get()
    if rules is None:
        return (None,) * len(axes)
    return tuple(None if ax is None else rules.get(ax) for ax in axes)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(mesh: Mesh, shape: tuple[int, ...], spec: Sequence) -> tuple:
    """Drop sharding on dims the axis size does not divide (e.g. batch=1)."""
    out = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        size = 1
        for a in spec_axes(entry):
            size *= mesh.shape[a]
        out.append(entry if entry is not None and dim % size == 0 else None)
    return tuple(out)
