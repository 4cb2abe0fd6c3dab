"""The ``(data, model)`` mesh of the expert-parallel paths (port of the part
of ``repro/distributed/sharding.py`` that they use).

The reference lays its devices on a named mesh and installs it with
``use_mesh`` (a context variable), so that ``moe_apply`` can read the
ambient mesh without threading a handle through the model. The port keeps
that interface, with the reference's rules fixed (``RULES``: ``"experts"
-> "model"``, ``"batch" -> "data"``). A ``Mesh`` here is this process's
place in a ``data x model`` grid of ``torch.distributed`` ranks: rank r
sits at ``(r // model, r % model)`` (the reference's ``make_mesh``
order), and holds the process groups of its two axes.
``launch.mesh.init_mesh`` builds it.

A mesh with no ranks (``local_mesh``) is one process computing the whole
``data x model`` split itself, shard by shard, with the per-shard
arithmetic of the ranks: the same shapes, the same exchanges (a transpose
in place of the all-to-all, a stack in place of the all-gather), the same
order of sums. The ranks equal it bit for bit; it is what the CPU tests
and the card's one-process check run. Its data indices are run in turn by
the caller (``launch.steps.make_serve_fns``), its model shards by
``moe_apply``.

The model's non-MoE layers are not sharded: rank ``(d, m)`` computes them
whole on the batch rows of data index ``d``, replicated over the model
axis (tensor parallelism and FSDP are not ported). Only ``moe_apply``
splits further (``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.exchange import (HostStaging, all_gather,
                                              all_to_all)

AXES = ("data", "model")
# the reference's logical rules, as far as the expert-parallel paths read
# them (``repro/distributed/sharding.py:default_rules``)
RULES = {"batch": "data", "experts": "model"}


@dataclasses.dataclass
class EPStats:
    """What the expert-parallel paths report, where a caller asks (a
    ``Mesh`` built with ``stats=EPStats()``): per all-to-all layer, each
    shard's pairs dropped at capacity (``dropped``, a tensor of ints on the
    device, one entry a shard) and the tokens that lost a pair to the
    capacity, the slot-(0, 0) overwrite included (``lost``, ``[shards,
    t_loc]`` bool); and the seconds spent in the all-to-all exchanges,
    timed by the host clock between two synchronisations of the device."""

    dropped: list = dataclasses.field(default_factory=list)
    lost: list = dataclasses.field(default_factory=list)
    a2a_seconds: float = 0.0
    a2a_calls: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``data x model`` grid.

    ``coords`` is this rank's ``(d, m)``, or None for the one-process mesh
    that computes every shard. ``data_group`` holds the ranks that share
    this rank's model index (one per data index), ``model_group`` those
    that share its data index (one per model index), in axis order.
    Under gloo on a card the exchanges go through ``staging``'s pinned
    host buffers.
    """

    data: int
    model: int
    device: torch.device
    coords: tuple[int, int] | None = None
    backend: str = ""
    data_group: Any = None
    model_group: Any = None
    staging: HostStaging | None = None
    stats: EPStats | None = None

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def local(self) -> bool:
        """One process computing every shard (no ranks)."""
        return self.coords is None

    def shards(self, axis: str) -> list[int]:
        """The indices along ``axis`` that this process computes."""
        if self.local:
            return list(range(self.shape[axis]))
        return [self.coords[AXES.index(axis)]]

    def all_to_all(self, ts: list[torch.Tensor], axis: str
                   ) -> list[torch.Tensor]:
        """The reference's tiled ``all_to_all`` over ``axis``: ``ts`` holds,
        for each shard this process computes, a ``[n, ...]`` tensor whose
        row j goes to shard j; returns what each received, row j from shard
        j."""
        t0 = self._tick()
        if self.local:
            out = [torch.stack([t[j] for t in ts]) for j in range(len(ts))]
        else:
            out = [all_to_all(ts[0], self._group(axis), self.backend,
                              self.staging)]
        self._tock(t0)
        return out

    def all_gather(self, ts: list[torch.Tensor], axis: str
                   ) -> torch.Tensor:
        """``[n, ...]``: the tensor of every shard along ``axis``, in axis
        order (each shard this process computes gives one of ``ts``)."""
        if self.local:
            return torch.stack(ts)
        return all_gather(ts[0], self.shape[axis], self._group(axis),
                          self.backend, self.staging)

    def _group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def _tick(self) -> float | None:
        if self.stats is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _tock(self, t0: float | None) -> None:
        if t0 is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.a2a_seconds += time.perf_counter() - t0
        self.stats.a2a_calls += 1

    def close(self) -> None:
        """Destroy the process group, if there is one."""
        if not self.local:
            dist.destroy_process_group()


def local_mesh(data: int, model: int, device: torch.device | str,
               stats: EPStats | None = None) -> Mesh:
    """One process computing a ``data x model`` split whole, shard by
    shard (the counterpart of ``trivial_grid(J, shards=S)``)."""
    return Mesh(data=int(data), model=int(model), device=torch.device(device),
                stats=stats)


_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Install ``mesh`` for the code run inside."""
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh() -> Mesh | None:
    return _MESH.get()


def axis_size(name: str) -> int:
    """The size of mesh axis ``name`` of the installed mesh (1 without
    one)."""
    mesh = _MESH.get()
    return 1 if mesh is None else mesh.shape[name]
