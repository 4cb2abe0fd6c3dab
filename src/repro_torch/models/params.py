"""Parameter definitions (port of ``repro/models/params.py``).

Models declare their parameters as a nested dict of ``ParamDef`` (shape,
dtype, initializer, and the reference's logical sharding axes,
``repro/models/params.py:24-33``). ``materialize`` draws them from an
explicit ``torch.Generator``; ``from_jax`` takes the reference's parameters
as numpy arrays instead, so that both packages compute from the same
weights. ``spec_tree`` maps the logical axes to mesh axes under the
installed rules (``repro/models/params.py:67-71``); ``distributed.fsdp``
cuts a whole tree into a rank's shards by them.

On a ``data x model`` mesh of ranks (``distributed.sharding.Mesh``) model
rank m holds only experts ``[m E/ep, (m+1) E/ep)`` of each MoE expert
leaf (``wg``, ``wu``, ``wd``; the router stays whole): ``shard_experts``
cuts a whole tree, and ``materialize(..., mesh=)`` draws the whole tree's
numbers leaf by leaf and keeps each expert leaf's slice as it goes, so
that a rank's peak is its own tree plus one whole leaf (at
moonshot-v1-16b-a3b's full width, 12 layers, 2 model ranks: about 4.2 B
parameters, 8.4 GB in bf16, plus one 4.4 GB expert stack).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float | None = None  # None => 1/sqrt(fan-in)
    # one logical axis name (or None) per dimension; None => all None
    logical_axes: tuple[str | None, ...] | None = None

    def __post_init__(self):
        if self.logical_axes is not None:
            assert len(self.shape) == len(self.logical_axes), (
                self.shape, self.logical_axes)

    @property
    def axes(self) -> tuple[str | None, ...]:
        return self.logical_axes or (None,) * len(self.shape)


# a leaf is drawn in flat float32 pieces of at most this many elements (1 GB)
_PIECE = 1 << 28


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _init_one(gen: torch.Generator, d: ParamDef, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    # the reference's rule, quirks included: fan-in is shape[0] for a
    # matrix, shape[-2] for a leaf of rank >= 3 (wq [L,d,h,hd] -> h), and
    # "embed" forces the scale to 1.0 over the declared one
    scale = d.scale
    if scale is None:
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        if len(d.shape) >= 3:
            fan_in = d.shape[-2]
        scale = 1.0 / math.sqrt(fan_in)
    if d.init == "embed":
        scale = 1.0
    # flat pieces, so that a large leaf's float32 draw never sits whole
    # beside it (one expert stack of kimi-k2-1t-a32b's single layer is 22.5
    # GB in float32); randn fills memory in order, so a leaf of one piece
    # is the draw of its whole shape
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _PIECE):
        part = flat[i:i + _PIECE]
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=device)
        part.copy_(x.mul_(scale))
    return out


def materialize(gen: torch.Generator, defs: Any,
                device: torch.device | str, mesh=None, specs=None) -> dict:
    """Draw every leaf of ``defs`` in tree order from ``gen``; on a rank of
    ``mesh``, keep only its experts of each expert leaf, or with ``specs``
    (``distributed.fsdp.specs_for``) its shard of every leaf (the numbers
    of the whole tree's draw, each leaf cut as it is drawn)."""
    pl = tree_lib.leaves_with_paths(defs, is_leaf=is_def)
    if specs is not None and mesh is not None and not mesh.local:
        from repro_torch.distributed.fsdp import shard_of
        spec_of = dict(tree_lib.leaves_with_paths(
            specs, is_leaf=lambda x: isinstance(x, tuple)))
        vals = [shard_of(_init_one(gen, d, device), spec_of[p], mesh,
                         mesh.coords).clone() for p, d in pl]
    else:
        vals = [_expert_slice(p, _init_one(gen, d, device), mesh)
                for p, d in pl]
    return tree_lib.unflatten([p for p, _ in pl], vals)


_EXPERT_LEAVES = ("wg", "wu", "wd")


def _expert_slice(path, leaf: torch.Tensor, mesh) -> torch.Tensor:
    """``leaf``, or on a model rank of ``mesh`` its experts' slice (a copy,
    so that the whole leaf can be freed). The experts axis of ``wg``/
    ``wu``/``wd`` under ``moe`` is third from the end (``[L, E, D, F]``
    stacked). The one-process mesh, a model axis of 1 and one that does
    not divide the experts keep the whole leaf, as ``moe_apply`` then
    reads it."""
    if mesh is None or mesh.local or "moe" not in path \
            or path[-1] not in _EXPERT_LEAVES:
        return leaf
    ep, m = mesh.model, mesh.coords[1]
    axis = leaf.dim() - 3
    n = leaf.shape[axis]
    if ep == 1 or n % ep:
        return leaf
    return leaf.narrow(axis, m * (n // ep), n // ep).clone()


def shard_experts(tree: Any, mesh) -> dict:
    """A whole parameter tree (``materialize``d, or ``from_jax``) ->
    ``mesh``'s rank's tree: each expert leaf cut to the rank's experts, the
    rest shared with ``tree``."""
    pl = tree_lib.leaves_with_paths(tree)
    return tree_lib.unflatten([p for p, _ in pl],
                              [_expert_slice(p, x, mesh) for p, x in pl])


def spec_tree(defs: Any, rules: dict | None = None) -> dict:
    """The tree of specs mirroring ``defs`` under ``rules`` (else the
    installed rules; ``distributed.sharding.logical_to_spec``)."""
    from repro_torch.distributed.sharding import logical_to_spec
    return tree_lib.tree_map(lambda d: logical_to_spec(d.axes, rules), defs,
                             is_leaf=is_def)


def count(defs: Any) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_lib.leaves(
        defs, is_leaf=is_def))


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax(np_tree: Any, device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (numpy arrays, e.g. from
    ``jax.device_get``) -> the port's tree of tensors, bit for bit."""
    return tree_lib.tree_map(lambda a: _tensor_from_numpy(a, device),
                             np_tree, is_leaf=lambda x: not isinstance(
                                 x, dict))
