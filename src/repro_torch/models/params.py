"""Parameter definitions (port of ``repro/models/params.py``).

Models declare their parameters as a nested dict of ``ParamDef`` (shape,
dtype, initializer). ``materialize`` draws them from an explicit
``torch.Generator``; ``from_jax`` takes the reference's parameters as numpy
arrays instead, so that both packages compute from the same weights.
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
                device: torch.device | str) -> dict:
    """Draw every leaf of ``defs`` in tree order from ``gen``."""
    pl = tree_lib.leaves_with_paths(defs, is_leaf=is_def)
    vals = [_init_one(gen, d, device) for _, d in pl]
    return tree_lib.unflatten([p for p, _ in pl], vals)


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
