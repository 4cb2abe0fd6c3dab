"""Flat-buffer packing for the consensus engine (port of the unsharded
``repro/optim/flatten.py:FlatLayout``).

``FlatLayout`` computes a static layout table for a parameter tree — element
offset / true size / padded size / shape / dtype per leaf — and packs the
per-node state into one ``[J, total]`` buffer, so that the neighbor exchange
moves one contiguous buffer per graph offset and the fused kernel runs once
over the whole vector.

Leaf order is the sorted-key recursive order of ``repro_torch.tree`` (the
order ``jax.tree_util.tree_flatten`` gives), so the block->leaf table and
the int8 scale tail match the reference byte for byte.

Layout invariants:

  * every leaf is padded to a multiple of ``block_size`` and starts
    block-aligned, so each kernel block maps to exactly ONE leaf and its
    dequant scale is ``scales[block_leaf[b]]``;
  * padding is zero-filled by ``pack`` and kept zero by the round math, so
    the padded residual reductions equal the masked ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib


def auto_block_size(tree: Any, *, lo: int = 128, hi: int = 65536) -> int:
    """Layout block size for a per-node parameter tree: the power of two
    (clamped to [lo, hi]) that tracks the mean leaf size, so alignment
    wastes little."""
    sizes = [int(np.prod(x.shape, dtype=np.int64)) or 1
             for x in tree_lib.leaves(tree, is_leaf=_has_shape)]
    if not sizes:
        return lo
    mean = sum(sizes) / len(sizes)
    bs = lo
    while bs < hi and bs < mean:
        bs *= 2
    return bs


def _has_shape(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


class LeafSpec(NamedTuple):
    path: tuple[str, ...]       # key path in the parameter tree
    offset: int                 # element offset into the flat axis (aligned)
    size: int                   # true elements per node
    padded: int                 # size rounded up to the block multiple
    shape: tuple[int, ...]      # per-node shape (leading node axis removed)
    dtype: torch.dtype          # original leaf dtype


class FlatLayout:
    """Static layout table mapping a tree to one flat [J, total] buffer."""

    def __init__(self, leaves: tuple[LeafSpec, ...], block_size: int):
        self.leaves = leaves
        self.block_size = int(block_size)
        self.total = (leaves[-1].offset + leaves[-1].padded) if leaves else 0
        if self.total % self.block_size:
            raise ValueError(f"total {self.total} % block {block_size} != 0")
        self.num_blocks = self.total // self.block_size
        self.num_leaves = len(leaves)
        block_leaf = np.zeros((self.num_blocks,), np.int32)
        for li, lf in enumerate(leaves):
            block_leaf[lf.offset // self.block_size:
                       (lf.offset + lf.padded) // self.block_size] = li
        self.block_leaf = block_leaf          # [num_blocks] leaf id per block

    @classmethod
    def for_tree(cls, tree: Any, *, block_size: int = 65536,
                 node_axis: bool = True) -> "FlatLayout":
        """Build the table from any leaves with ``shape`` and ``dtype``
        (tensors or ``ParamDef``s). ``node_axis=True`` treats leaves as
        ``[J, ...]`` stacks and lays out the per-node tail shape."""
        specs: list[LeafSpec] = []
        off = 0
        bs = int(block_size)
        for path, x in tree_lib.leaves_with_paths(tree, is_leaf=_has_shape):
            shape = tuple(x.shape[1:] if node_axis else x.shape)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            padded = -(-size // bs) * bs
            specs.append(LeafSpec(path, off, size, padded, shape, x.dtype))
            off += padded
        return cls(tuple(specs), bs)

    @property
    def wire_dtype(self) -> torch.dtype:
        """The leaves' common float type (bf16 params -> bf16 wire; any f32
        leaf promotes the whole buffer)."""
        dt = torch.float32 if not self.leaves else self.leaves[0].dtype
        for lf in self.leaves[1:]:
            dt = torch.promote_types(dt, lf.dtype)
        return dt

    # ------------------------------------------------------- pack/unpack ----
    def pack(self, tree: Any, dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
        """Tree of [J, ...] leaves -> [J, total] buffer (zero padding)."""
        arrs = tree_lib.leaves(tree)
        if len(arrs) != self.num_leaves:
            raise ValueError(f"tree has {len(arrs)} leaves, layout "
                             f"{self.num_leaves}")
        j = arrs[0].shape[0]
        buf = torch.zeros((j, self.total), dtype=dtype,
                          device=arrs[0].device)
        for lf, x in zip(self.leaves, arrs):
            buf[:, lf.offset:lf.offset + lf.size] = x.reshape(j, lf.size)
        return buf

    def unpack(self, buf: torch.Tensor, *,
               scales: torch.Tensor | None = None,
               scales_per_block: bool = False) -> dict:
        """[J, total] buffer -> tree of [J, ...] leaves in leaf dtype.

        ``scales`` (optional) dequantizes a quantized payload: per-leaf
        ``[J, num_leaves]`` rows by default (leaf li is multiplied by
        ``scales[:, li]``), or, with ``scales_per_block``, per-block
        ``[J, num_blocks]`` rows on the layout's block grid (the fp8
        codecs): each element by its block's scale, one leaf at a time, so
        no full-width scale vector is made. Without scales, a leaf whose
        dtype is the buffer's is a view into ``buf``.
        """
        j = buf.shape[0]
        bs = self.block_size
        out = []
        for li, lf in enumerate(self.leaves):
            if scales is None:
                seg = buf[:, lf.offset:lf.offset + lf.size]
            elif scales_per_block:
                b0 = lf.offset // bs
                b1 = b0 + lf.padded // bs
                seg = (buf[:, lf.offset:lf.offset + lf.padded]
                       .to(torch.float32).reshape(j, b1 - b0, bs)
                       * scales[:, b0:b1, None]).reshape(j, lf.padded)
                seg = seg[:, :lf.size]
            else:
                seg = buf[:, lf.offset:lf.offset + lf.size].to(
                    torch.float32) * scales[:, li:li + 1]
            # cast first: a strided f32 segment is copied once, in the
            # leaf's dtype
            out.append(seg.to(lf.dtype).reshape((j,) + lf.shape))
        return tree_lib.unflatten([lf.path for lf in self.leaves], out)

    # -------------------------------------------------------- wire codec ----
    def leaf_scales(self, buf: torch.Tensor) -> torch.Tensor:
        """Per-node, per-leaf int8 absmax scales [J, num_leaves] (f32)."""
        cols = []
        for lf in self.leaves:
            seg = buf[:, lf.offset:lf.offset + lf.size]
            if lf.size:
                amax = seg.to(torch.float32).abs().amax(dim=1)
            else:                       # empty leaf: reduce over nothing
                amax = torch.zeros(buf.shape[0], dtype=torch.float32,
                                   device=buf.device)
            # a tensor divisor: on a CUDA tensor a Python scalar divisor
            # becomes a multiply by its reciprocal, whose rounding differs
            cols.append(torch.clamp_min(amax, 1e-12)
                        / amax.new_tensor(127.0))
        return torch.stack(cols, dim=1).to(torch.float32)

    def block_scales(self, scales: torch.Tensor) -> torch.Tensor:
        """Per-leaf scales [..., num_leaves] -> per-block [..., num_blocks]
        through the static block->leaf table."""
        idx = torch.as_tensor(self.block_leaf, dtype=torch.long,
                              device=scales.device)
        return scales[..., idx]

    def scale_vector(self, scales: torch.Tensor) -> torch.Tensor:
        """Per-leaf scales [..., num_leaves] -> full width [..., total]."""
        return torch.repeat_interleave(self.block_scales(scales),
                                       self.block_size, dim=-1)
