"""Flat-buffer packing for the consensus engine (port of
``repro/optim/flatten.py``: ``FlatLayout`` and its sharded view
``ShardedLayout``).

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

Sharding (``FlatLayout.shard`` -> ``ShardedLayout``): the flat axis splits
on block boundaries into ``n_shards`` equal slabs, one per in-pod rank.
Each slab has its own slab of the block->leaf table (global leaf ids, so
per-leaf scale rows index it directly), and the int8 wire carries, per
slab, the f32 scales of the leaves that overlap it (the tail tables).
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
                 node_axis: bool = True, shards: int = 1) -> "FlatLayout":
        """Build the table from any leaves with ``shape`` and ``dtype``
        (tensors or ``ParamDef``s). ``node_axis=True`` treats leaves as
        ``[J, ...]`` stacks and lays out the per-node tail shape.

        ``shards > 1`` also aligns the total to a multiple of ``shards *
        block_size``, the extra zero padding folded into the last leaf's
        padded span, so that ``shard(shards)`` splits the flat axis into
        equal block-aligned slabs. ``shards=1`` gives the unsharded
        layout."""
        specs: list[LeafSpec] = []
        off = 0
        bs = int(block_size)
        for path, x in tree_lib.leaves_with_paths(tree, is_leaf=_has_shape):
            shape = tuple(x.shape[1:] if node_axis else x.shape)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            padded = -(-size // bs) * bs
            specs.append(LeafSpec(path, off, size, padded, shape, x.dtype))
            off += padded
        if shards > 1 and specs:
            align = bs * int(shards)
            total = -(-off // align) * align
            if total != off:
                specs[-1] = specs[-1]._replace(
                    padded=specs[-1].padded + total - off)
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

    # ----------------------------------------------------------- shard ----
    def shard(self, n_shards: int) -> "ShardedLayout":
        """Split the flat axis on block boundaries into ``n_shards`` equal
        slabs. Build the layout with ``for_tree(..., shards=n_shards)`` so
        that the block count divides."""
        return ShardedLayout(self, n_shards)


class ShardSpec(NamedTuple):
    """Static layout table of ONE slab of the flat axis."""

    index: int                  # shard id (the rank's place in its pod)
    start: int                  # element offset of the slab in the flat axis
    size: int                   # elements in the slab (equal for every slab)
    block_leaf: np.ndarray      # [blocks_per_shard] GLOBAL leaf id per block
    leaf_lo: int                # first leaf id overlapping the slab
    leaf_hi: int                # last leaf id overlapping the slab (incl.)


class ShardedLayout:
    """Per-shard view of a ``FlatLayout``: in-pod rank s holds slab
    ``[s * shard_total, (s + 1) * shard_total)`` of its node's row.

    Slab boundaries are block boundaries, so each slab owns whole blocks
    and its slice of the block->leaf table (``block_leaf_shards[s]``,
    global leaf ids) is a layout table of its own.

    Tail tables of the sharded int8 wire: the leaf window of slab s is the
    id range ``[tail_leaf_lo[s], tail_leaf_lo[s] + span_s)`` of the leaves
    whose ``[offset, offset + padded)`` span touches the slab; a zero-size
    leaf anchors to the slab holding its offset (the last slab for one at
    the end), so every leaf lies in some window. ``tail_leaves`` is the
    widest span (every slab's tail has that width); a shorter window pads
    by repeating its last leaf id (``tail_gather``). ``leaf_shard`` and
    ``leaf_pos`` say where a decoder reads each leaf's scale back: the
    first slab whose window holds it, and its slot there.
    """

    def __init__(self, layout: FlatLayout, n_shards: int):
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards {n_shards} < 1")
        if layout.num_blocks % n_shards != 0:
            raise ValueError(
                f"{layout.num_blocks} blocks not divisible by {n_shards} "
                "shards: build the layout with for_tree(..., shards=n)")
        self.layout = layout
        self.n_shards = n_shards
        bps = layout.num_blocks // n_shards
        self.blocks_per_shard = bps
        self.shard_total = bps * layout.block_size
        shards = []
        for s in range(n_shards):
            bl = layout.block_leaf[s * bps:(s + 1) * bps]
            shards.append(ShardSpec(
                index=s, start=s * self.shard_total, size=self.shard_total,
                block_leaf=bl,
                leaf_lo=int(bl[0]) if bl.size else 0,
                leaf_hi=int(bl[-1]) if bl.size else 0))
        self.shards = tuple(shards)
        # [n_shards, blocks_per_shard]: row s is slab s's kernel table
        self.block_leaf_shards = (
            np.stack([s.block_leaf for s in shards])
            if bps else np.zeros((n_shards, bps), np.int32))
        self._build_tail_tables()

    def _build_tail_tables(self):
        lay = self.layout
        n_leaves = lay.num_leaves
        total = self.n_shards * self.shard_total
        los, spans = [], []
        for s in range(self.n_shards):
            start, end = s * self.shard_total, (s + 1) * self.shard_total
            ids = [li for li, lf in enumerate(lay.leaves)
                   if (lf.padded > 0 and lf.offset < end
                       and lf.offset + lf.padded > start)
                   or (lf.padded == 0 and start <= lf.offset
                       and (lf.offset < end or end >= total))]
            los.append(min(ids) if ids else 0)
            spans.append(max(ids) - min(ids) + 1 if ids else 0)
        self.tail_leaf_lo = np.asarray(los, np.int32)       # [n_shards]
        self.tail_leaves = max(spans) if spans else 0       # uniform width
        # [n_shards, tail_leaves]: global leaf id at tail slot k of slab s
        if n_leaves and self.tail_leaves:
            self.tail_gather = np.stack([
                np.minimum(lo + np.arange(self.tail_leaves),
                           min(lo + span, n_leaves) - 1 if span else lo)
                for lo, span in zip(los, spans)]).astype(np.int32)
        else:
            self.tail_gather = np.zeros((self.n_shards, self.tail_leaves),
                                        np.int32)
        leaf_shard = np.zeros(n_leaves, np.int32)
        leaf_pos = np.zeros(n_leaves, np.int32)
        for li in range(n_leaves):
            for s, (lo, span) in enumerate(zip(los, spans)):
                if span and lo <= li < lo + span:
                    leaf_shard[li], leaf_pos[li] = s, li - lo
                    break
            else:
                raise AssertionError(
                    f"leaf {li} missing from every shard tail window")
        self.leaf_shard, self.leaf_pos = leaf_shard, leaf_pos

    def columns(self, s: int) -> slice:
        """Slab s's columns of a ``[rows, total]`` buffer."""
        return slice(s * self.shard_total, (s + 1) * self.shard_total)
