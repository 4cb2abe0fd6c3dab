"""Wire codecs: how a packed flat buffer becomes the message the exchange
moves (port of ``repro/wire/codec.py``).

  * ``native``   — the packed buffer itself, in the params' common float
                   dtype (bf16 params = 2 B/param).
  * ``int8``     — absmax per (node, leaf), the f32 scales bitcast to an
                   int8 tail, so the whole message is one contiguous int8
                   buffer. The bytes equal the reference's.
  * ``fp8_e4m3`` — 1 B/param float8 payload (e4m3fn or e5m2) with per-BLOCK
  * ``fp8_e5m2``   f32 scales on the layout's block grid, bitcast to an int8
                   tail as well. The bytes equal the reference's.

A codec owns ``encode(buf)`` ([J, total] float -> [J, wire_width]),
``decode(wire)`` (message -> (payload, scales | None); any leading dims
before the last), ``wire_bytes()`` and ``kernel_dequant_spec()``.

Sharded (a codec built with a ``flatten.ShardedLayout``): the message of a
node is ``n_shards`` self-contained slab messages, as the reference lays
them out: native, the slab; int8, ``[q(slab), bitcast(the slab's leaf
window of scales)]`` (the payload equals the unsharded one, since the
absmax runs over each whole leaf); fp8, ``[q(slab), bitcast(the slab's
own block scales)]``. ``encode`` gives the whole sharded message;
``encode_slab(buf, s)`` gives slab s's message from whole rows (what an
in-pod rank sends), and ``decode_slab(wire, s)`` the payload and kernel
scales of one slab message (per-leaf rows stay ``[..., num_leaves]`` wide,
indexed by global leaf id; per-block rows are the slab's own blocks).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DequantSpec(NamedTuple):
    """What ``kernels.ops.consensus_round`` needs to dequantize a payload:
    per-(node, leaf) scales (``per_block=False``) resolved through the
    block->leaf table, or per-(node, block) scales (``per_block=True``, the
    fp8 codecs) indexed by the block id; ``scale_width`` wide."""

    per_block: bool
    scale_width: int


class WireCodec:
    """Base codec: a stateless view over a ``FlatLayout`` and, for the
    sharded message, its ``ShardedLayout``."""

    name = "?"

    def __init__(self, layout, slayout=None):
        self.layout = layout
        self.slayout = slayout

    @property
    def wire_dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def _unsharded_width(self) -> int:
        raise NotImplementedError

    @property
    def shard_wire_width(self) -> int:
        """Elements in ONE shard's self-contained message (sharded only)."""
        raise NotImplementedError

    @property
    def wire_width(self) -> int:
        """Elements in one node's whole message."""
        if self.slayout is not None:
            return self.slayout.n_shards * self.shard_wire_width
        return self._unsharded_width

    def wire_row_bytes(self) -> int:
        """Bytes of what one rank sends at one offset: one shard's message
        when sharded, the whole message else."""
        w = self.shard_wire_width if self.slayout is not None \
            else self._unsharded_width
        return w * torch.empty((), dtype=self.wire_dtype).element_size()

    def wire_bytes(self) -> int:
        """Bytes per node moved by ONE graph-offset exchange."""
        n = self.slayout.n_shards if self.slayout is not None else 1
        return n * self.wire_row_bytes()

    def encode(self, buf: torch.Tensor) -> torch.Tensor:
        """[J, total] -> [J, wire_width]; sharded, the slab messages side
        by side."""
        if self.slayout is None:
            return self._encode_whole(buf)
        s = self.slayout
        w = self.shard_wire_width
        wire = torch.empty((buf.shape[0], s.n_shards * w),
                           dtype=self.wire_dtype, device=buf.device)
        for k in range(s.n_shards):
            wire[:, k * w:(k + 1) * w] = self.encode_slab(buf, k)
        return wire

    def encode_slab(self, buf: torch.Tensor, s: int) -> torch.Tensor:
        """Whole rows [rows, total] -> slab s's message [rows,
        shard_wire_width], contiguous (sharded only)."""
        raise NotImplementedError

    def decode(self, wire: torch.Tensor):
        raise NotImplementedError

    def decode_slab(self, wire: torch.Tensor, s: int):
        """Slab s's message [..., shard_wire_width] -> (payload [...,
        shard_total], the kernel's scales or None)."""
        raise NotImplementedError

    def _slab_rows(self, wire: torch.Tensor) -> torch.Tensor:
        """A whole sharded message [..., wire_width] as [..., n_shards,
        shard_wire_width]."""
        return wire.reshape(tuple(wire.shape[:-1])
                            + (self.slayout.n_shards, self.shard_wire_width))

    def kernel_dequant_spec(self) -> DequantSpec:
        return DequantSpec(per_block=False,
                           scale_width=self.layout.num_leaves)

    def unpack(self, payload: torch.Tensor, scales=None) -> dict:
        """Decoded (payload, scales) -> dequantized parameter tree (the
        probe path)."""
        return self.layout.unpack(
            payload, scales=scales,
            scales_per_block=self.kernel_dequant_spec().per_block)


class NativeCodec(WireCodec):
    """Uncompressed wire: the packed buffer in the params' float dtype."""

    name = "native"

    @property
    def wire_dtype(self):
        return self.layout.wire_dtype

    @property
    def _unsharded_width(self) -> int:
        return self.layout.total

    @property
    def shard_wire_width(self) -> int:
        return self.slayout.shard_total

    def encode(self, buf):
        return buf

    def encode_slab(self, buf, s):
        return buf[:, self.slayout.columns(s)].contiguous()

    def decode(self, wire):
        return wire, None

    def decode_slab(self, wire, s):
        return wire, None


class Int8Codec(WireCodec):
    """Absmax int8 per (node, leaf), f32 scales bitcast to an in-band tail.

    ``round`` rounds half to even in both frameworks, and the scale bytes
    are the f32 scales in little-endian order, as the reference's bitcast
    lays them out. Sharded, slab s's tail holds the scales of its leaf
    window (``ShardedLayout.tail_gather``).
    """

    name = "int8"

    @property
    def wire_dtype(self):
        return torch.int8

    @property
    def _unsharded_width(self) -> int:
        return self.layout.total + 4 * self.layout.num_leaves

    @property
    def shard_wire_width(self) -> int:
        return self.slayout.shard_total + 4 * self.slayout.tail_leaves

    def _quantize(self, buf, scales, b0: int, b1: int) -> torch.Tensor:
        """Blocks [b0, b1) of ``buf`` [rows, total] quantized by the
        per-leaf ``scales`` [rows, L]."""
        bs = self.layout.block_size
        sv = torch.repeat_interleave(self.layout.block_scales(scales)
                                     [:, b0:b1], bs, dim=-1)
        return torch.clamp(torch.round(buf[:, b0 * bs:b1 * bs] / sv),
                           -127, 127).to(torch.int8)

    def _encode_whole(self, buf):
        lay = self.layout
        scales = lay.leaf_scales(buf)                      # [J, L]
        q = self._quantize(buf, scales, 0, lay.num_blocks)
        tail = scales.contiguous().view(torch.int8)        # [J, 4L]
        return torch.cat([q, tail], dim=1)

    def encode_slab(self, buf, s):
        sl = self.slayout
        rows = buf.shape[0]
        scales = self.layout.leaf_scales(buf)              # whole leaves
        bps = sl.blocks_per_shard
        q = self._quantize(buf, scales, s * bps, (s + 1) * bps)
        idx = torch.as_tensor(sl.tail_gather[s], dtype=torch.long,
                              device=buf.device)
        tail = scales.contiguous().view(torch.int8).reshape(
            rows, -1, 4)[:, idx].reshape(rows, 4 * sl.tail_leaves)
        return torch.cat([q, tail], dim=1)

    def decode(self, wire):
        """int8 wire [..., wire_width] -> (payload [..., total] int8,
        scales [..., L] f32). A float wire returns ``(wire, None)``."""
        if wire.dtype != torch.int8:
            return wire, None
        lay = self.layout
        lead = tuple(wire.shape[:-1])
        if self.slayout is None:
            payload = wire[..., :lay.total]
            scales = wire[..., lay.total:].contiguous().view(torch.float32)
            return payload, scales
        sl = self.slayout
        rows = self._slab_rows(wire)
        payload = rows[..., :sl.shard_total].reshape(lead + (lay.total,))
        tails = rows[..., sl.shard_total:].reshape(
            lead + (sl.n_shards, sl.tail_leaves, 4))
        shard = torch.as_tensor(sl.leaf_shard, dtype=torch.long,
                                device=wire.device)
        pos = torch.as_tensor(sl.leaf_pos, dtype=torch.long,
                              device=wire.device)
        tail = tails[..., shard, pos, :]                   # [..., L, 4]
        return payload, tail.reshape(lead + (4 * lay.num_leaves,)) \
            .contiguous().view(torch.float32)

    def decode_slab(self, wire, s):
        """Slab s's int8 message -> (payload [..., shard_total] int8, a
        per-leaf scale row [..., L] f32 holding the slab's leaf window at
        its global ids and 1.0 elsewhere)."""
        sl = self.slayout
        st = sl.shard_total
        window = wire[..., st:].contiguous().view(torch.float32)
        scales = torch.ones(tuple(wire.shape[:-1])
                            + (self.layout.num_leaves,),
                            dtype=torch.float32, device=wire.device)
        idx = torch.as_tensor(sl.tail_gather[s], dtype=torch.long,
                              device=wire.device)
        # a shorter window repeats its last leaf: equal bytes, any wins
        scales[..., idx] = window
        return wire[..., :st], scales


class Fp8Codec(WireCodec):
    """float8 payload (1 B/param) with per-block f32 scales on the layout's
    block grid.

    Per block of ``block_size`` elements: ``scale = max(absmax, 1e-12) /
    fp8_max`` (the absmax reduction starts at 0, so a block of padding stays
    decodable), payload = ``buf / scale`` clipped to the format's finite
    range and cast to fp8. The payload bytes and the f32 scales (little
    endian, as the reference's bitcast lays them out) make one contiguous
    int8 message; sharded, each slab carries its own blocks' scales.

    Encoding works through the buffer ``chunk_blocks`` blocks at a time,
    so that its f32 temporaries stay small beside a full-width buffer; every
    block is encoded on its own, so the bytes do not depend on the chunking.
    """

    chunk_blocks = 256

    def __init__(self, layout, slayout=None, *, name: str,
                 qdtype: torch.dtype):
        super().__init__(layout, slayout)
        self.name = name
        self.qdtype = qdtype
        self.fp8_max = float(torch.finfo(qdtype).max)

    @property
    def wire_dtype(self):
        return torch.int8               # container: payload + scale bytes

    @property
    def _unsharded_width(self) -> int:
        return self.layout.total + 4 * self.layout.num_blocks

    @property
    def shard_wire_width(self) -> int:
        return self.slayout.shard_total + 4 * self.slayout.blocks_per_shard

    def block_scales(self, buf: torch.Tensor) -> torch.Tensor:
        """Per-(node, block) absmax scales [J, blocks] (f32) of a [J, n]
        buffer, n a multiple of the block size (``num_blocks`` blocks for
        the whole buffer)."""
        blocks = buf.reshape(buf.shape[0], -1, self.layout.block_size)
        amax = blocks.abs().amax(dim=2).to(torch.float32)
        # a tensor divisor: on a CUDA tensor a Python scalar divisor becomes
        # a multiply by its reciprocal, whose rounding differs
        return torch.clamp_min(amax, 1e-12) / amax.new_tensor(self.fp8_max)

    def _encode_into(self, buf, b0: int, b1: int, dst: torch.Tensor):
        """Blocks [b0, b1) of ``buf`` [J, total] as ``dst`` [J, n + 4 *
        (b1 - b0)] int8: the fp8 payload, then the blocks' scale bytes."""
        j, bs = buf.shape[0], self.layout.block_size
        n = (b1 - b0) * bs
        payload = dst[:, :n].view(self.qdtype)
        scales = torch.empty((j, b1 - b0), dtype=torch.float32,
                             device=buf.device)
        for c0 in range(b0, b1, self.chunk_blocks):
            c1 = min(c0 + self.chunk_blocks, b1)
            src = buf[:, c0 * bs:c1 * bs]
            s = self.block_scales(src)
            scales[:, c0 - b0:c1 - b0] = s
            scaled = src.to(torch.float32).reshape(j, c1 - c0, bs) \
                / s[..., None]
            payload[:, (c0 - b0) * bs:(c1 - b0) * bs] = torch.clamp(
                scaled, -self.fp8_max, self.fp8_max).reshape(
                    j, -1).to(self.qdtype)
        dst[:, n:] = scales.view(torch.int8)

    def _encode_whole(self, buf):
        wire = torch.empty((buf.shape[0], self._unsharded_width),
                           dtype=torch.int8, device=buf.device)
        self._encode_into(buf, 0, self.layout.num_blocks, wire)
        return wire

    def encode_slab(self, buf, s):
        bps = self.slayout.blocks_per_shard
        wire = torch.empty((buf.shape[0], self.shard_wire_width),
                           dtype=torch.int8, device=buf.device)
        self._encode_into(buf, s * bps, (s + 1) * bps, wire)
        return wire

    def decode(self, wire):
        """fp8 wire [..., wire_width] -> (payload [..., total] in the fp8
        dtype, scales [..., num_blocks] f32)."""
        lay = self.layout
        if self.slayout is None:
            payload = wire[..., :lay.total].view(self.qdtype)
            scales = wire[..., lay.total:].contiguous().view(torch.float32)
            return payload, scales
        sl = self.slayout
        lead = tuple(wire.shape[:-1])
        rows = self._slab_rows(wire)
        payload = rows[..., :sl.shard_total].reshape(lead + (lay.total,))
        scales = rows[..., sl.shard_total:].reshape(
            lead + (4 * lay.num_blocks,)).contiguous().view(torch.float32)
        return payload.view(self.qdtype), scales

    def decode_slab(self, wire, s):
        """Slab s's fp8 message -> (payload [..., shard_total] fp8, its
        blocks' scales [..., blocks_per_shard] f32)."""
        st = self.slayout.shard_total
        return (wire[..., :st].view(self.qdtype),
                wire[..., st:].contiguous().view(torch.float32))

    def kernel_dequant_spec(self) -> DequantSpec:
        return DequantSpec(per_block=True,
                           scale_width=self.layout.num_blocks)
