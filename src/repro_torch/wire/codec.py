"""Wire codecs: how a packed flat buffer becomes the message the exchange
moves (port of the unsharded codecs of ``repro/wire/codec.py``).

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
    """Base codec: a stateless view over a ``FlatLayout``."""

    name = "?"

    def __init__(self, layout):
        self.layout = layout

    @property
    def wire_dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def wire_width(self) -> int:
        raise NotImplementedError

    def wire_bytes(self) -> int:
        """Bytes per node moved by ONE graph-offset exchange."""
        return self.wire_width * torch.empty((), dtype=self.wire_dtype
                                             ).element_size()

    def encode(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, wire: torch.Tensor):
        raise NotImplementedError

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
    def wire_width(self) -> int:
        return self.layout.total

    def encode(self, buf):
        return buf

    def decode(self, wire):
        return wire, None


class Int8Codec(WireCodec):
    """Absmax int8 per (node, leaf), f32 scales bitcast to an in-band tail.

    ``round`` rounds half to even in both frameworks, and the scale bytes
    are the f32 scales in little-endian order, as the reference's bitcast
    lays them out.
    """

    name = "int8"

    @property
    def wire_dtype(self):
        return torch.int8

    @property
    def wire_width(self) -> int:
        return self.layout.total + 4 * self.layout.num_leaves

    def encode(self, buf):
        lay = self.layout
        scales = lay.leaf_scales(buf)                      # [J, L]
        q = torch.clamp(torch.round(buf / lay.scale_vector(scales)),
                        -127, 127).to(torch.int8)
        tail = scales.contiguous().view(torch.int8)        # [J, 4L]
        return torch.cat([q, tail], dim=1)

    def decode(self, wire):
        """int8 wire [..., wire_width] -> (payload [..., total] int8,
        scales [..., L] f32). A float wire returns ``(wire, None)``."""
        if wire.dtype != torch.int8:
            return wire, None
        total = self.layout.total
        payload = wire[..., :total]
        scales = wire[..., total:].contiguous().view(torch.float32)
        return payload, scales


class Fp8Codec(WireCodec):
    """float8 payload (1 B/param) with per-block f32 scales on the layout's
    block grid.

    Per block of ``block_size`` elements: ``scale = max(absmax, 1e-12) /
    fp8_max`` (the absmax reduction starts at 0, so a block of padding stays
    decodable), payload = ``buf / scale`` clipped to the format's finite
    range and cast to fp8. The payload bytes and the f32 scales (little
    endian, as the reference's bitcast lays them out) make one contiguous
    int8 message.

    ``encode`` works through the buffer ``chunk_blocks`` blocks at a time,
    so that its f32 temporaries stay small beside a full-width buffer; every
    block is encoded on its own, so the bytes do not depend on the chunking.
    """

    chunk_blocks = 256

    def __init__(self, layout, *, name: str, qdtype: torch.dtype):
        super().__init__(layout)
        self.name = name
        self.qdtype = qdtype
        self.fp8_max = float(torch.finfo(qdtype).max)

    @property
    def wire_dtype(self):
        return torch.int8               # container: payload + scale bytes

    @property
    def wire_width(self) -> int:
        return self.layout.total + 4 * self.layout.num_blocks

    def block_scales(self, buf: torch.Tensor) -> torch.Tensor:
        """Per-(node, block) absmax scales [J, blocks] (f32) of a [J, n]
        buffer, n a multiple of the block size (``num_blocks`` blocks for
        the whole buffer)."""
        blocks = buf.reshape(buf.shape[0], -1, self.layout.block_size)
        amax = blocks.abs().amax(dim=2).to(torch.float32)
        # a tensor divisor: on a CUDA tensor a Python scalar divisor becomes
        # a multiply by its reciprocal, whose rounding differs
        return torch.clamp_min(amax, 1e-12) / amax.new_tensor(self.fp8_max)

    def encode(self, buf):
        lay = self.layout
        j, bs = buf.shape[0], lay.block_size
        wire = torch.empty((j, self.wire_width), dtype=torch.int8,
                           device=buf.device)
        payload = wire[:, :lay.total].view(self.qdtype)
        scales = torch.empty((j, lay.num_blocks), dtype=torch.float32,
                             device=buf.device)
        for b0 in range(0, lay.num_blocks, self.chunk_blocks):
            b1 = min(b0 + self.chunk_blocks, lay.num_blocks)
            cols = slice(b0 * bs, b1 * bs)
            s = self.block_scales(buf[:, cols])
            scales[:, b0:b1] = s
            scaled = buf[:, cols].to(torch.float32).reshape(j, b1 - b0, bs) \
                / s[..., None]
            payload[:, cols] = torch.clamp(
                scaled, -self.fp8_max, self.fp8_max).reshape(
                    j, -1).to(self.qdtype)
        wire[:, lay.total:] = scales.view(torch.int8)
        return wire

    def decode(self, wire):
        """fp8 wire [..., wire_width] -> (payload [..., total] in the fp8
        dtype, scales [..., num_blocks] f32)."""
        total = self.layout.total
        payload = wire[..., :total].view(self.qdtype)
        scales = wire[..., total:].contiguous().view(torch.float32)
        return payload, scales

    def kernel_dequant_spec(self) -> DequantSpec:
        return DequantSpec(per_block=True,
                           scale_width=self.layout.num_blocks)
