"""Wire codecs: how a packed flat buffer becomes the message the exchange
moves (port of the unsharded codecs of ``repro/wire/codec.py``).

  * ``native`` — the packed buffer itself, in the params' common float
                 dtype (bf16 params = 2 B/param).
  * ``int8``   — absmax per (node, leaf), the f32 scales bitcast to an int8
                 tail, so the whole message is one contiguous int8 buffer.
                 The bytes equal the reference's.

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
    block->leaf table, ``scale_width`` wide."""

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

    @property
    def scale_width(self) -> int:
        return self.kernel_dequant_spec().scale_width

    def unpack(self, payload: torch.Tensor, scales=None) -> dict:
        """Decoded (payload, scales) -> dequantized parameter tree (the
        probe path)."""
        return self.layout.unpack(payload, scales=scales)


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
