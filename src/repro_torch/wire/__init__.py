"""Wire codecs for the consensus exchange (port of ``repro/wire``).

``get_codec(name, layout, slayout=None)`` builds the codec every producer
and consumer shares (with a ``ShardedLayout``, the sharded message).
``resolve_codec_name`` also accepts the legacy ``compression``
spellings (``"none"``/``""`` -> native).
"""
from __future__ import annotations

from repro_torch.device import torch_dtype
from repro_torch.wire.codec import (DequantSpec, Fp8Codec, Int8Codec,
                                    NativeCodec, WireCodec)

WIRE_CODECS = ("native", "int8", "fp8_e4m3", "fp8_e5m2")

_ALIASES = {"": "native", "none": "native"}

_FP8_DTYPES = {"fp8_e4m3": "float8_e4m3fn", "fp8_e5m2": "float8_e5m2"}


def resolve_codec_name(spec: str) -> str:
    """Codec or legacy-compression name -> canonical codec name."""
    name = _ALIASES.get(spec, spec)
    if name not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {spec!r} "
                         f"(known: {WIRE_CODECS} + legacy 'none')")
    return name


def get_codec(name: str, layout, slayout=None) -> WireCodec:
    """Build the codec for a ``FlatLayout`` and, optionally, its
    ``ShardedLayout`` (a stateless view)."""
    name = resolve_codec_name(name)
    if name == "native":
        return NativeCodec(layout, slayout)
    if name == "int8":
        return Int8Codec(layout, slayout)
    return Fp8Codec(layout, slayout, name=name,
                    qdtype=torch_dtype(_FP8_DTYPES[name]))


__all__ = ["WIRE_CODECS", "DequantSpec", "Fp8Codec", "Int8Codec",
           "NativeCodec", "WireCodec", "get_codec", "resolve_codec_name"]
