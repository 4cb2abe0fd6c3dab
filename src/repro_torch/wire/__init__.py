"""Wire codecs for the consensus exchange (port of ``repro/wire``).

``get_codec(name, layout)`` builds the codec every producer and consumer
shares. ``resolve_codec_name`` also accepts the legacy ``compression``
spellings (``"none"``/``""`` -> native). The fp8 codecs come with their
slice.
"""
from __future__ import annotations

from repro_torch.wire.codec import (DequantSpec, Int8Codec, NativeCodec,
                                    WireCodec)

WIRE_CODECS = ("native", "int8")
_NOT_YET_PORTED = ("fp8_e4m3", "fp8_e5m2")

_ALIASES = {"": "native", "none": "native"}


def resolve_codec_name(spec: str) -> str:
    """Codec or legacy-compression name -> canonical codec name."""
    name = _ALIASES.get(spec, spec)
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"wire codec {name!r} is not yet ported")
    if name not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {spec!r} "
                         f"(known: {WIRE_CODECS} + legacy 'none')")
    return name


def get_codec(name: str, layout) -> WireCodec:
    """Build the codec for a ``FlatLayout`` (a stateless view)."""
    name = resolve_codec_name(name)
    if name == "native":
        return NativeCodec(layout)
    return Int8Codec(layout)


__all__ = ["WIRE_CODECS", "DequantSpec", "Int8Codec", "NativeCodec",
           "WireCodec", "get_codec", "resolve_codec_name"]
