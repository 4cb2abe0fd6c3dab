"""A small MessagePack writer and reader for the checkpoint manifest.

The manifest holds maps, strings, integers, floats, booleans, nil and
arrays. ``packb`` writes them in the bytes that ``msgpack.packb`` gives
with its defaults: the smallest integer form (positive ints as fixint or
uint 8/16/32/64, negative ones as negative fixint or int 8/16/32/64),
floats as float 64, strings as fixstr or str 8/16/32, arrays (lists and
tuples) and maps (in insertion order) in their fix, 16- and 32-bit forms.
``unpackb`` reads those forms back as ``msgpack.unpackb`` does with its
defaults: strings decoded as UTF-8, arrays as lists.
"""
from __future__ import annotations

import struct
from typing import Any


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        else:
            _head(out, n, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        else:
            _head(out, len(obj), (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        if len(obj) < 16:
            out.append(0x80 | len(obj))
        else:
            _head(out, len(obj), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _head(out: bytearray, n: int, codes) -> None:
    """A length header: the 8-, 16- or 32-bit form of ``codes`` (None
    where the type has no such form)."""
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit MessagePack")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit 64 bits")


_FIXED = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def unpackb(data: bytes) -> Any:
    """The object MessagePack ``data`` holds (one object, nothing after)."""
    obj, at = _unpack(memoryview(data), 0)
    if at != len(data):
        raise ValueError(f"{len(data) - at} bytes after the object")
    return obj


def _unpack(buf: memoryview, at: int) -> tuple[Any, int]:
    code = buf[at]
    at += 1
    if code < 0x80:
        return code, at
    if code >= 0xE0:
        return code - 0x100, at
    if 0xA0 <= code < 0xC0:
        return _str(buf, at, code & 0x1F)
    if 0x90 <= code < 0xA0:
        return _array(buf, at, code & 0x0F)
    if 0x80 <= code < 0x90:
        return _map(buf, at, code & 0x0F)
    if code == 0xC0:
        return None, at
    if code in (0xC2, 0xC3):
        return code == 0xC3, at
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, at)[0], at + size
    lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
               0xDE: ">H", 0xDF: ">I"}
    if code not in lengths:
        raise ValueError(f"MessagePack code {code:#x} is not read here")
    fmt = lengths[code]
    n = struct.unpack_from(fmt, buf, at)[0]
    at += struct.calcsize(fmt)
    if code in (0xD9, 0xDA, 0xDB):
        return _str(buf, at, n)
    if code in (0xDC, 0xDD):
        return _array(buf, at, n)
    return _map(buf, at, n)


def _str(buf, at, n):
    return bytes(buf[at:at + n]).decode("utf-8"), at + n


def _array(buf, at, n):
    out = []
    for _ in range(n):
        x, at = _unpack(buf, at)
        out.append(x)
    return out, at


def _map(buf, at, n):
    out = {}
    for _ in range(n):
        k, at = _unpack(buf, at)
        v, at = _unpack(buf, at)
        out[k] = v
    return out, at
