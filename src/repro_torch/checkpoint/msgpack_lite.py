"""A small MessagePack codec for the checkpoint manifest.

The reference writes its manifest with the ``msgpack`` package, which
the port does not depend on. This module encodes and decodes the subset
a manifest uses (maps, arrays, strings, integers, floats, booleans and
nil) byte for byte as ``msgpack.packb``/``unpackb`` do with their
defaults: the smallest integer form, floats as float64, strings as
UTF-8 ``str`` (``str8`` included), tuples as arrays, arrays decoded as
lists. Any other type code (``bin``, ext, float32) raises.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for maps, arrays, str, int, float, bool and
    None."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit
    (when ``codes`` has one), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, ((0xD9, ">B", 1 << 8),
                                       (0xDA, ">H", 1 << 16),
                                       (0xDB, ">I", 1 << 32)), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16),
                                       (0xDD, ">I", 1 << 32)), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16),
                                       (0xDF, ">I", 1 << 32)), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: integer {v} too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: integer {v} too small")


# code -> struct format of the fixed-width scalars
_SCALARS = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# code -> (kind, struct format of the length field)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)``: one object, arrays as lists."""
    obj, pos = _unpack(memoryview(bytes(data)), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return obj


def _read(buf: memoryview, pos: int, fmt: str) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    if pos + size > len(buf):
        raise ValueError("msgpack: truncated data")
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("msgpack: truncated data")
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        return _read(buf, pos, _SCALARS[code])
    if 0xA0 <= code < 0xC0:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code < 0xA0:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n, pos = _read(buf, pos, fmt)
    else:
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x}")
    if kind == "str":
        if pos + n > len(buf):
            raise ValueError("msgpack: truncated data")
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos
