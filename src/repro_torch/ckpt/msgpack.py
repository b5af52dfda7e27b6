"""A small MessagePack codec for what a checkpoint holds.

Checkpoints are MessagePack maps (ckpt/checkpoint.py): the payload maps each
leaf's path to ``{"dtype": str, "shape": [int, ...], "data": bytes}``, and
the meta map holds the model family tag, a fingerprint and a few numbers.
This module packs and unpacks exactly those types — map, str, bin, int,
float, bool, nil and array — and nothing else (no ext types, no
timestamps), in one code path.

Its bytes equal ``msgpack.packb(obj, use_bin_type=True)`` of the reference
``msgpack`` package for those types: each value takes the smallest encoding
that holds it (fixint, then 8/16/32/64-bit; fixstr/fixmap/fixarray, then
8/16/32-bit lengths), floats are 64-bit, ``str`` is UTF-8 ``str`` and
``bytes`` is ``bin``.  :func:`unpackb` reads what :func:`packb` writes (and
32-bit floats), returning ``str`` for str and ``bytes`` for bin, as
``msgpack.unpackb(data, raw=False)`` does.  A checkpoint written by one
package therefore reads in the other, byte for byte.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    """Serialize ``obj`` (dict, list/tuple, str, bytes, int, float, bool,
    None, nested) to MessagePack bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix_base: int, fix_max: int,
            codes: tuple[int, int, int], what: str) -> None:
    """Length header: the fix form up to ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (8-bit code 0 means the type has none)."""
    c8, c16, c32 = codes
    if n <= fix_max:
        out.append(fix_base | n)
    elif c8 and n <= 0xFF:
        out += struct.pack(">BB", c8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"{what} is too large for MessagePack: {n}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} is out of MessagePack's range")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), "str")
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _header(out, len(b), 0, -1, (0xC4, 0xC5, 0xC6), "bin")
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 0x0F, (0, 0xDC, 0xDD), "array")
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 0x0F, (0, 0xDE, 0xDF), "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} to "
                        f"MessagePack")


# first byte -> (struct format, size) of a fixed-width scalar
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# first byte -> (kind, width of the length field)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}
_WIDTH = {1: ">B", 2: ">H", 4: ">I"}


def unpackb(data: bytes):
    """Deserialize one MessagePack object that spans all of ``data``."""
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"MessagePack data has {len(view) - pos} bytes "
                         f"after its object")
    return obj


def _take(view: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(view):
        raise ValueError("MessagePack data is truncated")
    return view[pos:pos + n]


def _unpack(view: memoryview, pos: int):
    code = _take(view, pos, 1)[0]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack(fmt, _take(view, pos, size))[0], pos + size
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in _SIZED:
        kind, width = _SIZED[code]
        n = struct.unpack(_WIDTH[width], _take(view, pos, width))[0]
        pos += width
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")
    if kind == "bin":
        return bytes(_take(view, pos, n)), pos + n
    if kind == "str":
        return str(_take(view, pos, n), "utf-8"), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(view, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"MessagePack map key {k!r} is not a str or "
                             f"bytes")
        out[k], pos = _unpack(view, pos)
    return out, pos
