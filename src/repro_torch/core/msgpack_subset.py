"""The msgpack subset the Lance footer uses, in plain Python.

:func:`packb` writes the bytes ``msgpack.packb(obj, default=default,
use_bin_type=True)`` writes, for the types a footer holds: maps, lists and
tuples, str, bytes, int, float, bool and None; anything else goes through
``default`` once (the footer maps numpy arrays to ``__nd__`` dicts and numpy
scalars to Python ones).  Each value takes its smallest msgpack form, as the
reference packer chooses it.  :func:`unpackb` reads those forms back (and the
float32 form), with ``object_hook`` applied to every map — the decoding of
``msgpack.unpackb(blob, object_hook=hook, raw=False,
strict_map_key=False)``.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["packb", "unpackb"]


def _pack_int(x: int, out: List[bytes]) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(struct.pack("B", x))
        elif x <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, x))
        elif x <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, x))
        elif x <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, x))
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, x))
        else:
            raise OverflowError(f"int {x} does not fit msgpack")
    elif x >= -32:
        out.append(struct.pack("b", x))
    elif x >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif x >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif x >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif x >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_len(n: int, fix: Optional[Tuple[int, int]], forms, out: List[bytes]) -> None:
    """Header of a sized object: the fix form ``(tag, limit)`` when it fits,
    else the first ``(tag, struct code, limit)`` of ``forms`` that does."""
    if fix is not None and n < fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    for tag, code, limit in forms:
        if n <= limit:
            out.append(struct.pack(">B" + code, tag, n))
            return
    raise ValueError(f"object of size {n} does not fit msgpack")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARR = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))


def _pack(obj: Any, default: Optional[Callable], out: List[bytes],
          defaulted: bool = False) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, _BIN, out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), (0xA0, 32), _STR, out)
        out.append(b)
    elif isinstance(obj, dict):
        _pack_len(len(obj), (0x80, 16), _MAP, out)
        for k, v in obj.items():
            _pack(k, default, out)
            _pack(v, default, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), (0x90, 16), _ARR, out)
        for v in obj:
            _pack(v, default, out)
    elif isinstance(obj, memoryview):
        _pack(obj.tobytes(), default, out)
    elif default is not None and not defaulted:
        _pack(default(obj), default, out, defaulted=True)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """Serialize ``obj`` to msgpack bytes (bin type for bytes)."""
    out: List[bytes] = []
    _pack(obj, default, out)
    return b"".join(out)


# tag -> (length code, type) of bin and str; tag -> struct code of numbers
_SIZED = {0xC4: ("B", bytes), 0xC5: ("H", bytes), 0xC6: ("I", bytes),
          0xD9: ("B", str), 0xDA: ("H", str), 0xDB: ("I", str)}
_SCALARS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}


class _Reader:
    def __init__(self, blob: bytes, object_hook: Optional[Callable]):
        self.b = memoryview(blob)
        self.pos = 0
        self.hook = object_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.b):
            raise ValueError("truncated msgpack data")
        v = self.b[self.pos: self.pos + n]
        self.pos += n
        return v

    def unpack(self, code: str):
        size = struct.calcsize(">" + code)
        return struct.unpack(">" + code, self.take(size))[0]

    def obj(self):
        t = self.unpack("B")
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _SIZED:
            code, kind = _SIZED[t]
            raw = self.take(self.unpack(code))
            return bytes(raw) if kind is bytes else str(raw, "utf-8")
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack("H" if t == 0xDC else "I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack("H" if t == 0xDE else "I"))
        raise ValueError(f"msgpack type 0x{t:02x} is not in the footer subset")

    def map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        return self.hook(d) if self.hook is not None else d


def unpackb(blob: bytes, object_hook: Optional[Callable] = None):
    """Deserialize one msgpack object (the whole of ``blob``)."""
    r = _Reader(bytes(blob), object_hook)
    obj = r.obj()
    if r.pos != len(r.b):
        raise ValueError("extra bytes after the msgpack object")
    return obj
