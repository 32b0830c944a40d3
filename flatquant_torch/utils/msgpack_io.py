"""A minimal MessagePack codec: what flax.serialization writes and reads
for a state dict of arrays (the checkpoint format of utils/checkpoint.py),
with the encoding choices of msgpack-python's packb (use_bin_type=True):
the smallest integer, string, binary, array, map and ext headers, floats
as float64. nil, booleans, integers, floats, str, bytes, lists and
tuples (arrays), dicts (maps) and ExtType round-trip.
"""

from __future__ import annotations

import struct
from typing import NamedTuple


class ExtType(NamedTuple):
    code: int
    data: bytes


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for tag, fmt, lim in ((0xCC, "B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _header(n: int, fix: int, fix_max: int, tags, out: list) -> None:
    """fix | n below fix_max, else the smallest of tags (8/16/32-bit)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for tag, fmt, lim in tags:
        if tag is not None and n < lim:
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise ValueError(f"object of length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(len(b), 0xA0, 32, _STR, out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _header(len(obj), None, 0, _BIN, out)
        out.append(bytes(obj))
    elif isinstance(obj, ExtType):
        n = len(obj.data)
        if n in _FIXEXT:
            out.append(bytes([_FIXEXT[n]]))
        else:
            _header(n, None, 0, _EXT, out)
        out.append(struct.pack("b", obj.code))
        out.append(obj.data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, _ARR, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(b)

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.num("B")
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if t in ints:
            v = self.num(ints[t])
            return float(v) if t in (0xCA, 0xCB) else v
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in lens:
            return self.take(self.num(lens[t])).decode("utf-8")
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in lens:
            return self.take(self.num(lens[t]))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.num(">H" if t == 0xDC
                                                       else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.num(">H" if t == 0xDE else ">I"))
        fixext = {v: k for k, v in _FIXEXT.items()}
        if t in fixext:
            code = self.num("b")
            return ExtType(code, self.take(fixext[t]))
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in lens:
            n = self.num(lens[t])
            code = self.num("b")
            return ExtType(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte {t:#x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
