"""A small msgpack codec for flax's serialized parameter trees.

Covers exactly what ``flax.serialization.to_bytes`` / ``msgpack_restore``
exchange: nil, bools, ints, floats, str, bin, arrays, maps, and flax's
extension types (1 = ndarray as ``(shape, dtype name, C-order bytes)``,
2 = complex, 3 = numpy scalar), plus flax's chunked form of arrays past
1 GiB.  ``packb`` writes the same bytes as ``msgpack.packb(...,
use_bin_type=True)`` for such trees, so bundles written by either package
read in the other.  Written here because the card's machine has no
``msgpack`` package.

bfloat16 leaves decode to float32 (the widening is exact); numpy has no
bfloat16 dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- encoding ---------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif 0 <= n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif 0 <= n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif -0x8000 <= n < 0:
        out += b"\xd1" + struct.pack(">h", n)
    elif -0x80000000 <= n < 0:
        out += b"\xd2" + struct.pack(">i", n)
    elif -0x8000000000000000 <= n < 0:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: bytearray) -> None:
    """Header of a str/bin/array/map: fix form when it fits, else the
    8/16/32-bit length codes (``codes`` lists those that exist)."""
    if fix >= 0 and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I")[-len(codes):],
                                (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(codes):]):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serializable")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, complex):
        _pack_ext(EXT_COMPLEX, packb((obj.real, obj.imag)), out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), -1, -1, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` (a tree of dicts/lists/scalars/numpy arrays)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- decoding ---------------------------------------------------------------


def _dtype_of(name: str) -> np.dtype:
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data, ext=False)
    arr = np.frombuffer(buf, dtype=_dtype_of(name)).reshape(shape)
    if name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


class _Reader:
    def __init__(self, data: bytes, ext: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.ext = ext

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext_value(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if not self.ext:
            raise ValueError("nested msgpack extension")
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        if code == EXT_COMPLEX:
            real, imag = unpackb(data, ext=False)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack extension type {code}")

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext_sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_sized:
            return self.ext_value(self.unpack(ext_sized[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext_value(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes, ext: bool = True) -> Any:
    """Decode one msgpack object; flax's chunked arrays are reassembled."""
    reader = _Reader(data, ext)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(obj) if ext else obj
