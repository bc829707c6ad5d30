"""A pure-Python msgpack codec for flax's checkpoint layout.

Checkpoint files are ``flax.serialization.msgpack_serialize`` of a tree of
dicts with numpy leaves. This module writes the same bytes and reads them
back with numpy alone, so the port reads and writes the JAX package's files
on a machine without the ``msgpack`` package.

Wire format (msgpack spec, as msgpack-python's ``packb(..., strict_types=
True)`` writes it): nil, bool, ints in their smallest form (fixints,
int/uint 8-64), Python floats as float64, str, bin for bytes, arrays (lists)
and maps. Maps are written with their keys sorted, as flax's
``jax.tree_util.tree_map`` copy of the tree leaves them. flax's extension
types (``flax.serialization._msgpack_ext_pack``):

  * ext 1, an ndarray: a packed ``(shape, dtype.name, C-order bytes)``;
  * ext 2, a Python complex: a packed ``(real, imag)``;
  * ext 3, a numpy scalar: as ext 1, read back as a 0-d scalar.

Arrays of more than ``MAX_CHUNK_SIZE`` bytes are written as flax's
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
dicts of flat chunks and joined again on reading.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- encoding

def _int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif 0 <= n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif -0x8000 <= n < 0:
        out += b"\xd1" + struct.pack(">h", n)
    elif 0 <= n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif -0x80000000 <= n < 0:
        out += b"\xd2" + struct.pack(">i", n)
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < 0:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes: bytes, out: bytearray) -> None:
    """Length header: a fix form below ``fix_max`` (none for bin), else the
    8/16/32-bit forms of ``codes`` (str and bin have an 8-bit form, array
    and map do not)."""
    if n < fix_max:
        out.append(fix | n)
        return
    forms = ((0xFF, ">B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, forms):
        if n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _header(len(b), 0xA0, 32, b"\xd9\xda\xdb", out)
    out += b


def _bin(b: bytes, out: bytearray) -> None:
    _header(len(b), 0, 0, b"\xc4\xc5\xc6", out)
    out += b


def _ext(code: int, data: bytes, out: bytearray) -> None:
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


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype.name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization "
                         "of ndarrays.")
    out = bytearray()
    out.append(0x93)
    _header(len(arr.shape), 0x90, 16, b"\xdc\xdd", out)
    for d in arr.shape:
        _int(int(d), out)
    _str(arr.dtype.name, out)
    _bin(arr.tobytes("C"), out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    # the order of msgpack-python's strict_types packer: exact types only
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is bytes:
        _bin(obj, out)
    elif t is str:
        _str(obj, out)
    elif t is dict:
        _header(len(obj), 0x80, 16, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        _header(len(obj), 0x90, 16, b"\xdc\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif t is complex:
        inner = bytearray(b"\x92")
        _pack(obj.real, inner)
        _pack(obj.imag, inner)
        _ext(_EXT_COMPLEX, bytes(inner), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _sorted_copy(tree):
    # flax copies the tree with jax.tree_util.tree_map, which sorts dict keys
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_copy(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_sorted_copy(v) for v in tree)
    return tree


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _too_big(v) -> bool:
    return isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE


def _chunk_in_place(tree):
    # flax's _chunk_array_leaves_in_place: dicts only, after the sorted copy
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _too_big(v):
                tree[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_in_place(v)
    elif _too_big(tree):
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts / lists
    with numpy and Python leaves: the same bytes."""
    out = bytearray()
    _pack(_chunk_in_place(_sorted_copy(tree)), out)
    return bytes(out)


# ----------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, data, bin_views: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.bin_views = bin_views  # bin as views into data (array buffers)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        view = self.data[self.pos: self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
        0xDC: ">H", 0xDD: ">I",                  # array
        0xDE: ">H", 0xDF: ">I",                  # map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT or b in (0xC7, 0xC8, 0xC9):
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_LEN[b])
        code = r.unpack(">b")
        return _ext_value(code, r.take(n))
    if b in _LEN:
        n = r.unpack(_LEN[b])
        if b <= 0xC6:
            view = r.take(n)
            return view if r.bin_views else bytes(view)
        if b <= 0xDB:
            return str(r.take(n), "utf-8")
        if b <= 0xDD:
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def _ndarray_from(view: memoryview) -> np.ndarray:
    shape, name, buf = _read(_Reader(view, bin_views=True))
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext_value(code: int, view: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from(view)
    if code == _EXT_NPSCALAR:
        return _ndarray_from(view)[()]
    if code == _EXT_COMPLEX:
        re, im = _read(_Reader(view))
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    flat = np.concatenate([d["chunks"][str(i)] for i in range(len(d["chunks"]))])
    return flat.reshape(shape)


def _unchunk_in_place(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_in_place(v)
    return tree


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts, lists,
    Python values and numpy arrays that ``data`` encodes. Arrays are
    read-only views into ``data``, as flax's are."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk_in_place(tree)
