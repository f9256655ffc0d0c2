"""The variable blob of an ``.mmdx`` bundle, read and written without flax or
msgpack.

``mmdx_tpu/checkpoints/bundle.py`` stores the variables as
``flax.serialization.to_bytes(variables)``: msgpack of the nested dict, with
each ndarray as ext type 1 holding the msgpack of ``(shape, dtype name, raw
C-order bytes)`` (``flax/serialization.py:_ndarray_to_bytes``), numpy scalars
as ext type 3 in the same form, and arrays over 2**30 bytes split into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` map. This
module reads and writes exactly that subset: maps, strings, ints, floats,
bools, nil, bin, arrays and the two ext types. Writing picks the smallest
encoding of each item, as msgpack does, so a tree read here and written back
gives the same bytes. Arrays are read as views of the input buffer.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
def _head(out: list, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` are the 8-, 16- and 32-bit type bytes; None where the type
    has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 2 ** 8:
        out.append(bytes([codes[0], n]))
    elif n < 2 ** 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 2 ** 8), (0xCD, ">BH", 2 ** 16),
                               (0xCE, ">BI", 2 ** 32), (0xCF, ">BQ", 2 ** 64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2 ** 7), (0xD1, ">Bh", -2 ** 15),
                               (0xD2, ">Bi", -2 ** 31), (0xD3, ">Bq", -2 ** 63)):
            if v >= low:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)


def _ext(out: list, code: int, chunks: list) -> None:
    n = sum(len(c) if isinstance(c, bytes) else c.nbytes for c in chunks)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 2 ** 8:
        out.append(bytes([0xC7, n, code]))
    elif n < 2 ** 16:
        out.append(struct.pack(">BHB", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIB", 0xC9, n, code))
    out.extend(chunks)


def _array_payload(a: np.ndarray) -> list:
    """msgpack of ``(shape, dtype name, bytes)`` as a chunk list (the raw
    bytes kept as one buffer, not copied into a join)."""
    out: list = []
    _pack([list(a.shape), a.dtype.name], out, tail=1)
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    _head(out, raw.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
    out.append(memoryview(raw))
    return out


def _pack(obj, out: list, tail: int = 0) -> None:
    """Append the encoding of ``obj`` to ``out``; ``tail`` > 0 opens an
    array of len(obj) + tail items whose last ``tail`` the caller appends."""
    if tail:
        _head(out, len(obj) + tail, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
        return
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays are not serializable")
        if obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
            return
        _ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _chunk(a: np.ndarray) -> dict:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes."""
    size = max(1, MAX_CHUNK_SIZE // a.dtype.itemsize)
    flat = a.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def dumps(tree) -> bytes:
    """Nested dict of numpy arrays (and Python scalars) -> the bytes of
    ``flax.serialization.msgpack_serialize`` for the same tree."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            n = fixext[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        code = self.unpack(">b")
        return _ext_value(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ext_value(code: int, data: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, dtype, raw = r.read()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no bfloat16)")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(buf) -> dict:
    """The inverse of ``dumps`` (and of ``flax.serialization.to_bytes`` for a
    tree of arrays): the nested dict as written, each array a read-only view
    of ``buf``."""
    r = _Reader(buf)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack tree")
    return _unchunk(tree)
