"""The variable blob of an ``.mmdx`` bundle, read and written with msgpack
and without flax.

``mmdx_tpu/checkpoints/bundle.py`` stores the variables as
``flax.serialization.to_bytes(variables)``: msgpack of the nested dict, with
each ndarray as ext type 1 holding the msgpack of ``(shape, dtype name, raw
C-order bytes)``, numpy scalars as ext type 3 in the same form, and arrays
over ``MAX_CHUNK_SIZE`` bytes split into a ``{"__msgpack_chunked_array__":
True, "shape": ..., "chunks": ...}`` map. This module is flax's hook for those
ext types and its chunked form (``flax/serialization.py``: ``_msgpack_ext_pack``,
``_chunk``, ``msgpack_restore``) over ``msgpack`` itself, so the bytes are
flax's for the same tree, both ways.
"""
from __future__ import annotations

import io

import msgpack
import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured arrays are not serializable")
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


_BIN_LENGTH_BYTES = {0xC4: 1, 0xC5: 2, 0xC6: 4}  # bin 8, bin 16, bin 32


def _ext_unpack(code: int, data: bytes):
    """One ext payload -> its array, a read-only view of ``data`` (msgpack's
    own copy of the payload): the header ``(shape, dtype name)`` is unpacked
    and the raw bytes after it are not copied again."""
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    head = msgpack.Unpacker(io.BytesIO(data), raw=True, read_size=256)
    if head.read_array_header() != 3:
        raise ValueError("an ndarray payload is (shape, dtype, bytes)")
    shape, dtype = head.unpack(), head.unpack()
    if dtype == b"bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no bfloat16)")
    pos = head.tell()
    width = _BIN_LENGTH_BYTES.get(data[pos]) if pos < len(data) else None
    start = pos + 1 + (width or 0)
    if width is None or start + int.from_bytes(data[pos + 1:start], "big") != len(data):
        raise ValueError("an ndarray payload does not end with its bytes")
    arr = np.frombuffer(data, dtype=np.dtype(dtype.decode()), offset=start).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def _chunked(tree):
    """A copy of the dicts of ``tree`` with each array over MAX_CHUNK_SIZE
    bytes in flax's chunked form (flax chunks only dict values)."""
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    return tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def dumps(tree) -> bytes:
    """Nested dict of numpy arrays (and Python scalars) -> the bytes of
    ``flax.serialization.to_bytes`` for the same tree."""
    return msgpack.packb(_chunked(tree), default=_ext_pack, strict_types=True)


def loads(buf) -> dict:
    """The inverse of ``dumps`` (and of ``flax.serialization.to_bytes`` for a
    tree of arrays): the nested dict as written, each array read-only."""
    try:
        tree = msgpack.unpackb(buf, ext_hook=_ext_unpack, raw=False)
    except msgpack.ExtraData as err:
        raise ValueError("trailing bytes after the msgpack tree") from err
    except ValueError as err:
        raise ValueError(f"truncated or malformed msgpack data: {err}") from err
    return _unchunk(tree)
