"""The request's host cores in C++, loaded with ctypes, with a pure-Python
fallback.

Port of ``mmdx_tpu/native/__init__.py`` (``load``, ``resize_u8``): the same
three sources, copied unchanged (``resize_u8.cc``: Pillow's fixed-point
BILINEAR resize, bit-exact; ``wordpiece.cc``: BERT WordPiece;
``unigram.cc``: the T5 unigram Viterbi), the same C interface. What differs
is the build: ``g++ -O3 -std=c++17 -fPIC -Wall -shared`` (the flags of the
JAX package's Makefile) at first use, into ``mmdx_tpu_torch/_build/``
(git-ignored) under a name keyed on a hash of the sources, as ``_build.py``
does for the CUDA library, and never into the package tree.

A library that fails to build or load leaves :func:`load` returning None:
the callers then take their pure-Python paths, whose outputs are identical
(the JAX package's behaviour). :func:`available` and :func:`build_error`
say which, so a caller that needs the cores (the engine's log line,
``chip_smoke.py``) can tell.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / n
                for n in ("wordpiece.cc", "unigram.cc", "resize_u8.cc"))
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lib = None
_error: str | None = None
_lock = threading.Lock()


def source_hash() -> str:
    h = hashlib.sha256()
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmmdx_native_{source_hash()}.so"


def build() -> Path:
    """Compile the three sources into the hash-keyed library; return its
    path. Raises if there is no host compiler or it fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++) for mmdx_tpu_torch/native")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _bind(lib) -> None:
    p, i, i32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, restype, argtypes in (
            ("wp_create", p, [ctypes.c_char_p]),
            ("wp_destroy", None, [p]),
            ("wp_vocab_size", i, [p]),
            ("wp_token_id", i, [p, ctypes.c_char_p]),
            ("wp_encode", i, [p, ctypes.c_char_p, i, i, i, i, i, i32p]),
            ("ug_create", p, [ctypes.c_char_p]),
            ("ug_destroy", None, [p]),
            ("ug_vocab_size", i, [p]),
            ("ug_encode", i, [p, ctypes.c_char_p, i32p, i]),
            ("mmdx_resize_u8", i, [u8p, i, i, i, u8p, i, i])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load():
    """The loaded library (built on first call), or None if it cannot be
    built or loaded (:func:`build_error` says why)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError, AttributeError) as err:
                _error = str(err)
    return _lib


def available() -> bool:
    return load() is not None


def build_error() -> str | None:
    """Why the library is unavailable (None when it loaded)."""
    load()
    return _error


def resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray | None:
    """Pillow's BILINEAR resize of a uint8 [H, W] or [H, W, C <= 4] image,
    bit for bit, through the C++ core; None if the library is unavailable or
    refuses the shape."""
    lib = load()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[:, :, None] if squeeze else img)
    h, w, c = src.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.mmdx_resize_u8(src.ctypes.data_as(u8p), h, w, c, out.ctypes.data_as(u8p),
                            out_h, out_w)
    if rc != 0:
        return None
    resize_u8.calls += 1
    return out[:, :, 0] if squeeze else out


resize_u8.calls = 0  # resizes the C++ core answered
