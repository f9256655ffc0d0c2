"""The C++ unigram (Viterbi) core behind the Python T5 tokenizer.

Port of ``mmdx_tpu/text/native_unigram.py`` over the port's own
``text/t5_tokenizer.py`` and ``native/``. ``NativeT5Tokenizer`` has the
surface of ``T5StyleTokenizer``: normalization (NFKC, whitespace collapse,
dummy-prefix escaping) stays in Python and the Viterbi dynamic program runs
in C++, with outputs identical to the Python tokenizer. An unscored
(greedy-mode) vocab, or a library that could not be built, takes the Python
path for everything (``native_available`` False).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from mmdx_tpu_torch import native
from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer


class NativeT5Tokenizer(T5StyleTokenizer):
    def __init__(self, vocab_file: str | Path):
        super().__init__(vocab_file=vocab_file)
        self._lib = native.load()
        self._handle = None
        if self._lib is not None and self.algorithm == "unigram":
            h = self._lib.ug_create(str(vocab_file).encode())
            if h:
                self._handle = ctypes.c_void_p(h)
                assert self._lib.ug_vocab_size(self._handle) == self.vocab_size

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def _viterbi(self, s: str) -> list[int]:
        if self._handle is not None:
            data = s.encode("utf-8")
            cap = max(16, 2 * len(s))
            out = (ctypes.c_int32 * cap)()
            count = self._lib.ug_encode(self._handle, data, out, cap)
            if count >= 0:
                return list(out[:count])
        return super()._viterbi(s)

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.ug_destroy(self._handle)
