"""The C++ WordPiece core behind the Python tokenizer's surface.

Port of ``mmdx_tpu/text/native_wordpiece.py`` over the port's own
``text/wordpiece.py`` and ``native/``. ``NativeWordPieceTokenizer`` has the
``encode`` / ``encode_batch`` surface of ``WordPieceTokenizer``: ASCII-only
texts run in the C++ core; anything that needs unicode normalization
(accents, CJK) takes the Python path, so the outputs are always identical.
``native_available`` is False when the library could not be built or
refused the vocab file: then every text takes the Python path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from mmdx_tpu_torch import native
from mmdx_tpu_torch.text.wordpiece import WordPieceTokenizer


def _is_simple_ascii(text: str) -> bool:
    return all(ord(c) < 128 for c in text)


class NativeWordPieceTokenizer:
    def __init__(self, vocab_file: str | Path):
        self.py = WordPieceTokenizer(vocab_file)
        self._lib = native.load()
        self._handle = None
        if self._lib is not None:
            h = self._lib.wp_create(str(vocab_file).encode())
            if h:
                self._handle = ctypes.c_void_p(h)
                assert self._lib.wp_vocab_size(self._handle) == self.py.vocab_size

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def encode(self, text: str, max_len: int = 96) -> list[int]:
        if self._handle is not None and _is_simple_ascii(text):
            out = (ctypes.c_int32 * max_len)()
            self._lib.wp_encode(self._handle, text.encode(), max_len, self.py.cls_id,
                                self.py.sep_id, self.py.pad_id, self.py.unk_id, out)
            return list(out)
        return self.py.encode(text, max_len)

    def encode_batch(self, texts: list[str], max_len: int = 96):
        input_ids = np.asarray([self.encode(t, max_len) for t in texts], np.int32)
        attention_mask = (input_ids != self.py.pad_id).astype(np.int32)
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "token_type_ids": np.zeros_like(input_ids)}

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.wp_destroy(self._handle)
