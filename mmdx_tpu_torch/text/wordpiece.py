"""Native BERT-compatible tokenizer: basic tokenization + WordPiece.

Replaces the reference's hub-downloaded ``AutoTokenizer.from_pretrained
("bert-base-uncased")`` (reference ``backend/ml/pipelines/training_pipeline.py:
323-342``) with an owned implementation driven by a local vocab file — the
algorithm is identical (HF BertTokenizer semantics: text cleanup, CJK spacing,
lowercasing + accent stripping, punctuation splitting, greedy longest-match
WordPiece with ``##`` continuations), so a user who drops in the real
``bert-base-uncased`` vocab.txt gets bit-identical token ids.

``encode_batch`` mirrors ``tokenize_patient_details`` (reference :335-342):
pad/truncate to ``max_len``, return input_ids / attention_mask / token_type_ids.
"""
from __future__ import annotations

import functools
import unicodedata
from pathlib import Path

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT tokenizer over a vocab file (one token per line, line no == id)."""

    def __init__(
        self,
        vocab_file: str | Path | None = None,
        vocab: dict[str, int] | None = None,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        if vocab is None:
            if vocab_file is None:
                raise ValueError("need vocab_file or vocab")
            vocab = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.max_input_chars_per_word = max_input_chars_per_word
        self._wordpiece_cached = functools.lru_cache(maxsize=65536)(self._wordpiece)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---- basic tokenization (HF BasicTokenizer semantics) ----
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> list[str]:
        pieces: list[str] = []
        current: list[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._space_cjk(self._clean(unicodedata.normalize("NFC", text)))
        tokens: list[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return tokens

    # ---- WordPiece (greedy longest-match-first) ----
    def _wordpiece(self, word: str) -> tuple[str, ...]:
        if len(word) > self.max_input_chars_per_word:
            return (self.unk_token,)
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return (self.unk_token,)
            pieces.append(cur)
            start = end
        return tuple(pieces)

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self._wordpiece_cached(word))
        return out

    def encode(self, text: str, max_len: int = 96) -> list[int]:
        """[CLS] tokens [SEP], truncated to max_len (HF truncation keeps
        max_len-2 content tokens), padded with [PAD]."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_len - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        ids += [self.pad_id] * (max_len - len(ids))
        return ids

    def encode_batch(self, texts: list[str], max_len: int = 96) -> dict[str, np.ndarray]:
        """tokenize_patient_details-equivalent: dict of [B, max_len] arrays."""
        input_ids = np.asarray([self.encode(t, max_len) for t in texts], np.int32)
        attention_mask = (input_ids != self.pad_id).astype(np.int32)
        # [PAD] can legitimately be produced only as padding here
        token_type_ids = np.zeros_like(input_ids)
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
        }

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        special = {self.cls_id, self.sep_id, self.pad_id}
        words: list[str] = []
        for i in ids:
            if skip_special and int(i) in special:
                continue
            tok = self.inv_vocab.get(int(i), self.unk_token)
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)
