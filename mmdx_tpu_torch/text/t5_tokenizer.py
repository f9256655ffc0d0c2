"""T5 subword tokenizer: SentencePiece unigram-LM (Viterbi) segmentation.

The reference decodes reports with the hub-downloaded ``T5Tokenizer``
(reference ``backend/ml/pipelines/training_pipeline.py:980``,
``inference_pipeline.py:196``), whose ``spiece.model`` is a SentencePiece
**unigram** model.  With no hub access we own the tokenizer, implementing the
same segmentation algorithm so a real exported vocabulary is a drop-in:

  * ``spm_export_vocab`` TSV format (``piece\\tscore`` per line, log-prob
    scores) loads directly and yields unigram-LM Viterbi segmentation — the
    max-sum-of-scores path over the whole normalized sentence, matching
    SentencePiece's ``unigram_model.cc`` (per-position trie matches; positions
    with no single-char piece get an unk node scored ``min_score - 10.0``,
    SentencePiece's kUnkPenalty).
  * normalization implements SentencePiece's ``nmt_nfkc`` rule set exactly
    (``nmt_nfkc_normalize`` below): NFKC plus the NMT custom rules — extra
    whitespace mappings (TAB/LF/CR/ZWSP/ZWJ/ZWNJ/LRM/RLM/line+para separators/
    U+2581/BOM/replacement char -> space), ASCII/DEL control removal, the
    FULL-WIDTH TILDE protection, and the remove_extra_whitespaces space
    squeeze; then the ``add_dummy_prefix`` convention (leading ``▁``,
    spaces -> ``▁``). T5 is CASED — no lowercasing.
  * a plain piece-per-line vocab (no scores) falls back to greedy
    longest-match (the legacy mode, still cased).

Id conventions match T5 exactly (pad=0 doubles as decoder_start, eos=1 </s>,
unk=2) so generated id sequences from our beam search decode directly.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path

WORD_BOUNDARY = "▁"  # U+2581
UNK_PENALTY = 10.0  # SentencePiece kUnkPenalty (unigram_model.cc)

# SentencePiece nmt_nfkc custom rules (builder.cc BuildNmtNFKCMap) — the
# normalizer baked into T5's spiece.model, which the reference applies via
# T5Tokenizer (reference training_pipeline.py:980, inference_pipeline.py:196).
# Code points additionally considered whitespace:
_NMT_TO_SPACE = frozenset({
    0x0009,  # TAB
    0x000A,  # LINE FEED
    0x000C,  # FORM FEED
    0x000D,  # CARRIAGE RETURN
    0x1680,  # OGHAM SPACE MARK
    0x200B,  # ZERO WIDTH SPACE
    0x200C,  # ZERO WIDTH NON-JOINER
    0x200D,  # ZERO WIDTH JOINER
    0x200E,  # LEFT-TO-RIGHT MARK
    0x200F,  # RIGHT-TO-LEFT MARK
    0x2028,  # LINE SEPARATOR
    0x2029,  # PARAGRAPH SEPARATOR
    0x2581,  # LOWER ONE EIGHTH BLOCK (the escape char itself)
    0xFEFF,  # ZERO WIDTH NO-BREAK SPACE / BOM
    0xFFFD,  # REPLACEMENT CHARACTER
})
# Control characters removed outright (note: 0x008F/0x009F only from the C1
# range — a quirk of the upstream table, reproduced faithfully):
_NMT_REMOVE = frozenset(
    set(range(0x0001, 0x0009)) | {0x000B} | set(range(0x000E, 0x0020))
    | {0x007F, 0x008F, 0x009F}
)
_FULLWIDTH_TILDE = "～"  # protected from NFKC (kept as WAVE DASH stand-in)


def nmt_nfkc_normalize(text: str) -> str:
    """SentencePiece ``nmt_nfkc`` normalization + remove_extra_whitespaces.

    Pipeline (order-equivalent to the upstream single-pass charsmap, whose
    custom keys are single code points disjoint from NFKC's multi-char
    composition keys):
      1. drop NMT control chars, map NMT whitespace variants to U+0020;
      2. NFKC, with U+FF5E protected (upstream erases that NFKC rule so the
         full-width tilde survives as Japan's WAVE DASH replacement);
      3. trim and squeeze runs of U+0020 (remove_extra_whitespaces=true, the
         spiece.model default) — only literal spaces, so e.g. U+0085 NEL,
         which neither NFKC nor the NMT table touches, passes through.
    """
    buf = []
    for ch in text:
        cp = ord(ch)
        if cp in _NMT_REMOVE:
            continue
        buf.append(" " if cp in _NMT_TO_SPACE else ch)
    s = "".join(buf)
    s = _FULLWIDTH_TILDE.join(
        unicodedata.normalize("NFKC", part)
        for part in s.split(_FULLWIDTH_TILDE)
    )
    out = []
    prev_space = True  # True at start -> leading spaces dropped
    for ch in s:
        if ch == " ":
            if prev_space:
                continue
            prev_space = True
        else:
            prev_space = False
        out.append(ch)
    if out and out[-1] == " ":
        out.pop()
    return "".join(out)


class T5StyleTokenizer:
    """SentencePiece-unigram-compatible tokenizer with T5 special-token ids."""

    pad_token = "<pad>"
    eos_token = "</s>"
    unk_token = "<unk>"
    pad_token_id = 0
    eos_token_id = 1
    unk_token_id = 2

    def __init__(self, vocab_file: str | Path | None = None,
                 vocab: dict[str, int] | None = None,
                 scores: dict[int, float] | None = None):
        """``vocab_file`` may be scored TSV (``piece\\tscore``, the
        spm_export_vocab format -> unigram Viterbi) or piece-per-line
        (-> greedy longest-match)."""
        if vocab is None:
            if vocab_file is None:
                raise ValueError("need vocab_file or vocab")
            vocab = {}
            scores = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    line = line.rstrip("\n")
                    if "\t" in line:
                        piece, score = line.split("\t", 1)
                        vocab[piece] = i
                        scores[i] = float(score)
                    else:
                        vocab[line] = i
            if not scores:
                scores = None
        assert vocab.get(self.pad_token) == 0 and vocab.get(self.eos_token) == 1
        self.vocab = vocab
        self.scores = scores
        self.inv_vocab = {i: t for t, i in vocab.items()}
        # control/user-defined symbols (<pad>, </s>, <unk>, <extra_id_*>) are
        # excluded from segmentation matching, like SentencePiece's trie
        self._pieces = {
            t: i for t, i in vocab.items()
            if not (t.startswith("<") and t.endswith(">"))
        }
        self.max_piece_len = max((len(t) for t in self._pieces), default=1)
        if scores:
            self.unk_score = min(scores.values()) - UNK_PENALTY
        self.algorithm = "unigram" if scores else "greedy"

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------------
    @staticmethod
    def normalize(text: str) -> str:
        """Exact SentencePiece ``nmt_nfkc`` + remove_extra_whitespaces."""
        return nmt_nfkc_normalize(text)

    def _viterbi(self, s: str) -> list[int]:
        """Max-score segmentation of the full transformed sentence ``s``
        (already ▁-escaped). Per-position candidates: every vocab piece
        starting there; if no single-char piece exists at a position, an unk
        node (one char, ``min_score - 10``) — SentencePiece PopulateNodes."""
        n = len(s)
        neg = float("-inf")
        best = [neg] * (n + 1)
        best[0] = 0.0
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        pieces, scores = self._pieces, self.scores
        for start in range(n):
            b = best[start]
            if b == neg:
                continue
            has_single = False
            top = min(self.max_piece_len, n - start)
            for length in range(1, top + 1):
                pid = pieces.get(s[start:start + length])
                if pid is None:
                    continue
                if length == 1:
                    has_single = True
                sc = b + scores[pid]
                if sc > best[start + length]:
                    best[start + length] = sc
                    back[start + length] = (start, pid)
            if not has_single:
                sc = b + self.unk_score
                if sc > best[start + 1]:
                    best[start + 1] = sc
                    back[start + 1] = (start, self.unk_token_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]  # type: ignore[misc]
            ids.append(pid)
            pos = start
        ids.reverse()
        return ids

    def _encode_word_greedy(self, word: str) -> list[int]:
        """Greedy longest-match over '▁word' (char-fallback to unk) — legacy
        mode for unscored vocabs."""
        text = WORD_BOUNDARY + word
        ids: list[int] = []
        start = 0
        n = len(text)
        while start < n:
            end = min(n, start + self.max_piece_len)
            piece_id = None
            while end > start:
                pid = self._pieces.get(text[start:end])
                if pid is not None:
                    piece_id = pid
                    break
                end -= 1
            if piece_id is None:
                ids.append(self.unk_token_id)
                start += 1
            else:
                ids.append(piece_id)
                start = end
        return ids

    def tokenize(self, text: str) -> list[str]:
        """Text -> piece strings (HF-style convenience)."""
        return [self.inv_vocab[i] for i in self.encode(text, add_eos=False)]

    def encode(self, text: str, max_length: int | None = None,
               add_eos: bool = True) -> list[int]:
        text = self.normalize(text)
        ids: list[int] = []
        if text:
            if self.algorithm == "unigram":
                # add_dummy_prefix + space escaping, whole-sentence Viterbi
                ids = self._viterbi(
                    WORD_BOUNDARY + text.replace(" ", WORD_BOUNDARY)
                )
            else:
                for word in text.split():
                    ids.extend(self._encode_word_greedy(word))
        if add_eos:
            ids = ids[: (max_length - 1) if max_length else None] + [self.eos_token_id]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def encode_batch(self, texts: list[str], max_length: int = 256):
        """T5 report labels: pad to max_length; mask pads to -100 downstream
        (reference training_pipeline.py:983-991)."""
        import numpy as np

        rows = []
        mask = []
        for t in texts:
            ids = self.encode(t, max_length=max_length)
            m = [1] * len(ids) + [0] * (max_length - len(ids))
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
            rows.append(ids)
            mask.append(m)
        return {
            "input_ids": np.asarray(rows, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
        }

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        pieces: list[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in (self.pad_token_id, self.eos_token_id):
                continue
            pieces.append(self.inv_vocab.get(i, self.unk_token))
        text = "".join(pieces).replace(WORD_BOUNDARY, " ")
        return text.strip()

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]
