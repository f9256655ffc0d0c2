"""Vocab builders for the native tokenizers (offline — no hub downloads).

Copy of ``mmdx_tpu/text/vocab_builder.py`` over the port's tokenizer and
``pipelines/data_prep``.

Builds WordPiece (BERT-style) and T5-style piece inventories from a text
corpus.  The default corpus is synthesized from the framework's medical domain
tables (mirroring what the reference's patient-details synthesizer produces,
reference ``backend/ml/data_prep/helper.py`` + ``raw_data_pre_preparation.py:
114-167``) so the shipped vocab covers the serving inputs well.
"""
from __future__ import annotations

import collections
import re
from pathlib import Path


def build_wordpiece_vocab(corpus: list[str], vocab_size: int = 8192,
                          min_frequency: int = 1) -> list[str]:
    """Train a WordPiece vocab. Uses the HF `tokenizers` trainer when available
    (a local library, not a download); falls back to a frequency-based builder."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    try:
        from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

        tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
        tok.normalizer = normalizers.BertNormalizer(lowercase=True)
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        trainer = trainers.WordPieceTrainer(
            vocab_size=vocab_size, special_tokens=specials, min_frequency=min_frequency
        )
        tok.train_from_iterator(corpus, trainer)
        vocab = tok.get_vocab()
        return [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    except ImportError:
        counts: collections.Counter[str] = collections.Counter()
        chars: set[str] = set()
        for line in corpus:
            for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", line.lower()):
                counts[w] += 1
                chars.update(w)
        toks = specials + sorted(chars) + ["##" + c for c in sorted(chars)]
        for w, c in counts.most_common():
            if c < min_frequency or w in toks:
                continue
            toks.append(w)
            if len(toks) >= vocab_size:
                break
        return toks


def build_t5_vocab(corpus: list[str], vocab_size: int = 8192,
                   num_extra_ids: int = 100) -> list[str]:
    """T5-style piece list (CASED, like the real T5 spiece model): <pad>,
    </s>, <unk>, ▁-prefixed words/chars, suffix pieces by frequency, then
    <extra_id_*> sentinels at the top (T5 layout)."""
    from mmdx_tpu_torch.text.t5_tokenizer import WORD_BOUNDARY as WB

    counts: collections.Counter[str] = collections.Counter()
    chars: set[str] = set()
    for line in corpus:
        for w in line.split():
            counts[w] += 1
            chars.update(w)

    pieces = ["<pad>", "</s>", "<unk>"]
    pieces += [WB] + [WB + c for c in sorted(chars)] + sorted(chars)
    budget = vocab_size - num_extra_ids
    for w, _ in counts.most_common():
        p = WB + w
        if p not in pieces:
            pieces.append(p)
        if len(pieces) >= budget:
            break
    # common english suffix pieces help generalization
    for suf in ("s", "ing", "ed", "ion", "al", "ly", "er", "est", "ity"):
        if len(pieces) < budget and suf not in pieces:
            pieces.append(suf)
    pieces += [f"<extra_id_{i}>" for i in range(num_extra_ids - max(0, len(pieces) - budget))]
    return pieces


def score_t5_vocab(pieces: list[str], corpus: list[str],
                   em_iters: int = 2) -> list[tuple[str, float]]:
    """Fit unigram-LM log-prob scores for a piece inventory on a corpus
    (a lightweight stand-in for SentencePiece's EM trainer: segment corpus
    with current scores -> recount -> rescore).  Output pairs in
    spm_export_vocab TSV order; control/sentinel pieces score 0 like
    SentencePiece's."""
    import math

    from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer

    vocab = {p: i for i, p in enumerate(pieces)}
    is_control = [p.startswith("<") and p.endswith(">") for p in pieces]
    # init: uniform-ish, longer pieces slightly preferred so the first
    # segmentation pass resembles longest-match
    scores = {i: -10.0 + 0.1 * len(p) for i, p in enumerate(pieces)}
    for _ in range(max(1, em_iters)):
        tok = T5StyleTokenizer(vocab=vocab, scores=scores)
        counts = collections.Counter()
        for line in corpus:
            counts.update(tok.encode(line, add_eos=False))
        total = sum(counts.values()) or 1
        floor = math.log(0.1 / total)
        scores = {
            i: (math.log(counts[i] / total) if counts.get(i) else floor)
            for i in range(len(pieces))
        }
    return [
        (p, 0.0 if is_control[i] else round(scores[i], 6))
        for i, p in enumerate(pieces)
    ]


def default_medical_corpus(n_synthetic: int = 3000, seed: int = 7) -> list[str]:
    """Synthesized domain corpus (diseases, symptoms, report phrasing, and a few
    thousand sampled patient-details strings covering the serving input space)."""
    import random

    from mmdx_tpu_torch.config import DISEASES
    from mmdx_tpu_torch.pipelines.data_prep import (
        REPORT_PHRASES,
        SYMPTOMS_MAP,
        synthesize_patient_details,
    )

    # cased, like the inputs at serving time (the WordPiece builder lowercases
    # internally for the uncased BERT vocab; the T5 vocab is cased like the
    # real spiece model)
    lines: list[str] = []
    lines += list(DISEASES)
    for disease, symptoms in SYMPTOMS_MAP.items():
        lines.append(disease + " , " + " , ".join(symptoms))
    lines += list(REPORT_PHRASES)
    ages = [f"{a} year old {s} {v} view" for a in (18, 31, 44, 57, 63, 78, 85)
            for s in ("male", "female") for v in ("PA", "AP", "lateral")]
    lines += ages
    lines += [
        "smoking history of 40 pack years , hypertension , productive cough",
        "leg swelling , shortness of breath , low grade fever , cough",
        "no acute cardiopulmonary abnormality . heart size is normal .",
        "the lungs are clear without focal consolidation , effusion or pneumothorax .",
        "there is no pleural effusion or pneumothorax . bony structures are intact .",
        "comparison is made to prior radiograph . cardiomediastinal silhouette is stable .",
        "impression : findings consistent with pulmonary edema and cardiomegaly .",
        "recent surgery , diabetes , chest pain , wheezing , fatigue , chills ,",
        "clinical question , key history , medications , oxygen requirement , vitals",
        "interval improvement . low lung volumes . bibasilar atelectasis .",
        "endotracheal tube and nasogastric tube in standard position .",
        "degenerative changes of the thoracic spine . no displaced rib fracture .",
        "right lower lobe airspace disease concerning for pneumonia versus aspiration .",
        "mild pulmonary vascular congestion without frank edema .",
        "stable small left pleural effusion . no new consolidation .",
    ]
    rng = random.Random(seed)
    for i in range(n_synthetic):
        vec = [1 if rng.random() < 0.2 else 0 for _ in range(len(DISEASES))]
        lines.append(synthesize_patient_details(vec, rng))
        if i % 3 == 0:
            lines.append(" ".join(rng.sample(REPORT_PHRASES, 2)))
    return lines


def write_vocab(tokens, path: str | Path) -> Path:
    """Write a vocab file: plain piece-per-line for a list of strings, or
    spm_export_vocab-style TSV (piece\\tscore) for (piece, score) pairs."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        t if isinstance(t, str) else f"{t[0]}\t{t[1]}"
        for t in tokens
    ]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path
