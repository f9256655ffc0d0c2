"""Offline data preparation: label raw reports, synthesize patient details,
stage images + parquet into the object store. Copy of
``mmdx_tpu/pipelines/data_prep.py``; the HF-dataset and OpenAI backends stay
gated on their packages, as there. ``prepared_rows`` is steps 1-4 without
pandas (the training pipeline's entry where pandas or pyarrow is missing).

Rebuilds the capability of the reference's one-shot prep script (reference
``backend/ml/data_prep/raw_data_pre_preparation.py``): for each raw row
(image, findings, impression) it
  1. derives a 13-bit disease classification vector from the report text
     (the reference calls OpenAI gpt-5 per row, :74-106; we make the labeler
     pluggable — a deterministic rule-based labeler is the offline default and
     an LLM-backed labeler can be injected where egress exists),
  2. synthesizes a free-text ``patient_details`` string (age/sex/view/risk
     factors/symptoms sampled with disease-aware hints, :114-167),
  3. concatenates findings+impression into ``report`` (:173-174),
  4. uploads the JPEG to the object store under a content-hashed key and
     replaces the image column with its URL (:232-257),
  5. writes the dataset as parquet (:260-272).

No import-time side effects (the reference runs the whole prep at import,
:319 — a bug we do not replicate); drive it via scheduler/commands.py.
"""
from __future__ import annotations

import hashlib
import io
import random
import re
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np

from mmdx_tpu_torch.config import DISEASES

# Disease -> plausible presenting symptoms (our own domain table; same role as
# the reference's SYMPTOMS_MAP, helper.py:8-22).
SYMPTOMS_MAP: dict[str, list[str]] = {
    "No Finding": ["routine screening", "no acute symptoms", "follow up"],
    "Enlarged Cardiomediastinum": ["chest fullness", "shortness of breath", "fatigue"],
    "Cardiomegaly": ["exertional dyspnea", "leg swelling", "orthopnea", "fatigue"],
    "Lung Opacity": ["nonproductive cough", "mild dyspnea", "intermittent fever"],
    "Lung Lesion": ["weight loss", "chronic cough", "hemoptysis"],
    "Edema": ["shortness of breath", "orthopnea", "leg swelling"],
    "Consolidation": ["productive cough", "fever", "pleuritic chest pain"],
    "Pneumonia": ["fever", "productive cough", "chills", "pleuritic chest pain"],
    "Atelectasis": ["shortness of breath", "recent surgery", "chest discomfort"],
    "Pneumothorax": ["sudden chest pain", "acute dyspnea", "recent trauma"],
    "Pleural Effusion": ["dyspnea", "pleuritic chest pain", "dry cough"],
    "Pleural Other": ["chronic chest pain", "prior asbestos exposure"],
    "Fracture": ["chest wall pain", "recent fall", "trauma", "point tenderness"],
}

# Report phrasing seeds for tokenizer vocab coverage / synthetic corpora.
REPORT_PHRASES: list[str] = [
    "No acute cardiopulmonary abnormality.",
    "Heart size is within normal limits.",
    "The lungs are clear without focal consolidation, effusion, or pneumothorax.",
    "There is mild cardiomegaly with pulmonary vascular congestion.",
    "Patchy opacity in the right lower lobe concerning for pneumonia.",
    "Small left pleural effusion with adjacent atelectasis.",
    "No displaced rib fracture identified.",
    "Interval improvement in pulmonary edema.",
]

# keyword -> disease index, for the rule-based labeler
_KEYWORDS: list[tuple[str, str]] = [
    (r"enlarged cardiomediastin|widened mediastin", "Enlarged Cardiomediastinum"),
    (r"cardiomegaly|enlarged heart|heart size is enlarged", "Cardiomegaly"),
    (r"opacit|opacification|infiltrate", "Lung Opacity"),
    (r"lesion|nodule|mass", "Lung Lesion"),
    (r"edema|vascular congestion", "Edema"),
    (r"consolidat", "Consolidation"),
    (r"pneumonia", "Pneumonia"),
    (r"atelecta", "Atelectasis"),
    (r"pneumothora", "Pneumothorax"),
    (r"pleural effusion|effusion", "Pleural Effusion"),
    (r"pleural thickening|pleural plaque|pleural scarr", "Pleural Other"),
    (r"fracture", "Fracture"),
]
_NEGATION = re.compile(
    r"\b(no|without|negative for|absence of|free of|resolved|no evidence of)\b[^.;:]*$"
)


def rule_based_disease_labeler(report_text: str) -> list[int]:
    """Deterministic 13-bit labeler from report text (offline default).

    Scans sentence fragments for disease keywords, respecting simple negation
    ("no ...", "without ...").  Returns the fixed-order vector over DISEASES.
    """
    vec = [0] * len(DISEASES)
    text = (report_text or "").lower()
    for fragment in re.split(r"[.;:]", text):
        for pattern, disease in _KEYWORDS:
            m = re.search(pattern, fragment)
            if not m:
                continue
            prefix = fragment[: m.start()]
            if _NEGATION.search(prefix):
                continue
            vec[DISEASES.index(disease)] = 1
    if not any(vec):
        vec[DISEASES.index("No Finding")] = 1
    return vec


# report-text keyword -> symptom phrase, scanned case-insensitively on word
# boundaries (reference _infer_hints capability, data_prep/helper.py:36-45:
# "very light hinting from report text")
_HINT_PATTERNS: tuple[tuple[str, str], ...] = (
    (r"\b(?:fever|febrile|pyrexi)", "fever"),
    (r"\b(?:cough|sputum)", "cough"),
    (r"\b(?:pleur|chest pain)", "pleuritic chest pain"),
    (r"\b(?:dyspn|shortness of breath|\bsob\b)", "shortness of breath"),
    (r"\b(?:edema|effusion|orthopnea)", "leg swelling"),
)


def infer_symptom_hints(report_text: str | None) -> set[str]:
    """Symptoms the report text itself mentions, so the synthesized patient
    details stay consistent with the findings (reference helper.py:36-45)."""
    import re

    t = (report_text or "").lower()
    return {hint for pat, hint in _HINT_PATTERNS if re.search(pat, t)}


def synthesize_patient_details(
    disease_vector: Sequence[int], rng: random.Random,
    report_text: str | None = None,
) -> str:
    """Free-text patient details with disease-aware symptoms (reference
    create_patient_details_column capability, raw_data_pre_preparation.py:114-167),
    seeded with symptoms hinted by the report text when one is given."""
    age = rng.randint(18, 90)
    sex = rng.choice(["male", "female"])
    view = rng.choice(["PA", "AP", "lateral"])
    parts = [f"{age} year old {sex} {view} view"]
    if rng.random() < 0.4:
        parts.append(f"smoking history of {rng.choice([5, 10, 20, 30, 40])} pack years")
    for risk, p in (("hypertension", 0.3), ("diabetes", 0.2), ("copd", 0.15)):
        if rng.random() < p:
            parts.append(risk)
    hints = sorted(infer_symptom_hints(report_text))
    pool: list[str] = []
    for i, bit in enumerate(disease_vector):
        if bit:
            pool.extend(s for s in SYMPTOMS_MAP.get(DISEASES[i], [])
                        if s not in hints)
    if not pool and not hints:
        pool = SYMPTOMS_MAP["No Finding"]
    parts.extend(hints)  # report-grounded symptoms always included
    k = min(len(pool), max(0, rng.randint(1, 3) - len(hints)))
    if k:
        parts.extend(rng.sample(pool, k))
    return " , ".join(parts)


@dataclass
class RawExample:
    image_bytes: bytes
    findings: str
    impression: str


def prepared_rows(
    examples: Iterable[RawExample],
    store,  # mmdx_tpu_torch.io.store.ObjectStore
    *,
    image_prefix: str = "chest-x-ray-images/",
    labeler: Callable[[str], list[int]] | None = None,
    seed: int = 0,
) -> dict[str, list]:
    """Steps 1-4 without pandas: label, synthesize details, stage each image
    in ``store`` -> the dataset's columns (image_url, patient_details,
    disease_classification_vector, report) as lists."""
    labeler = labeler or rule_based_disease_labeler
    rng = random.Random(seed)
    cols: dict[str, list] = {"image_url": [], "patient_details": [],
                             "disease_classification_vector": [], "report": []}
    for ex in examples:
        report = f"{ex.findings.strip()} {ex.impression.strip()}".strip()
        vec = labeler(report)
        details = synthesize_patient_details(vec, rng, report_text=report)
        digest = hashlib.sha256(ex.image_bytes).hexdigest()[:14]
        key = f"{image_prefix}{digest[:8]}-{digest[8:14]}.jpg"
        store.put(key, ex.image_bytes)
        cols["image_url"].append(store.url_for(key))
        cols["patient_details"].append(details)
        cols["disease_classification_vector"].append(np.asarray(vec, np.float32))
        cols["report"].append(report)
    return cols


def prepare_raw_dataset(
    examples: Iterable[RawExample],
    store,  # mmdx_tpu_torch.io.store.ObjectStore
    *,
    image_prefix: str = "chest-x-ray-images/",
    parquet_key: str = "raw_data/dataset.parquet",
    labeler: Callable[[str], list[int]] | None = None,
    seed: int = 0,
):
    """Run the full prep pipeline into `store`; returns the prepared DataFrame.

    Columns match the reference's parquet schema consumed by the feature
    pipeline (feature_pipeline.py:34): image_url, patient_details,
    disease_classification_vector, report.
    """
    import pandas as pd

    df = pd.DataFrame(prepared_rows(examples, store, image_prefix=image_prefix,
                                    labeler=labeler, seed=seed))
    buf = io.BytesIO()
    df.to_parquet(buf, index=False)
    store.put(parquet_key, buf.getvalue())
    return df


def hf_dataset_examples(name: str = "itsanmolgupta/mimic-cxr-dataset",
                        split: str = "train[:100]") -> list[RawExample]:
    """Load raw examples from the HF dataset the reference uses (reference
    raw_data_pre_preparation.py:298). Gated: requires hub egress."""
    import io as _io

    from datasets import load_dataset

    ds = load_dataset(name, split=split)
    out = []
    for row in ds:
        img = row["image"]
        buf = _io.BytesIO()
        img.save(buf, format="JPEG", quality=95)  # reference JPEG q95 (:242-257)
        out.append(RawExample(buf.getvalue(), row.get("findings", "") or "",
                              row.get("impression", "") or ""))
    return out


def parse_label_bits(content: str) -> list[int]:
    """Extract a 13-bit 0/1 label vector from free-form LLM output.

    Prefers a contiguous run of exactly-13 standalone 0/1 tokens; falls back
    to digit-boundary-guarded scanning. Prose digits ("the 13 bits",
    "0=absent") must not inject spurious bits — a naive [01] findall shifts
    the whole vector. Defaults to one-hot "No Finding" when nothing parses.
    """
    run = re.search(r"(?<!\d)(?:[01][\s,;]*){13}(?!\d)", content)
    if run:
        bits = re.findall(r"[01]", run.group(0))[:13]
    else:
        bits = re.findall(r"(?<![\d=])[01](?![\d.])", content)[:13]
    vec = [int(b) for b in bits] + [0] * (13 - len(bits))
    if not any(vec):
        vec[DISEASES.index("No Finding")] = 1
    return vec


def llm_disease_labeler(model: str = "gpt-5"):
    """LLM-backed labeler factory mirroring the reference's OpenAI labeling
    (raw_data_pre_preparation.py:74-106). Gated: requires the openai package +
    API egress; offline deployments use rule_based_disease_labeler."""
    from openai import OpenAI

    client = OpenAI()
    names = ", ".join(DISEASES)

    def label(report_text: str) -> list[int]:
        prompt = (
            "Given this chest X-ray report, return a comma-separated vector of "
            f"13 bits (1=present, 0=absent) for: {names}.\nReport: {report_text}"
        )
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}]
        )
        return parse_label_bits(resp.choices[0].message.content or "")

    return label


def synthetic_raw_examples(n: int = 16, seed: int = 0) -> list[RawExample]:
    """Generate synthetic raw examples (gray gradient JPEGs + templated reports)
    for tests/dev where the HF source dataset is unavailable."""
    from PIL import Image

    rng = random.Random(seed)
    out = []
    for i in range(n):
        arr = (np.outer(np.linspace(0, 255, 64), np.ones(64)) + rng.randint(0, 40)) % 256
        img = Image.fromarray(arr.astype(np.uint8), mode="L")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=95)
        findings = rng.choice(REPORT_PHRASES)
        impression = rng.choice(REPORT_PHRASES)
        out.append(RawExample(buf.getvalue(), findings, impression))
    return out
