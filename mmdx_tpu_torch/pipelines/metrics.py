"""Evaluation metrics: micro-averaged AUROC and ROUGE-L. Copy of
``mmdx_tpu/pipelines/metrics.py``.

The reference publishes hardcoded placeholder metrics to its registry
("whatever you computed", reference ``backend/ml/pipelines/training_pipeline
.py:1112``) — it contains no metric computation code.  We compute them for
real.
"""
from __future__ import annotations

import numpy as np


def auroc_micro(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Micro-averaged AUROC over all (sample, class) decisions.

    Rank-based (Mann-Whitney U) with tie correction; returns nan when only one
    class is present.
    """
    t = np.asarray(y_true, np.float32).reshape(-1)
    s = np.asarray(y_score, np.float64).reshape(-1)
    pos = t > 0.5
    n_pos = int(pos.sum())
    n_neg = int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    ranks[order] = np.arange(1, len(s) + 1, dtype=np.float64)
    # average ranks for ties
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(reference: str, candidate: str, beta: float = 1.2) -> float:
    """ROUGE-L F-measure on whitespace tokens."""
    ref = reference.lower().split()
    cand = candidate.lower().split()
    lcs = _lcs_len(ref, cand)
    if lcs == 0:
        return 0.0
    p = lcs / len(cand)
    r = lcs / len(ref)
    return float((1 + beta**2) * p * r / (r + beta**2 * p))


def rouge_l_corpus(references: list[str], candidates: list[str]) -> float:
    scores = [rouge_l(r, c) for r, c in zip(references, candidates)]
    return float(np.mean(scores)) if scores else 0.0
