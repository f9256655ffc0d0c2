"""Training losses matching the reference's torch semantics.

Port of ``mmdx_tpu/pipelines/losses.py``:

- BCE with logits (mean) for the multi-label disease heads;
- T5 cross-entropy: mean over labels != -100 (``IGNORE_INDEX``);
- the joint fusion loss = BCE + gen_weight * CE.

Each computes in f32 whatever the logits' dtype, as the JAX functions do.
"""
from __future__ import annotations

import torch

IGNORE_INDEX = -100
F32 = torch.float32


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    count: int | None = None) -> torch.Tensor:
    """Numerically stable mean binary cross-entropy with logits:
    max(x, 0) - x*y + log(1 + exp(-|x|)). With ``count`` the sum over it
    instead: a data rank's part of the mean over the whole batch."""
    x, y = logits.to(F32), targets.to(F32)
    loss = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return loss.mean() if count is None else loss.sum() / count


def t5_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     valid_count: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level CE averaged over labels != -100; logits [B, L, V], labels
    [B, L]. ``valid_count`` replaces the divisor (the whole batch's count of
    valid labels, for a data rank's part)."""
    logits = logits.to(F32)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid.to(F32)
    if valid_count is None:
        valid_count = valid.to(F32).sum().clamp_min(1.0)
    return nll.sum() / valid_count


def fusion_loss(disease_logits, disease_targets, report_logits=None, report_labels=None,
                gen_weight: float = 1.0):
    """-> (BCE(disease) + gen_weight * CE(report), {"cls", "gen"})."""
    loss_cls = bce_with_logits(disease_logits, disease_targets)
    loss_gen = torch.zeros((), dtype=F32, device=loss_cls.device)
    if report_logits is not None and report_labels is not None:
        loss_gen = t5_cross_entropy(report_logits, report_labels)
    return loss_cls + gen_weight * loss_gen, {"cls": loss_cls, "gen": loss_gen}
