"""Sequence pooling. Port of ``mmdx_tpu/ops/pooling.py``."""
from __future__ import annotations

import torch


def masked_mean_pool(last_hidden_state: torch.Tensor,
                     attention_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the non-padding tokens: [B, L, H], [B, L] -> [B, H]."""
    mask = attention_mask[..., None].to(last_hidden_state.dtype)
    summed = (last_hidden_state * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1e-6)
    return summed / counts
