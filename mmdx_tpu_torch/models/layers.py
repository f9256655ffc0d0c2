"""Small inference layers in flax's parameter layout.

``Dense`` keeps flax ``nn.Dense``'s ``kernel [in, out]`` so the ported
kernels take it as the row-major B operand of ``x @ W`` and the weight bridge
(checkpoints/bridge.py) copies trees without transposes. Parameters are
inference-only (``requires_grad=False``).
"""
from __future__ import annotations

import torch
from torch import nn

from mmdx_tpu_torch.ops.fused_ffn import layer_norm_f32


def param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Dense(nn.Module):
    """y = x @ kernel + bias (flax nn.Dense)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = param(d_in, d_out)
        self.bias = param(d_out) if bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (scale, bias); f32 statistics, output in x.dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param(d)
        self.bias = param(d)

    def forward(self, x):
        return layer_norm_f32(x.float(), self.scale, self.bias, self.eps).to(x.dtype)
