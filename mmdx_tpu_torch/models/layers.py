"""Small inference layers in flax's parameter layout.

``Dense`` keeps flax ``nn.Dense``'s ``kernel [in, out]`` so the ported
kernels take it as the row-major B operand of ``x @ W`` and the weight bridge
(checkpoints/bridge.py) copies trees without transposes. Parameters are
inference-only (``requires_grad=False``).
"""
from __future__ import annotations

import torch
from torch import nn

from mmdx_tpu_torch.ops.gemm import layer_norm_f32


def param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


def cast_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module``'s weights to the compute dtype in place, except the
    modules marked ``keep_f32`` (T5 RMSNorm scales and relative-bias tables,
    f32 in the JAX package whatever the compute dtype) and the biases marked
    ``keep_f32_bias`` (the fused bottlenecks' folded biases)."""
    for mod in module.modules():
        if getattr(mod, "keep_f32", False):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias" and getattr(mod, "keep_f32_bias", False):
                continue
            p.data = p.data.to(dtype)
    return module


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
