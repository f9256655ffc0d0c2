"""Small inference layers in flax's parameter layout.

``Dense`` keeps flax ``nn.Dense``'s ``kernel [in, out]`` so the ported
kernels take it as the row-major B operand of ``x @ W`` and the weight bridge
(checkpoints/bridge.py) copies trees without transposes. Parameters are
made with ``requires_grad=False``; the trainer's bridge
(checkpoints/train_bridge.py) turns them on for the towers it trains.
``Dropout`` is the training path's seeded dropout.
"""
from __future__ import annotations

import torch
from torch import nn

from mmdx_tpu_torch.ops.gemm import layer_norm_f32


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over f32 operands with an f32 result, under autocast too (it
    would otherwise compute and return bf16): the JAX package's
    ``preferred_element_type=float32`` products, whose bf16 operands are
    exact in f32."""
    with torch.autocast(a.device.type, enabled=False):
        return a.to(torch.float32) @ b.to(torch.float32)


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
    """y = x @ kernel + bias (flax nn.Dense).

    ``shard_`` makes it one rank's part of a tensor-parallel product
    (``parallel.sharding.shard_model_`` calls it by the rules): "col" keeps
    the rank's share of each of the kernel's ``blocks`` column blocks (a
    merged q|k|v kernel has 3) and of the bias, and its input passes
    ``copy_to_model`` (whose backward sums the input's gradient over
    "model"); "row" keeps the rank's share of the rows, sums the partial
    products over "model" and then adds the whole bias once. A share must
    hold whole ``unit``s (an attention projection's heads)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *, blocks: int = 1,
                 unit: int = 1):
        super().__init__()
        self.kernel = param(d_in, d_out)
        self.bias = param(d_out) if bias else None
        self.blocks, self.unit = blocks, unit
        self.tp = None  # (kind, ModelShard) once sharded

    def shard_(self, shard, kind: str) -> "Dense":
        col = kind == "col"
        if kind not in ("col", "row"):
            raise ValueError(f"unknown shard kind {kind!r}")
        n = self.kernel.shape[1] // self.blocks if col else self.kernel.shape[0]
        if n % (shard.size * self.unit):
            raise ValueError(f"{n} {'columns' if col else 'rows'} in units of {self.unit} "
                             f"(heads) cannot be split over {shard.size} model ranks")
        index = torch.cat([shard.cols(n, i * n) for i in range(self.blocks if col else 1)])
        with torch.no_grad():
            if col:
                self.kernel = _like(self.kernel, self.kernel[:, index])
                if self.bias is not None:
                    self.bias = _like(self.bias, self.bias[index])
            else:
                self.kernel = _like(self.kernel, self.kernel[index])
        self.tp = (kind, shard)
        return self

    @property
    def group(self):
        """The "model" group of a sharded product, else None."""
        return None if self.tp is None else self.tp[1].group

    def forward(self, x):
        if self.tp is None:
            y = x @ self.kernel
            return y if self.bias is None else y + self.bias
        from mmdx_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model

        kind, shard = self.tp
        if kind == "col":
            y = copy_to_model(x, shard) @ self.kernel
        else:
            y = reduce_from_model(x @ self.kernel, shard)
        return y if self.bias is None else y + self.bias


def _like(p: nn.Parameter, value: torch.Tensor) -> nn.Parameter:
    """A new parameter holding ``value`` (contiguous), trainable as ``p``."""
    return nn.Parameter(value.contiguous().clone(), requires_grad=p.requires_grad)


class Dropout:
    """Inverted dropout at ``rate`` drawing its masks from ``generator``
    (keep with probability 1 - rate, kept values scaled by 1 / (1 - rate),
    as flax ``nn.Dropout``); a seeded generator makes a run reproducible."""

    def __init__(self, rate: float, generator: torch.Generator):
        self.rate, self.generator = rate, generator

    def __call__(self, x):
        if self.rate <= 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.generator)
        return x * keep.to(x.dtype) / (1.0 - self.rate)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (scale, bias); f32 statistics, output in x.dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param(d)
        self.bias = param(d)

    def forward(self, x):
        return layer_norm_f32(x.float(), self.scale, self.bias, self.eps).to(x.dtype)
