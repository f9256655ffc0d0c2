"""Trainable ResNet-50 image tower with real BatchNorm.

Port of the training path of ``mmdx_tpu/models/resnet.py`` (``Bottleneck``
with ``nn.BatchNorm``, ``:61-106``; ``ResNet50``, ``:185-238``; the
``ImageEncoder`` methods ``backbone_features`` and ``heads`` that split the
model for phase 1, ``:243-295``). The serving tower (``models/resnet.py``)
folds every BatchNorm into its conv and stays as it is.

Parameters keep the JAX tree's names and layouts, so the weight bridge
(``checkpoints/train_bridge.py``) moves them both ways without arithmetic:
each conv ``kernel`` is HWIO (viewed as OIHW for ``F.conv2d``), each
BatchNorm has ``scale`` and ``bias`` parameters and ``mean`` and ``var``
buffers (the JAX ``batch_stats``), and the blocks are named
``layer<s>_block<b>``.

BatchNorm follows flax (``resnet.py:67``, ``:255``): ``train=True``
normalises with the batch's mean and *biased* variance and updates the
running statistics as ``ra = m * ra + (1 - m) * batch`` with flax's momentum
``m = 1 - config.bn_momentum`` (0.9), the batch variance biased too;
``train=False`` normalises with the running statistics and changes nothing.
(``torch.nn.BatchNorm2d`` stores the unbiased variance, weighs the batch by
``momentum`` and takes the variance in two passes, so BatchNorm is written
out here in flax's arithmetic.)

Only cuDNN convolutions and PyTorch ops: the JAX training steps run no
Pallas kernel (``use_folded_bn`` and ``use_fused_bottleneck`` apply only
when ``train`` is false, and the trainer sets neither).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import ImageEncoderConfig
from mmdx_tpu_torch.models.layers import Dense
from mmdx_tpu_torch.models.resnet import RESNET50_STAGES

F32 = torch.float32


class ConvKernel(nn.Module):
    """A bias-free conv's HWIO ``kernel``."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, cout))

    def forward(self, x):
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), None, self.stride, self.pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW: params ``scale``, ``bias``; buffers
    ``mean``, ``var`` (the batch statistics)."""

    def __init__(self, c: int, momentum: float, eps: float):
        super().__init__()
        self.momentum, self.eps = momentum, eps  # flax convention (0.9)
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.group = None  # the "data" group the batch statistics span

    def _batch_stats(self, x32):
        """The batch's mean and E[x^2] per channel: over this rank's rows,
        or with ``group`` over every data rank's rows (sums and counts by
        ``all_reduce``, differentiated through)."""
        if self.group is None:
            return x32.mean(dim=(0, 2, 3)), (x32 * x32).mean(dim=(0, 2, 3))
        from mmdx_tpu_torch.parallel.sharding import sum_over

        s = x32.sum(dim=(0, 2, 3))
        sums = sum_over(torch.stack([s, (x32 * x32).sum(dim=(0, 2, 3)),
                                     torch.full_like(s, x32.numel() // x32.shape[1])]),
                        self.group)  # per channel: sum, sum of squares, count
        return sums[0] / sums[2], sums[1] / sums[2]

    def forward(self, x, train: bool):
        """flax's arithmetic (``normalization._compute_stats`` with
        ``use_fast_variance``, ``_normalize``): statistics in f32 (or f64
        for f64 inputs), the batch
        variance as E[x^2] - E[x]^2 clipped at 0, y = (x - mean) *
        (rsqrt(var + eps) * scale) + bias, in x's dtype. The batch
        statistics are differentiated through, as in flax; with ``group``
        set (``ImageEncoder.sync_batch_stats_``) they span every data rank's
        rows, so every rank keeps the same running statistics."""
        x32 = x.to(torch.promote_types(x.dtype, F32))
        if train:
            mean, sq = self._batch_stats(x32)
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1, BatchNorm after
    each conv, projection shortcut in block 0 of a stage."""

    def __init__(self, cin: int, width: int, stride: int, projection: bool,
                 momentum: float, eps: float):
        super().__init__()
        cout = 4 * width
        self.conv1, self.bn1 = ConvKernel(1, cin, width), BatchNorm(width, momentum, eps)
        self.conv2 = ConvKernel(3, width, width, stride, 1)
        self.bn2 = BatchNorm(width, momentum, eps)
        self.conv3, self.bn3 = ConvKernel(1, width, cout), BatchNorm(cout, momentum, eps)
        if projection:
            self.downsample_conv = ConvKernel(1, cin, cout, stride)
            self.downsample_bn = BatchNorm(cout, momentum, eps)
        else:
            self.downsample_conv = None

    def forward(self, x, train: bool):
        shortcut = x
        if self.downsample_conv is not None:
            shortcut = self.downsample_bn(self.downsample_conv(x), train)
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        return F.relu(y + shortcut)


class ResNet50(nn.Module):
    """NCHW (channels-last memory) in, pooled [B, 2048] features out."""

    def __init__(self, momentum: float, eps: float, in_ch: int = 3):
        super().__init__()
        self.conv_stem = ConvKernel(7, in_ch, 64, 2, 3)
        self.bn_stem = BatchNorm(64, momentum, eps)
        self.block_names, cin = [], 64
        for stage, n_blocks in enumerate(RESNET50_STAGES):
            width = 64 * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, Bottleneck(cin, width, stride, block == 0,
                                                 momentum, eps))
                self.block_names.append(name)
                cin = 4 * width

    def forward(self, x, train: bool):
        x = F.relu(self.bn_stem(self.conv_stem(x), train))
        # torch MaxPool2d(3, 2, padding=1): the JAX -inf pad + VALID pool
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(2, 3))


class ImageEncoder(nn.Module):
    """Backbone + projection + warm-up classifier, all trainable."""

    def __init__(self, config: ImageEncoderConfig):
        super().__init__()
        self.config = config
        self.backbone = ResNet50(1.0 - config.bn_momentum, config.bn_eps)
        self.proj = Dense(config.feat_dim, config.d_img)
        self.classifier = (Dense(config.d_img, config.n_disease)
                           if config.use_warmup_classifier else None)
        self.requires_grad_(True)

    def sync_batch_stats_(self, group) -> "ImageEncoder":
        """Train-mode BatchNorm statistics over every rank of ``group`` (the
        "data" axis of a mesh), or over this rank's rows (None)."""
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.group = group
        return self

    def backbone_features(self, images_nhwc, train: bool = False):
        """Preprocessed NHWC images [B, S, S, 3] -> pooled features [B, 2048]."""
        return self.backbone(images_nhwc.permute(0, 3, 1, 2), train)

    def heads(self, feats) -> dict:
        """Projection + classifier over pooled features."""
        z = self.proj(feats)
        out = {"embeddings": z}
        if self.classifier is not None:
            out["logits"] = self.classifier(z)
        return out

    def forward(self, images_nhwc, train: bool = False) -> dict:
        return self.heads(self.backbone_features(images_nhwc, train))
