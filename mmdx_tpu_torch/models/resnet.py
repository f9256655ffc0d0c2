"""ResNet-50 image tower with the BatchNorms folded into the convolutions.

Port of ``mmdx_tpu/models/resnet.py`` (``ImageEncoder`` and the folded-BN
inference path ``Bottleneck._folded`` / ``ResNet50`` with ``folded_bn``):
7x7/2 stem, 3x3/2 max-pool, bottleneck stages (3, 4, 6, 3) with the stride
on the 3x3 conv (v1.5), global average pool, projection and the warm-up
classifier head.

The checkpoint bridge folds each BatchNorm into its conv in f32
(``mmdx_tpu/ops/pallas_bottleneck.py:fold_bn``) and converts HWIO kernels to
OIHW, so each conv here is ``conv2d(x, w) + b``. The JAX package runs these
convs through XLA, not Pallas, so they stay ``torch.nn.functional.conv2d``.
The public boundary is NHWC, as in the JAX package; inside, the NHWC batch is
viewed as NCHW in channels-last memory.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import ImageEncoderConfig
from mmdx_tpu_torch.models.layers import Dense, param

RESNET50_STAGES = (3, 4, 6, 3)


class Conv(nn.Module):
    """BN-folded convolution: OIHW weight + per-channel bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = param(cout, cin, k, k)
        self.bias = param(cout)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, projection: bool):
        super().__init__()
        self.conv1 = Conv(cin, width, 1)
        self.conv2 = Conv(width, width, 3, stride, 1)
        self.conv3 = Conv(width, 4 * width, 1)
        self.downsample = Conv(cin, 4 * width, 1, stride) if projection else None

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


class ResNet50(nn.Module):
    """NCHW (channels-last) in, pooled [B, 2048] features out."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.stem = Conv(in_ch, 64, 7, 2, 3)
        blocks, cin = [], 64
        for stage, n_blocks in enumerate(RESNET50_STAGES):
            width = 64 * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(cin, width, stride, block == 0))
                cin = 4 * width
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = F.relu(self.stem(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x)
        return x.mean(dim=(2, 3))


class ImageEncoder(nn.Module):
    def __init__(self, config: ImageEncoderConfig):
        super().__init__()
        self.config = config
        self.backbone = ResNet50()
        self.proj = Dense(config.feat_dim, config.d_img)
        self.classifier = (Dense(config.d_img, config.n_disease)
                           if config.use_warmup_classifier else None)

    def encode(self, images_nhwc):
        """Preprocessed NHWC images [B, S, S, 3] -> embeddings [B, d_img]."""
        x = images_nhwc.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        return self.proj(self.backbone(x))

    def project(self, feats):
        """Pooled backbone features [B, 2048] (f32 from the int8 tower) ->
        embeddings, in the weights' dtype (``ImageEncoder.heads``)."""
        return self.proj(feats.to(self.proj.kernel.dtype))
