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

``ImageEncoderConfig.use_fused_bottleneck`` routes the stride-1 blocks of
width up to ``fused_bottleneck_max_width`` (128: stage 1 blocks 0-2, block 0
with its projection, and stage 2 blocks 1-3) through the fused bottleneck
(ops/bottleneck.py, Queue 2 row 12), as ``Bottleneck._fused``
(``mmdx_tpu/models/resnet.py:154-179``): weights in the model dtype, the
folded biases kept f32. As in the JAX package ``use_folded_bn`` wins
(``:73-76``), and the engine sets it in fast and turbo mode, so no engine
mode runs the fused blocks: their path is an image encoder built with that
configuration. The route is fixed when the encoder is built, and each fused
block makes its kernel operands once (``Bottleneck.fused_operands``; in bf16
K-major, the layout the tensor-core kernel reads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import ImageEncoderConfig
from mmdx_tpu_torch.models.layers import Dense, param
from mmdx_tpu_torch.ops.bottleneck import fused_bottleneck, kmajor_hwio

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
    def __init__(self, cin: int, width: int, stride: int, projection: bool,
                 fusable: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, width, 1)
        self.conv2 = Conv(width, width, 3, stride, 1)
        self.conv3 = Conv(width, 4 * width, 1)
        self.downsample = Conv(cin, 4 * width, 1, stride) if projection else None
        self.fusable = fusable
        if fusable:  # the fused kernel adds f32 biases (cast_ keeps them)
            for conv in self.convs():
                conv.keep_f32_bias = True
        self._operands_key, self._operands = None, ()

    def convs(self):
        return [c for c in (self.conv1, self.conv2, self.conv3, self.downsample)
                if c is not None]

    def fused_operands(self, dt: torch.dtype) -> tuple:
        """The fused kernel's operands: [Cin, M], [3, 3, M, M] and [M, Cout]
        weights (and the [Cin, Cout] projection) in ``dt``, biases f32. In
        bf16 each weight is a view of K-major storage ([Cout, Cin], and
        [M, 9M] for the 3x3 conv: the OIHW rows with K contiguous), which the
        tensor-core kernel reads in place; in f32 row-major, as the CUDA-core
        body reads them. Made once and kept; made again only when a weight
        changes (a cast, a move or a load gives it new storage or a new
        version)."""
        key = (dt, *((p.device, p.data_ptr(), p._version)
                     for c in self.convs() for p in (c.weight, c.bias)))
        if key != self._operands_key:
            kmajor = dt == torch.bfloat16

            def mat(conv):  # 1x1 OIHW [Cout, Cin] -> [Cin, Cout]
                w = conv.weight[:, :, 0, 0].to(dt).clone(memory_format=torch.contiguous_format)
                return w.t() if kmajor else w.t().contiguous()

            w2 = self.conv2.weight  # OIHW [M, M, 3, 3]
            m = w2.shape[0]
            w2 = (kmajor_hwio(w2.permute(0, 2, 3, 1).to(dt).contiguous().reshape(m, 9 * m), m)
                  if kmajor else w2.permute(2, 3, 1, 0).to(dt).contiguous())
            proj = self.downsample
            self._operands = (
                mat(self.conv1), self.conv1.bias.float(), w2, self.conv2.bias.float(),
                mat(self.conv3), self.conv3.bias.float(),
                None if proj is None else mat(proj),
                None if proj is None else proj.bias.float())
            self._operands_key = key
        return self._operands

    def forward(self, x):
        if self.fusable:  # NCHW (channels-last) in and out, NHWC in the kernel
            y = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(),
                                 *self.fused_operands(x.dtype))
            return y.permute(0, 3, 1, 2)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


def fused_width(config: ImageEncoderConfig) -> int:
    """The widest bottleneck the fused kernel takes under ``config`` (0:
    none), as the JAX ``ImageEncoder.setup`` and ``Bottleneck.__call__``
    decide it: ``use_folded_bn`` wins over ``use_fused_bottleneck``."""
    if config.use_fused_bottleneck and not config.use_folded_bn:
        return config.fused_bottleneck_max_width
    return 0


class ResNet50(nn.Module):
    """NCHW (channels-last) in, pooled [B, 2048] features out."""

    def __init__(self, in_ch: int = 3, fuse_max_width: int = 0):
        super().__init__()
        self.stem = Conv(in_ch, 64, 7, 2, 3)
        blocks, cin = [], 64
        for stage, n_blocks in enumerate(RESNET50_STAGES):
            width = 64 * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(cin, width, stride, block == 0,
                                         fusable=stride == 1 and width <= fuse_max_width))
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
        self.backbone = ResNet50(fuse_max_width=fused_width(config))
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

    def classify(self, z):
        """Embeddings -> the warm-up classifier's probabilities [B, n_disease]
        f32: sigmoid of the f32 logits, as the JAX engine's single-modality
        path (``runtime/engine.py:527-558``)."""
        if self.classifier is None:
            raise ValueError("this tower has no warm-up classifier "
                             "(use_warmup_classifier is off)")
        return torch.sigmoid(self.classifier(z).to(torch.float32))
