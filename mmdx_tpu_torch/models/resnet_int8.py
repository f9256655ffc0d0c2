"""Int8 "turbo" ResNet-50 image tower: static post-training quantization.

Port of ``mmdx_tpu/models/resnet_int8.py`` (``:47-505``): the calibration
sites, the folded f32 calibration pass (``folded_backbone``,
``folded_forward``, ``calibrate_backbone``), the gray stem fold
(``_gray_stem``), ``quantize_backbone`` and ``int8_backbone_apply``.

Scheme, as in the JAX package: BatchNorms folded into the convs (the port's
checkpoint bridge folds them at load); per-output-channel int8 weights with
scale amax/127; per-tensor int8 activations at static scales calibrated on a
representative batch; every conv an s8 x s8 -> s32 product with a fused f32
requant epilogue; the residual joins in conv3's epilogue; in downsample
blocks the shortcut is requantized at its own scale (``<block>.short``)
first; the pooled [B, 2048] features come back in f32.

On a CUDA tensor every conv goes through K5 (``ops/int8_gemm.py``): a 1x1
conv is the GEMM over the flattened NHWC rows (stride as a slice), a 3x3 conv
and the 7x7 stem are an int8 im2col (plain torch on the device, K = 9 Cin,
147 for the RGB stem, 49 for the gray one) into the same GEMM. conv1, conv2
and the stem use the ReLU epilogue; conv3 the residual one; the downsample
shortcut the plain one without ReLU. The TPU's space-to-depth rewrites of
the stride-2 convs were a layout fix for its convolution tiling and are
bit-exact by construction, so the port computes the direct conv. The
f32 calibration pass, the input quantize, the im2col, the max-pool and the
mean are glue that XLA ran outside Pallas; they stay plain PyTorch.

``int8_backbone_apply(q, x, fuse_stages=(1, 2))`` (``MMDX_INT8_FUSED_BLOCKS``
in the engine, ``resnet_int8.py:415-440``) runs each stride-1 identity block
(``block > 0``) of the listed stages as one fused bottleneck
(``ops/int8_bottleneck.py``, Queue 2 row 13) from its folded requant chain:
with ``1,2`` that is stage 1 blocks 1-2 and stage 2 blocks 1-3. The fold is
made once per block and scales and kept (``fused_block_operands``); its
weights are views of the block's "wk", which the kernel reads in place.

Layouts follow the JAX package: NHWC activations, HWIO int8 weights ("w"),
each a view of its K-major GEMM operand ("wk" [co, K], the one copy).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from mmdx_tpu_torch.models.resnet import RESNET50_STAGES
from mmdx_tpu_torch.ops.int8_bottleneck import (fold_block_epilogues,
                                                fused_bottleneck_int8)
from mmdx_tpu_torch.ops.int8_gemm import (K_ALIGN, div_exact, int8_gemm_requant,
                                          int8_gemm_res_requant)

F32 = torch.float32

GRAY_CENTER = 0.5        # preprocess_batch_device_gray emits u - GRAY_CENTER
# static activation scale of the gray input, |u - 0.5| <= 0.5 exactly. Like
# every activation scale here it is an f32 value (``jnp.float32`` in the JAX
# package) kept as the Python float that holds it exactly.
GRAY_SCALE = float(np.float32(0.5 / 127.0))


def _block_names():
    for stage, n_blocks in enumerate(RESNET50_STAGES):
        for block in range(n_blocks):
            yield f"layer{stage + 1}_block{block}", stage, block


def calibration_sites() -> list[str]:
    """Site names in execution order: "input" (stem input), "stem" (after
    stem ReLU + max-pool), per block ".a1", ".a2", ".out", and ".short" (the
    downsample shortcut's requant point) in each stage's first block."""
    sites = ["input", "stem"]
    for name, _, block in _block_names():
        sites += [f"{name}.a1", f"{name}.a2", f"{name}.out"]
        if block == 0:
            sites.append(f"{name}.short")
    return sites


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions (cuDNN defaults to TF32,
    which would move the calibrated amax scales), restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def folded_backbone(backbone, device=None) -> dict:
    """The port's BN-folded ResNet-50 (``models/resnet.ResNet50``) as f32
    {"stem": (w OIHW, b), "<block>": {"conv1", "conv2", "conv3"[, "down"]}}
    on ``device``."""
    def conv(c):
        return (c.weight.detach().to(device=device, dtype=F32),
                c.bias.detach().to(device=device, dtype=F32))

    tree = {"stem": conv(backbone.stem)}
    for (name, _, _), blk in zip(_block_names(), backbone.blocks):
        d = {"conv1": conv(blk.conv1), "conv2": conv(blk.conv2), "conv3": conv(blk.conv3)}
        if blk.downsample is not None:
            d["down"] = conv(blk.downsample)
        tree[name] = d
    return tree


def folded_forward(folded: dict, x, collect: bool = False):
    """f32 forward over the folded stack: preprocessed NHWC images ->
    (pooled [B, 2048], {site: amax(|tensor|)} when ``collect``). The
    calibration pass and the numerics oracle of the int8 tower."""
    sites = {}

    def tap(name, v):
        if collect:
            sites[name] = float(v.abs().amax())
        return v

    def conv(v, wb, stride, pad):
        return F.conv2d(v, wb[0], wb[1], stride, pad)

    with full_f32():
        x = tap("input", x.to(F32).permute(0, 3, 1, 2))  # NCHW view
        x = F.max_pool2d(torch.relu(conv(x, folded["stem"], 2, 3)), 3, 2, 1)
        tap("stem", x)
        for name, stage, block in _block_names():
            d = folded[name]
            stride = 2 if (stage > 0 and block == 0) else 1
            a1 = tap(f"{name}.a1", torch.relu(conv(x, d["conv1"], 1, 0)))
            a2 = tap(f"{name}.a2", torch.relu(conv(a1, d["conv2"], stride, 1)))
            y = conv(a2, d["conv3"], 1, 0)
            short = tap(f"{name}.short", conv(x, d["down"], stride, 0)) if "down" in d else x
            x = tap(f"{name}.out", torch.relu(y + short))
        return x.mean(dim=(2, 3)), sites


@torch.inference_mode()
def calibrate_backbone(folded: dict, images) -> dict[str, float]:
    """{site: amax} of the folded f32 tower over a PREPROCESSED NHWC batch
    (ImageNet-normalized, the exact serving input), as plain floats."""
    return folded_forward(folded, images, collect=True)[1]


def _hwio(w_oihw):
    return w_oihw.permute(2, 3, 1, 0).contiguous()


def _gray_stem(w_hwio, b, mean, std, img_size: int):
    """Fold the 1->3 channel broadcast and the per-channel normalize into the
    (BN-folded, f32) stem for centered gray input v = u - 0.5: the summed
    weights ``wg [7, 7, 1, co]`` and the positional map ``K = conv(ones, wz) +
    b`` [1, img/2, img/2, co] that carries the valid-tap correction at the
    borders (``resnet_int8.py:194-226``)."""
    dev = w_hwio.device
    mean = torch.as_tensor(mean, dtype=F32, device=dev)
    std = torch.as_tensor(std, dtype=F32, device=dev)
    wg = torch.sum(w_hwio / std[None, None, :, None], dim=2, keepdim=True)
    wz = torch.sum(w_hwio * ((GRAY_CENTER - mean) / std)[None, None, :, None],
                   dim=2, keepdim=True)
    ones = torch.ones((1, 1, img_size, img_size), dtype=F32, device=dev)
    with full_f32():
        k_map = F.conv2d(ones, wz.permute(3, 2, 0, 1), None, 2, 3)
    return wg, k_map.permute(0, 2, 3, 1) + b


def gemm_weight(w_hwio) -> torch.Tensor:
    """s8 HWIO weights -> the GEMM operand, K-major ``[co, K]`` and
    contiguous: K = kh*kw*ci columns in the im2col column order, zero-padded
    to a multiple of K_ALIGN (the stems: 147 -> 160, 49 -> 64). The kernel's
    ``wgmma`` reads 8-bit operands K-major only, so this is laid out once,
    at quantization."""
    w2 = w_hwio.reshape(-1, w_hwio.shape[-1]).T
    return F.pad(w2, (0, -w2.shape[1] % K_ALIGN)).contiguous()


def hwio_view(wk, shape) -> torch.Tensor:
    """The HWIO weights ``shape`` (kh, kw, ci, co) as a view of their GEMM
    operand ``wk [co, K]`` (no copy: the qparams keep one copy of each
    weight)."""
    kh, kw, ci, co = shape
    return wk[:, :kh * kw * ci].T.reshape(kh, kw, ci, co)


def _qconv(w_hwio, b) -> dict:
    ws = div_exact(torch.clamp_min(w_hwio.abs().amax(dim=(0, 1, 2)), 1e-12), 127.0)
    wi = torch.clamp(torch.round(w_hwio / ws), -127, 127).to(torch.int8)
    wk = gemm_weight(wi)
    # contiguous where the kernel takes them (the gray stem's map comes out
    # of a permute); "w" is the HWIO view of "wk"
    return {"w": hwio_view(wk, wi.shape), "wk": wk, "ws": ws.contiguous(),
            "b": b.contiguous()}


def act_scale(amax: float) -> float:
    """amax -> what one int8 step is worth, an f32 value (``jnp.float32(max(
    amax, 1e-12) / 127.0)``)."""
    return float(np.float32(max(float(amax), 1e-12) / 127.0))


def quantize_backbone(folded: dict, act_scales: dict[str, float], mean=None,
                      std=None, img_size: int = 224) -> dict:
    """The int8 qparams from the folded f32 stack and the calibrated amax:
    per conv {"w": s8 HWIO (a view of "wk"), "wk": its K-major GEMM operand
    [co, K] (``gemm_weight``), "ws": f32 [co], "b": f32 [co]}, the gray stem
    (its "b" the positional map), and {"scales": {site: f32 step}}."""
    missing = [s for s in calibration_sites() if s not in act_scales]
    if missing:
        raise ValueError(f"act_scales missing calibration sites: {missing[:4]}")
    if mean is None or std is None:
        from mmdx_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

        mean = IMAGENET_MEAN if mean is None else mean
        std = IMAGENET_STD if std is None else std
    w_stem, b_stem = _hwio(folded["stem"][0]), folded["stem"][1]
    q = {"stem": _qconv(w_stem, b_stem),
         "stem_gray": _qconv(*_gray_stem(w_stem, b_stem, mean, std, img_size))}
    for name, _, _ in _block_names():
        q[name] = {k: _qconv(_hwio(w), b) for k, (w, b) in folded[name].items()}
    q["scales"] = {k: act_scale(v) for k, v in act_scales.items()}
    return q


# ---------------------------------------------------------------------------
# the int8 tower
# ---------------------------------------------------------------------------
def _requant(y, s) -> torch.Tensor:
    """f32 -> int8 at activation scale s (symmetric, saturating)."""
    return torch.clamp(torch.round(div_exact(y, s)), -127, 127).to(torch.int8)


def im2col_s8(x, k: int, stride: int, pad: int, cols: int | None = None):
    """int8 NHWC [B, H, W, C] -> ([B*Ho*Wo, cols], Ho, Wo): the k*k*C
    columns in the HWIO weight order (dy, dx, c), zero padding, then zero
    columns up to ``cols`` (the K of ``gemm_weight``), all in one copy."""
    b, h, w, c = x.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(k) for dx in range(k)]
    extra = (cols or k * k * c) - k * k * c
    if extra:
        taps.append(x.new_zeros((b, ho, wo, extra)))
    return torch.cat(taps, dim=3).reshape(b * ho * wo, -1), ho, wo


def maxpool_nonneg_s8(x):
    """MaxPool2d(3, stride 2, padding 1) on int8 NHWC values known >= 0 (after
    a ReLU requant), where zero padding equals -inf padding: the max of the
    nine strided taps, in int8."""
    _, h, w, _ = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + 2 * (ho - 1) + 1:2, dx:dx + 2 * (wo - 1) + 1:2]
            out = t if out is None else torch.maximum(out, t)
    return out.contiguous()


def _conv_s8(xi, qc, sx, s_out, stride: int, relu: bool = True, res=None, rs=None):
    """One int8 conv of NHWC ``xi`` at input scale ``sx`` through K5 ->
    (s8 [B*Ho*Wo, co], Ho, Wo)."""
    kh, co = qc["w"].shape[0], qc["w"].shape[-1]
    wk = qc["wk"]
    alpha = qc["ws"] * sx
    if kh == 1:
        if stride != 1:
            xi = xi[:, ::stride, ::stride]
        b, ho, wo, cin = xi.shape
        cols = xi.reshape(b * ho * wo, cin)
    else:
        cols, ho, wo = im2col_s8(xi, kh, stride, (kh - 1) // 2, wk.shape[1])
    bias = qc["b"].reshape(-1, co) if qc["b"].dim() > 1 else qc["b"]
    if res is None:
        out = int8_gemm_requant(cols, wk, alpha, bias, s_out, relu=relu)
    else:
        out = int8_gemm_res_requant(cols, wk, alpha, bias, res, rs, s_out, relu=relu)
    return out, ho, wo


def fused_block_operands(d: dict, s_in: float, s1: float, s2: float, s_out: float) -> dict:
    """``fold_block_epilogues(d, s_in, s1, s2, s_out)``, made at a block's
    first fused call and kept in its qparams (``d["fused_operands"]``); made
    again only when a scale or one of the block's tensors changes (new
    storage or a new version)."""
    tensors = [d[c][k] for c in ("conv1", "conv2", "conv3") for k in ("wk", "ws", "b")]
    key = (s_in, s1, s2, s_out, *(  # inference tensors keep no version
        (t.data_ptr(), None if t.is_inference() else t._version) for t in tensors))
    hit = d.get("fused_operands")
    if hit is None or hit[0] != key:
        hit = d["fused_operands"] = (key, fold_block_epilogues(d, s_in, s1, s2, s_out))
    return hit[1]


@torch.inference_mode()
def int8_backbone_apply(q: dict, x, fuse_stages=()) -> torch.Tensor:
    """Preprocessed NHWC images -> pooled [B, 2048] f32 features.

    3-channel inputs are ImageNet-normalized images; 1-channel inputs must be
    the centered raw gray of ``preprocess_batch_device_gray`` (v = u - 0.5),
    quantized at the static GRAY_SCALE into the folded gray stem.
    ``fuse_stages``: the 1-based stages whose stride-1 blocks run fused."""
    sc = q["scales"]
    gray = x.shape[-1] == 1 and "stem_gray" in q
    if gray:
        km = q["stem_gray"]["b"]
        if km.shape[1] != x.shape[1] // 2 or km.shape[2] != x.shape[2] // 2:
            raise ValueError(
                f"gray stem K map was folded for img_size {km.shape[1] * 2}, got a "
                f"{x.shape[1]}x{x.shape[2]} gray batch — pass img_size= to "
                "quantize_backbone")
        stem, s_in = q["stem_gray"], GRAY_SCALE
    else:
        stem, s_in = q["stem"], sc["input"]
    b = x.shape[0]
    xi = _requant(x.to(F32), s_in)
    y, ho, wo = _conv_s8(xi, stem, s_in, sc["stem"], 2)
    xi = maxpool_nonneg_s8(y.reshape(b, ho, wo, -1))
    sx = sc["stem"]

    for name, stage, block in _block_names():
        d = q[name]
        stride = 2 if (stage > 0 and block == 0) else 1
        s1, s2, so = (sc[f"{name}.{k}"] for k in ("a1", "a2", "out"))
        if block > 0 and stage + 1 in fuse_stages:
            xi = fused_bottleneck_int8(xi, **fused_block_operands(d, sx, s1, s2, so))
            sx = so
            continue
        a, h1, w1 = _conv_s8(xi, d["conv1"], sx, s1, 1)
        a, h2, w2 = _conv_s8(a.reshape(b, h1, w1, -1), d["conv2"], s1, s2, stride)
        if "down" in d:
            ss = sc[f"{name}.short"]
            res, _, _ = _conv_s8(xi, d["down"], sx, ss, stride, relu=False)
            rs = ss
        else:
            res, rs = xi.reshape(b * h2 * w2, -1), sx
        y, _, _ = _conv_s8(a.reshape(b, h2, w2, -1), d["conv3"], s2, so, 1,
                           res=res, rs=rs)
        xi = y.reshape(b, h2, w2, -1)
        sx = so
    return xi.to(F32).mean(dim=(1, 2)) * sx
