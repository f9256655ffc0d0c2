"""The T5 decoder's cross-attention + FFN half-step.

Port of ``mmdx_tpu/ops/pallas_t5_step.py:cross_ffn_block``: RMSNorm ->
cross-attention over each row's own K conditioning tokens -> residual ->
RMSNorm -> ReLU FFN (512 -> 2048 -> 512) -> residual. T5 attention has no
1/sqrt(d) scale, and the T5 RMSNorm quirk is kept: f32 variance, the
normalised value rounded to the working dtype BEFORE the f32 scale multiply.

Kernel (CUDA C++, ``csrc/gemm.cu`` + ``csrc/t5_cross_attn.cu``), seven
launches: RMSNorm, q projection (GEMM), cross-attention core (one warp per
(row, head) over the row's own K keys), output projection with the bf16
residual epilogue, RMSNorm, wi with the ReLU epilogue, wo with the residual
epilogue.

What bounds it on the H100: latency and weight bytes. At N = B*nb = 32 rows
the products are small (32 x 512 x 5120 MACs per layer) and each step reads
the layer's 5.2 MB of bf16 weights once, so the time is launch latency plus
that read. The TPU kernel ran the chain as one program with every
intermediate in VMEM and all rows packed into a block-diagonal score matrix;
here the intermediates ([N, 512] and [N, 2048] bf16) go through device
memory between launches and each row attends only to its own keys. One
launch per layer (or a CUDA graph over the step) is later work.
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32


def rms_norm(x, scale, eps: float):
    """models/t5.RMSNorm: f32 variance, y rounded to x.dtype before the f32
    scale multiply, the product rounded again."""
    x32 = x.to(F32)
    var = x32.square().mean(-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return (scale.to(F32) * y.to(F32)).to(x.dtype)


def cross_ffn_block_plain(hidden, cross_ln_scale, wq, wo_c, ck, cv, enc_bias,
                          ffn_ln_scale, wi, wo_f, heads: int, eps: float = 1e-6):
    """Plain PyTorch version with the Pallas body's rounding points."""
    dt = hidden.dtype
    n, dm = hidden.shape
    kk = ck.shape[1]
    d = dm // heads

    def dot(a, w):
        return (a.to(F32) @ w.to(F32)).to(dt)

    y = rms_norm(hidden, cross_ln_scale, eps)
    q = dot(y, wq).reshape(n, heads, d).to(F32)
    s = torch.einsum("nhd,nkhd->nhk", q, ck.reshape(n, kk, heads, d).to(F32))
    s = s + enc_bias.to(F32)[:, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = torch.einsum("nhk,nkhd->nhd", p.to(F32),
                       cv.reshape(n, kk, heads, d).to(F32)).to(dt)
    x = (hidden.to(F32) + dot(ctx.reshape(n, dm), wo_c).to(F32)).to(dt)
    y = rms_norm(x, ffn_ln_scale, eps)
    hmid = dot(y, wi).clamp_min(0)
    return (x.to(F32) + dot(hmid, wo_f).to(F32)).to(dt)


def cross_ffn_block(hidden, cross_ln_scale, wq, wo_c, ck, cv, enc_bias,
                    ffn_ln_scale, wi, wo_f, heads: int, eps: float = 1e-6):
    """hidden [N, D]; cross_ln_scale, ffn_ln_scale f32 [D]; wq, wo_c [D, D];
    ck, cv [N, K, D] (head-major minor dim); enc_bias f32 [N, K] additive;
    wi [D, F]; wo_f [F, D] -> [N, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16) or raise."""
    if hidden.device.type == "cpu":
        return cross_ffn_block_plain(hidden, cross_ln_scale, wq, wo_c, ck, cv,
                                     enc_bias, ffn_ln_scale, wi, wo_f, heads, eps)
    n, dm = hidden.shape
    kk = ck.shape[1]
    dff = wi.shape[1]
    bf = torch.bfloat16
    if dm % 64 or dff % 64 or dm % heads:
        raise ValueError(f"cross_ffn_block: unsupported widths {dm}, {dff}, {heads} heads")
    for t, name, shape in ((hidden, "hidden", (n, dm)), (wq, "wq", (dm, dm)),
                           (wo_c, "wo_c", (dm, dm)), (ck, "ck", (n, kk, dm)),
                           (cv, "cv", (n, kk, dm)), (wi, "wi", (dm, dff)),
                           (wo_f, "wo_f", (dff, dm))):
        _build.require(t, name, bf, shape)
    for t, name, shape in ((cross_ln_scale, "cross_ln_scale", (dm,)),
                           (ffn_ln_scale, "ffn_ln_scale", (dm,)),
                           (enc_bias, "enc_bias", (n, kk))):
        _build.require(t, name, F32, shape)
    lib, s = _build.lib(), _build.stream(hidden)

    def empty(cols):
        return torch.empty((n, cols), dtype=bf, device=hidden.device)

    y, q, ctx, x, y2, hmid, out = (empty(dm), empty(dm), empty(dm), empty(dm),
                                   empty(dm), empty(dff), empty(dm))
    gemm = lib.mmdx_gemm_bf16
    _build.check(lib.mmdx_rmsnorm_bf16(hidden.data_ptr(), cross_ln_scale.data_ptr(),
                                       y.data_ptr(), n, dm, eps, s), "cross_ln")
    _build.check(gemm(y.data_ptr(), wq.data_ptr(), None, None, q.data_ptr(),
                      n, dm, dm, _build.EPI_BF16, s), "cross_q")
    _build.check(lib.mmdx_t5_cross_attn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                                        enc_bias.data_ptr(), ctx.data_ptr(), n, kk,
                                        heads, dm // heads, s), "cross_attn")
    _build.check(gemm(ctx.data_ptr(), wo_c.data_ptr(), None, hidden.data_ptr(),
                      x.data_ptr(), n, dm, dm, _build.EPI_RESID_BF16, s), "cross_o")
    _build.check(lib.mmdx_rmsnorm_bf16(x.data_ptr(), ffn_ln_scale.data_ptr(),
                                       y2.data_ptr(), n, dm, eps, s), "ffn_ln")
    _build.check(gemm(y2.data_ptr(), wi.data_ptr(), None, None, hmid.data_ptr(),
                      n, dff, dm, _build.EPI_RELU_BF16, s), "ffn_wi")
    _build.check(gemm(hmid.data_ptr(), wo_f.data_ptr(), None, x.data_ptr(),
                      out.data_ptr(), n, dm, dff, _build.EPI_RESID_BF16, s), "ffn_wo")
    cross_ffn_block.launches += 1
    return out


cross_ffn_block.launches = 0
