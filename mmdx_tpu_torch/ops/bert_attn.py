"""Fused BERT attention block:
``LayerNorm(x + softmax(Q K^T / sqrt(d) + kmask) V Wo + bo)``.

Port of ``mmdx_tpu/ops/pallas_bert_attn.py:fused_attention_block`` (the bf16
``_kernel``; the int8 ``_kernel_int8`` is turbo tier, not ported yet).

Kernel (CUDA C++, ``csrc/gemm.cu`` + ``csrc/bert_attn.cu``), four launches:

1. ``qkv = bf16(x @ Wqkv + bqkv)`` — tiled bf16 tensor-core GEMM, bias
   epilogue (merged weights: q|k|v column blocks, head-major in each);
2. attention core, one block per (sequence, head): Q, K^T, V staged in
   shared memory, f32 scores and softmax, bf16 probabilities, bf16 context;
3. ``y = f32((ctx @ Wo + bo) + x)`` — GEMM with bias + residual epilogue;
4. ``out = bf16(LayerNorm(y))``, eps 1e-12, f32 statistics.

What bounds it on the H100: at B=32, L=96 the block is 15.4 GFLOP, nearly
all in the two projections, which run on the tensor cores; with the
intermediates in device memory the four launches also move ~71 MB, so the
byte floor (~21 us) sits just above the FLOP floor (~16 us), and fusing the
launches would leave it FLOP-bound. The attention core is small (L <= 128)
and each block computes only its own sequence's scores:
the TPU kernel's block-diagonal packing of several sequences into one score
matrix, a layout fix for the MXU, would multiply the score work here for
nothing. The merged qkv, the context and the f32 pre-LayerNorm rows, which
the TPU kernel kept in VMEM, go through device memory (scratch from
``torch.empty``).
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops.fused_ffn import layer_norm_f32

F32 = torch.float32
MAX_SEQ_LEN = 128


def fused_attention_block_plain(x, kmask, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                                seq_len: int, num_heads: int, eps: float = 1e-12):
    """Plain PyTorch version, per sequence, with the Pallas body's rounding
    points (qkv, probabilities and context rounded to x.dtype)."""
    dt = x.dtype
    m, hidden = x.shape
    d = hidden // num_heads
    b = m // seq_len
    qkv = (x.to(F32) @ wqkv.to(F32) + bqkv.to(F32)).to(dt)

    def heads(t):  # [M, H] -> [B, heads, L, d]
        return t.reshape(b, seq_len, num_heads, d).permute(0, 2, 1, 3).to(F32)

    q, k, v = (heads(t) for t in qkv.split(hidden, dim=1))
    s = (q @ k.transpose(-1, -2)) / (float(d) ** 0.5)
    s = s + kmask.to(F32).reshape(b, 1, 1, seq_len)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = (p.to(F32) @ v).to(dt).permute(0, 2, 1, 3).reshape(m, hidden)
    y = x.to(F32) + ctx.to(F32) @ wo.to(F32) + bo.to(F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(dt)


def fused_attention_block(x, kmask, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                          seq_len: int, num_heads: int, eps: float = 1e-12):
    """x [B*L, H]; kmask [B*L] f32 additive (0 / -1e9); wqkv [H, 3H];
    bqkv [3H]; wo [H, H]; bo, ln_scale, ln_bias [H] -> [B*L, H].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, L <= 128) or raise."""
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, kmask, wqkv, bqkv, wo, bo, ln_scale,
                                           ln_bias, seq_len, num_heads, eps)
    m, h = x.shape
    bf = torch.bfloat16
    if m % seq_len or not 0 < seq_len <= MAX_SEQ_LEN:
        raise ValueError(f"fused_attention_block: seq_len {seq_len} must divide "
                         f"{m} rows and be <= {MAX_SEQ_LEN}")
    if h % 64 or h % num_heads or (h // num_heads) % 8:
        raise ValueError(f"fused_attention_block: unsupported width {h} / {num_heads} heads")
    for t, name, shape in ((x, "x", (m, h)), (wqkv, "wqkv", (h, 3 * h)),
                           (bqkv, "bqkv", (3 * h,)), (wo, "wo", (h, h)),
                           (bo, "bo", (h,)), (ln_scale, "ln_scale", (h,)),
                           (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    _build.require(kmask, "kmask", F32, (m,))
    lib, s = _build.lib(), _build.stream(x)
    qkv = torch.empty((m, 3 * h), dtype=bf, device=x.device)
    ctx = torch.empty((m, h), dtype=bf, device=x.device)
    y = torch.empty((m, h), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.mmdx_gemm_bf16(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                                    None, qkv.data_ptr(), m, 3 * h, h,
                                    _build.EPI_BIAS_BF16, s), "attn_qkv")
    _build.check(lib.mmdx_bert_attn(qkv.data_ptr(), kmask.data_ptr(), ctx.data_ptr(),
                                    m // seq_len, seq_len, h, num_heads,
                                    1.0 / float(h // num_heads) ** 0.5, s), "attn_core")
    _build.check(lib.mmdx_gemm_bf16(ctx.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                    x.data_ptr(), y.data_ptr(), m, h, h,
                                    _build.EPI_BIAS_RESID_F32, s), "attn_out")
    _build.check(lib.mmdx_layernorm_f32_bf16(y.data_ptr(), ln_scale.data_ptr(),
                                             ln_bias.data_ptr(), out.data_ptr(),
                                             m, h, eps, s), "attn_ln")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
