"""Fused BERT attention block:
``LayerNorm(x + softmax(Q K^T / sqrt(d) + kmask) V Wo + bo)``.

Port of ``mmdx_tpu/ops/pallas_bert_attn.py:fused_attention_block``: the bf16
``_kernel`` (K1, below) and the W8A8 ``_kernel_int8`` of ``int8_matmuls=True``
(K7, ``fused_attention_block_int8`` at the end of the module).

K1 kernel (CUDA C++, ``csrc/gemm.cu`` through ``ops/gemm.py`` +
``csrc/bert_attn.cu``), four launches:

1. ``qkv = bf16(x @ Wqkv + bqkv)`` — the wgmma GEMM on TMA-fed stages,
   bias epilogue (merged weights: q|k|v column blocks, head-major in each);
2. the attention core on the tensor cores, one block per (sequence, head,
   query tile of ``query_tile`` rows): Q, K, V and the key mask in shared
   memory by cp.async, ``mma.sync`` scores in f32, scale and mask in f32,
   the softmax across a quad's lanes, bf16 probabilities, ``mma.sync``
   context in f32, written as bf16;
3. ``ctx @ Wo`` — the GEMM, into f32 ``(acc + bo) + x`` rows, or split over
   K into f32 partials where ``gemm_plan`` does so to fill the SMs;
4. ``out = bf16(LayerNorm(y))``, eps 1e-12, f32 statistics (summing the
   partials in split order, then adding ``bo``, then ``x``).

What bounds it on the H100: at B=32, L=96 the block is 15.4 GFLOP, nearly
all in the two projections (16 us on the tensor cores); with the
intermediates in device memory the four launches also move ~71 MB, so the
byte floor (~21 us) sits just above the FLOP floor, and fusing the
launches would leave it FLOP-bound. The attention core is small (L <= 128,
0.9 GFLOP) and each block computes only its own sequence's scores: the TPU
kernel's block-diagonal packing of several sequences into one score
matrix, a layout fix for the MXU, would multiply the score work here for
nothing. The merged qkv, the context and the f32 pre-LayerNorm rows, which
the TPU kernel kept in VMEM, go through device memory (scratch from
``torch.empty``).
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops import gemm
from mmdx_tpu_torch.ops.fused_ffn import quant_rows
from mmdx_tpu_torch.ops.gemm import cdiv, layer_norm_f32

F32 = torch.float32
MAX_SEQ_LEN = 128
HEAD_DIM = 64  # the attention core's mma tiles take heads of 64
QUERY_TILES = (64, 48, 32, 16)


def query_tile(batch: int, seq_len: int, heads: int, sms: int = gemm.H100_SMS) -> int:
    """Query rows per block of the attention core (a multiple of 16, one
    warp per 16 rows): the tallest tile, no taller than the sequence's
    padded length, whose grid (heads x sequences x query tiles) fills the
    SMs; else 16. Taller tiles read each sequence's K and V fewer times."""
    padded = cdiv(seq_len, 16) * 16
    for qt in QUERY_TILES:
        if qt <= padded and heads * batch * cdiv(seq_len, qt) >= sms:
            return qt
    return 16


def attention_core(qkv, kmask, seq_len: int, num_heads: int, out_dtype=torch.bfloat16):
    """Launch the attention core (``csrc/bert_attn.cu``) on the merged
    ``qkv [M, 3H]`` (CUDA bf16, checked by the caller): the context
    ``[M, H]`` in ``out_dtype`` (bf16 for K1, f32 for K7). Counts no launch:
    the blocks that call it do."""
    m, h = qkv.shape[0], qkv.shape[1] // 3
    b = m // seq_len
    ctx = torch.empty((m, h), dtype=out_dtype, device=qkv.device)
    lib = _build.lib()
    fn = lib.mmdx_bert_attn_f32 if out_dtype == F32 else lib.mmdx_bert_attn
    _build.check(fn(qkv.data_ptr(), kmask.data_ptr(), ctx.data_ptr(), b, seq_len, h,
                    num_heads, query_tile(b, seq_len, num_heads, gemm.sms_of(qkv)),
                    1.0 / float(h // num_heads) ** 0.5, _build.stream(qkv)),
                 "attn_core_f32" if out_dtype == F32 else "attn_core")
    return ctx


def _check_shape(name: str, m: int, h: int, seq_len: int, num_heads: int) -> None:
    if m % seq_len or not 0 < seq_len <= MAX_SEQ_LEN:
        raise ValueError(f"{name}: seq_len {seq_len} must divide {m} rows and be "
                         f"<= {MAX_SEQ_LEN}")
    if h != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: unsupported width {h} / {num_heads} heads "
                         f"(heads of {HEAD_DIM})")


def attention_ctx_f32(qkv, kmask, seq_len: int, num_heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) + kmask) V per sequence from the merged
    ``qkv [M, 3H]``: f32 scores and softmax, probabilities rounded to
    qkv.dtype, f32 context [M, H] (the Pallas bodies' rounding points)."""
    dt = qkv.dtype
    m, hidden = qkv.shape[0], qkv.shape[1] // 3
    d = hidden // num_heads
    b = m // seq_len

    def heads(t):  # [M, H] -> [B, heads, L, d]
        return t.reshape(b, seq_len, num_heads, d).permute(0, 2, 1, 3).to(F32)

    q, k, v = (heads(t) for t in qkv.split(hidden, dim=1))
    s = (q @ k.transpose(-1, -2)) / (float(d) ** 0.5)
    s = s + kmask.to(F32).reshape(b, 1, 1, seq_len)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return (p.to(F32) @ v).permute(0, 2, 1, 3).reshape(m, hidden)


def fused_attention_block_plain(x, kmask, wqkv, bqkv, wo, bo, ln_scale, ln_bias,
                                seq_len: int, num_heads: int, eps: float = 1e-12):
    """Plain PyTorch version, per sequence, with the Pallas body's rounding
    points (qkv, probabilities and context rounded to x.dtype)."""
    dt = x.dtype
    qkv = (x.to(F32) @ wqkv.to(F32) + bqkv.to(F32)).to(dt)
    ctx = attention_ctx_f32(qkv, kmask, seq_len, num_heads).to(dt)
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
    for t, name, shape in ((x, "x", (m, h)), (wqkv, "wqkv", (h, 3 * h)),
                           (bqkv, "bqkv", (3 * h,)), (wo, "wo", (h, h)),
                           (bo, "bo", (h,)), (ln_scale, "ln_scale", (h,)),
                           (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    _build.require(kmask, "kmask", F32, (m,))
    _check_shape("fused_attention_block", m, h, seq_len, num_heads)
    qkv = torch.empty((m, 3 * h), dtype=bf, device=x.device)
    gemm.gemm(x, wqkv, bqkv, None, qkv, _build.EPI_BIAS_BF16,
              gemm.gemm_plan(m, 3 * h, h, gemm.sms_of(x)), "attn_qkv")
    ctx = attention_core(qkv, kmask, seq_len, num_heads)
    out = gemm.residual_gemm_ln(ctx, wo, bo, x, ln_scale, ln_bias, eps, "attn_out")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0


# ---------------------------------------------------------------------------
# K7: the W8A8 attention block (turbo tier)
# ---------------------------------------------------------------------------
def fused_attention_block_int8_plain(x, kmask, wqkv_i8, wqkvs, bqkv, wo_i8, wos, bo,
                                     ln_scale, ln_bias, seq_len: int, num_heads: int,
                                     eps: float = 1e-12):
    """Plain PyTorch version of ``_kernel_int8`` (``pallas_bert_attn.py:83-135``):
    per-row int8 x, exact s32 QKV product dequantized and rounded to x.dtype,
    the attention core with an f32 context, per-row int8 context, exact s32
    out-projection, f32 residual and LayerNorm."""
    from mmdx_tpu_torch.ops.int8_gemm import gemm_dequant_plain

    xi, sx = quant_rows(x.to(F32))
    qkv = gemm_dequant_plain(xi, wqkv_i8, sx, wqkvs, bqkv, None, x.dtype, _build.DQ_BF16)
    ctx = attention_ctx_f32(qkv, kmask, seq_len, num_heads)
    ci, sc = quant_rows(ctx)
    y = gemm_dequant_plain(ci, wo_i8, sc, wos, bo, x, F32, _build.DQ_RESID_BIAS_F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(x.dtype)


def fused_attention_block_int8(x, kmask, wqkv_i8, wqkvs, bqkv, wo_i8, wos, bo,
                               ln_scale, ln_bias, seq_len: int, num_heads: int,
                               eps: float = 1e-12):
    """W8A8 attention block, ``fused_attention_block(int8_matmuls=True)`` with
    the weights quantized once by ``quant_weight_cols``: wqkv_i8 s8 [3H, H]
    (K-major), wqkvs f32 [3H], wo_i8 s8 [H, H] (K-major), wos f32 [H]; the
    rest as ``fused_attention_block``.

    Kernel (CUDA C++, ``csrc/int8_gemm.cu`` + ``csrc/bert_attn.cu`` +
    ``csrc/gemm.cu``), six launches: row-quantize x; the int8 core with the
    dequant + bias epilogue into bf16 qkv; the attention core writing an f32
    context (the int8 body keeps it f32 before quantizing it); row-quantize
    the context; the int8 core with the dequant + residual + bias epilogue
    into f32; the LayerNorm kernel. What bounds it on the H100: the two
    projections' int8 operations and the intermediates' bytes, as in K1.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (bf16 x, L <= 128) or raise."""
    if x.device.type == "cpu":
        return fused_attention_block_int8_plain(x, kmask, wqkv_i8, wqkvs, bqkv, wo_i8,
                                                wos, bo, ln_scale, ln_bias, seq_len,
                                                num_heads, eps)
    from mmdx_tpu_torch.ops.int8_gemm import gemm_dequant, quant_rows_launch

    m, h = x.shape
    bf = torch.bfloat16
    for t, name, shape in ((x, "x", (m, h)), (ln_scale, "ln_scale", (h,)),
                           (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    _build.require(kmask, "kmask", F32, (m,))
    _check_shape("fused_attention_block_int8", m, h, seq_len, num_heads)
    xi, sx = quant_rows_launch(x)
    qkv = gemm_dequant(xi, wqkv_i8, sx, wqkvs, bqkv, None, bf, _build.DQ_BF16)
    ctx = attention_core(qkv, kmask, seq_len, num_heads, F32)
    ci, sc = quant_rows_launch(ctx)
    y = gemm_dequant(ci, wo_i8, sc, wos, bo, x, F32, _build.DQ_RESID_BIAS_F32)
    out = torch.empty_like(x)
    gemm.layer_norm(y, ln_scale, ln_bias, out, eps, "attn_int8_ln")
    fused_attention_block_int8.launches += 1
    return out


fused_attention_block_int8.launches = 0
