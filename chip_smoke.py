"""Smoke run of the PyTorch port (mmdx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1-2 only (build + kernel checks)

Phases (any failure exits nonzero):
  1. card and build: the card's name and power limit, torch/CUDA/nvcc
     versions, and the time to build the hand-written kernels from
     mmdx_tpu_torch/csrc with nvcc for sm_90a (one nvcc per source, in
     parallel);
  2. each kernel against its plain PyTorch version on the same inputs at
     serving shapes: max abs/rel error against the stated tolerance (the int8
     GEMM K5 and the int8 fused bottleneck bit for bit; the lm head's argmax
     exactly, outside reported near-ties), the median time of each over 30
     runs (CUDA events), the least time the card could take for the same
     work, and for the bf16 cache read and flash attention the time of the
     library call of the same function (scaled_dot_product_attention); the
     lm head (rows 10, 11) at N = 1 to 256 rows with a fully banned chunk
     and row, and on exact ties, each one kernel a call as the profiler
     counts it in every window (all taken first, before any CUDA graph)
     and the stats bit-equal over two launches; for
     K3, K4, K5 (every site, with TOP/s, GB/s and torch._int_mm's time for
     the product alone), K6, K7 and rows 5, 7 and 9 (and the library call)
     also the device time per call from a CUDA graph of 20 calls, which
     leaves out the wrapper's host time; each dequantizing epilogue of the
     int8 GEMM under K6 and K7 bit-equal to its plain epilogue (tanh-GELU
     within ATOL/RTOL); K6 and K7 at M = 384, 3072 and 16384 with the share
     of their bf16 outputs off the plain bits; rows 5 and 7 also against their plain version's bits
     (BITS_SHARE, BITS_ULP), K4 with the share of its bf16 outputs off the
     plain version's bits and bit-equal over two launches (deterministic
     split-K); row 9 fails unless each shape ran the body its rule names;
     K1 and K2 at the main path's rows (TEXT_SHAPES: one request, a ragged
     M = 144, B=4, B=32, L=128, long text's M = 16384) with the share of
     their bf16 outputs off the plain bits (TEXT_BITS_SHARE), their device
     time, the attention core alone, and each GEMM launch beside
     torch.addmm, the GEMM's yardstick; row 17 (fused preprocessing) at
     PRE_SHAPES (B=32 512x512, B=32 and B=4 256x256, a ragged 600x480; RGB
     and gray), f32 and bf16 out, one launch a call, with its device time
     from a CUDA graph of 20 calls, its share of the bound and the engine's
     route (preprocess_batch_device) beside it;
  3. the main paths at full width (ResNet-50 at 224, BERT-base, fusion 1024,
     T5-small decoder under beam-4, 150-180 new tokens) from random weights
     made from a seed, each with the launch counts set to 0 just before it
     and read just after:
       fast: engine.infer on one image, classify_batch + generate on a batch
       of 4; the same batch in parity mode for comparison;
       classify_image_batch and classify_text_batch (the warm-up heads) at
       B=4 within 0.1 of parity, K1 and K2 once per BERT layer in the text
       call;
       front end: the C++ host cores (mmdx_tpu_torch/native) built and in
       use by the engine's tokenizers and wire_image_u8, identical to the
       Python paths, the host time to tokenize B=32 texts at max_len 512
       native against Python; inference() on the card;
       turbo: the int8 image tower and the W8A8 text blocks, calibrating on
       its first batch: infer on a gray image, classify_batch on 4 gray and
       on 4 RGB images, generate for both; the turbo-vs-fast gap within
       TURBO_GAP;
       decode variants: fast greedy at B=4 and B=64, beam-4 with
       MMDX_DEFER_KV=0, an MMDX_KV_INT8=1 MMDX_FUSED_LM_HEAD=1 engine under
       beam-4 and greedy, the fused-lm-head greedy against the dense one;
       long text (max_len 512): fast classify in the 344 and 512 buckets
       (flash attention in every layer) and in the 176 bucket (the einsum
       route), against the parity engine;
       fused blocks: a turbo engine with MMDX_INT8_FUSED_BLOCKS=1,2 against
       the unfused turbo engine; the fused preprocessing beside the matmul
       one; the bf16 image tower with use_fused_bottleneck against the cuDNN
       tower;
     before them, the width contracts: an engine on the card from 16-wide
     heads is refused at construction, naming K1; the CPU engine answers;
  4. /api/predict/ through the port's WSGI app, in process: fast mode,
     turbo mode with a gray PNG upload, and fast mode with greedy reports.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. There is no CPU path: without a card the
script exits nonzero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# K1, K2, K4, K6, K7 and row 12 end in bf16 outputs of magnitude up to a
# few units: a few bf16 ulps (the Pallas bf16 tests use 3e-2 and 4e-2,
# tests/test_pallas_beam_attn.py:45, tests/test_pallas_t5_step.py:47)
ATOL = RTOL = 4e-2
# row 9: bf16 outputs of |out| <= ~0.3 (0.5 randn values averaged over 128
# to 512 keys); one bf16 ulp there is <= 2e-3, so the limit is about two
# ulps and far below the 5e-3 and more that a dropped or doubled key tile or
# a wrong padding bias moves an output
FLASH_ATOL, FLASH_RTOL = 2e-3, 1e-2
# K3's acc, m and l are f32 sums over the same bf16 products as its plain
# version, so they agree to f32 summation order, far inside this bound
K3_ATOL, K3_RTOL = 1e-4, 1e-3
# rows 5 and 7 beside ATOL: p and ctx are rounded to bf16 at the plain
# version's points, so only a summation order near a rounding tie can move
# an output, by an ulp or two; a wrong merge of the cluster's partials or
# statistics moves many outputs by many ulps
BITS_SHARE, BITS_ULP = 1e-3, 2
# K1 and K2 beside ATOL: the kernels' f32 sums run in another order than
# the plain version's (tile order, split-K), so an output near a bf16
# rounding tie lands one ulp off; in K1 a flipped qkv or context value also
# moves its row through the softmax and the out-projection. 0.4-3.1% of
# outputs came off the plain bits on an H100 at every shape (K1 up to 3.1%,
# K2 up to 1.0%); a dropped K step, split or key tile moves most of them.
# The size of a difference is ATOL's to bound: a LayerNorm output near 0
# is many ulps from its neighbour at the same absolute error.
TEXT_BITS_SHARE, TEXT_BITS_ULP = 0.05, None
# rows 10 and 11: f32 logits of bf16 products summed over D = 512 on the
# tensor cores and in the plain f32 product: summation order only
DEC_TOL = 1e-4
# turbo against fast mode: the JAX package's turbo guard
# (tests/test_resnet_int8.py:297) on the probabilities
TURBO_GAP = 0.05
# row 17: f32 sums of the same terms in another order (the kernel's banded
# FMAs, the plain version's dense f32 matmuls) on outputs of magnitude < 3
PRE_ATOL, PRE_RTOL = 1e-4, 1e-5
# row 17 in bf16: one rounding of a value within PRE_ATOL / PRE_RTOL of the
# plain f32 value: at most half a bf16 ulp, 2^-8 of its magnitude
BF16_HALF_ULP = 2.0 ** -8 + PRE_RTOL
# row 17's shapes (B, H, W, C): the canonical decode size of
# io/images.to_canonical_u8 (512x512), the serving wire shape of
# io/images.wire_image_u8(..., square=True) (256x256: one-hot taps, a crop
# and normalize) at B=32 and B=4, and a ragged 600x480; RGB and gray
PRE_SHAPES = [(32, 512, 512, 3), (32, 512, 512, 1), (32, 256, 256, 3), (32, 256, 256, 1),
              (4, 256, 256, 3), (4, 256, 256, 1), (32, 600, 480, 3), (32, 600, 480, 1)]
# published dense peaks of one H100 SXM (NVIDIA data sheet, at 700 W); f32
# outside the tensor cores
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12

KERNELS = {  # name: (source, TPU kernel it replaces: file:line of pallas_call)
    "bert_attn": ("mmdx_tpu_torch/csrc/bert_attn.cu",
                  "mmdx_tpu/ops/pallas_bert_attn.py:200"),
    "fused_ffn": ("mmdx_tpu_torch/csrc/gemm.cu",
                  "mmdx_tpu/ops/pallas_ffn.py:191"),
    "beam_attn_partial": ("mmdx_tpu_torch/csrc/beam_attn.cu",
                          "mmdx_tpu/ops/pallas_beam_attn.py:220"),
    "t5_cross_ffn": ("mmdx_tpu_torch/csrc/t5_cross_ffn.cu",
                     "mmdx_tpu/ops/pallas_t5_step.py:106"),
    "int8_gemm": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                  "mmdx_tpu/ops/pallas_int8_gemm.py:119"),
    "fused_ffn_int8": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                       "mmdx_tpu/ops/pallas_ffn.py:136"),
    "bert_attn_int8": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                       "mmdx_tpu/ops/pallas_bert_attn.py:177"),
    "beam_attn": ("mmdx_tpu_torch/csrc/beam_attn.cu",
                  "mmdx_tpu/ops/pallas_beam_attn.py:123"),
    "beam_attn_int8": ("mmdx_tpu_torch/csrc/beam_attn.cu",
                       "mmdx_tpu/ops/pallas_beam_attn.py:351"),
    "lm_head_greedy": ("mmdx_tpu_torch/csrc/lm_head.cu",
                       "mmdx_tpu/ops/pallas_lm_head.py:156"),
    "lm_head_stats": ("mmdx_tpu_torch/csrc/lm_head.cu",
                      "mmdx_tpu/ops/pallas_lm_head.py:210"),
    "flash_attention": ("mmdx_tpu_torch/csrc/flash_attn.cu",
                        "mmdx_tpu/ops/pallas_attention.py:94"),
    "int8_bottleneck": ("mmdx_tpu_torch/csrc/int8_bottleneck.cu",
                        "mmdx_tpu/ops/pallas_int8_bottleneck.py:155"),
    "bottleneck": ("mmdx_tpu_torch/csrc/bottleneck.cu",
                   "mmdx_tpu/ops/pallas_bottleneck.py:128"),
    "preprocess": ("mmdx_tpu_torch/csrc/preprocess.cu",
                   "mmdx_tpu/ops/pallas_preprocess.py:62"),
}


def pre_label(b, h, w, c) -> str:
    return f"B={b} {h}x{w} {'RGB' if c == 3 else 'gray'}"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def median_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call without the host's share: ``calls`` calls
    captured in one CUDA graph, the median replay time over ``calls``. For
    kernels shorter than their wrapper's host time, which ``median_ms``
    (one call between two events) measures instead."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, runs=replays, warmup=2) / calls


def bound(nbytes: float, int8_ops: float = 0.0, bf16_ops: float = 0.0,
          f32_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16 + f32_ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, ref, atol: float = ATOL, rtol: float = RTOL) -> float:
    """Print the max abs and rel error of ``got`` against ``ref``; fail
    unless every element is within atol + rtol * |ref|. -> max abs error."""
    import torch

    got, ref = got.float(), ref.float()
    same = got == ref  # equal infinities (a fully banned chunk's -inf) agree
    if not (torch.isfinite(got) | same).all():
        fail(f"{name}: kernel output is not finite")
    diff = torch.where(same, 0.0, (got - ref).abs())
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(1e-6)).max())
    ok = bool((same | (diff <= atol + rtol * ref.abs())).all())
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tol=atol {atol} + rtol {rtol}*|ref| -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def compare_bits(name: str, got, ref, share: float = BITS_SHARE,
                 max_ulp: int | None = BITS_ULP) -> None:
    """Fail unless at most ``share`` of the bf16 outputs differ from the
    plain version's bits (at least one may), each by at most ``max_ulp``
    units in the last place (+0 and -0 are one value; None: no ulp limit,
    where ATOL/RTOL bound the size of a difference)."""
    import torch

    def ordered(t):  # bf16 bit patterns on one integer line, in value order
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    ulps = (ordered(got) - ordered(ref)).abs()
    n_diff, worst = int((ulps != 0).sum()), int(ulps.max())
    ok = n_diff <= max(1, int(share * got.numel())) and (max_ulp is None or worst <= max_ulp)
    limit = f"{share:.1%} of them" + ("" if max_ulp is None else f", {max_ulp} ulp")
    log(f"  {name}: {n_diff} of {got.numel()} bf16 outputs ({n_diff / got.numel():.3%}) differ "
        f"from the plain version's bits, by at most {worst} ulp (limit {limit}) -> "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: more of the kernel's outputs than {limit} off the plain version's bits")


def compare_exact(name: str, got, ref) -> float:
    """Fail unless the int8 outputs are identical. -> max abs error (0)."""
    import torch

    if got.dtype != torch.int8 or got.shape != ref.shape:
        fail(f"{name}: expected int8 {tuple(ref.shape)}, got {got.dtype} {tuple(got.shape)}")
    diff = (got.int() - ref.int()).abs()
    n_bad = int((diff != 0).sum())
    log(f"  {name}: {n_bad} of {got.numel()} int8 outputs differ "
        f"(max |diff| {int(diff.max())}) -> {'ok' if n_bad == 0 else 'MISMATCH'}")
    if n_bad:
        fail(f"{name}: kernel is not bit-equal to its plain version")
    return float(diff.max())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def phase_card_and_build():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    card = card_line()
    log(f"card: {card}")
    from mmdx_tpu_torch import _build

    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc: {nvcc_v}")
    import PIL  # the WSGI app decodes uploads with Pillow (phase 4)

    log(f"Pillow: {PIL.__version__}")
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    log(f"kernels built from mmdx_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s "
        f"-> {so.name}")
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def phase_kernels(device) -> dict:
    """-> {name: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    from mmdx_tpu_torch.ops import beam_attn, t5_step

    lm_head_windows(device)  # before any CUDA graph (graph_ms) in the process
    g = torch.Generator(device="cpu").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(device=device, dtype=dtype)

    def timed(name, kernel, plain):
        ms, pms = median_ms(kernel), median_ms(plain)
        log(f"  {name} kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")
        return ms, pms

    out = {}

    # K1 / K2 at the main path's rows; K6 / K7 on their weights, quantized once
    text, (_, _, wqkv, bqkv, wo, bo, lns, lnb, wi, bi, wf, bf_) = \
        phase_text_kernels(device, g)
    out.update(text)
    out.update(phase_int8_text_blocks(device, g, (wqkv, bqkv, wo, bo, lns, lnb, wi, bi,
                                                  wf, bf_)))
    phase_dequant_epilogues(device, g)
    out["int8_gemm"] = phase_int8_gemm(device, g)

    # K3: beam self-attention partials, 8 heads, Lmax=181 -> K=724: B=8 (the
    # record) at three positions, pos 0 with every column masked; B=32 (the
    # serving batch); and K=4 (Lmax 1), fewer keys than the cluster's ranks
    heads, d = 8, 64
    hd = heads * d
    worst = 0.0
    for b, nb, lmax, positions in ((8, 4, 181, (0, 90, 180)), (32, 4, 181, (180,)),
                                   (4, 4, 1, (0,))):
        kk = nb * lmax
        q = randn(b, nb, hd, scale=0.5)
        kv = randn(b, kk, 2 * hd, scale=0.5)
        rel = torch.randn(heads, lmax, generator=g)
        for pos in positions:
            t = torch.arange(lmax)
            causal = torch.where(t <= pos, 0.0, -1e9)
            bias = (rel + causal).repeat_interleave(nb, dim=1)
            anc = torch.randint(0, nb, (b, nb, lmax), generator=g)
            anc = torch.where(t[None, None, :] == pos, -1, anc)  # own column dead
            live = anc[..., None] == torch.arange(nb)
            mask = torch.where(live.reshape(b, nb, kk), 0.0, -1e9)
            args = (q, kv, mask.to(device), bias.to(device))
            ranks = beam_attn.cluster_ranks(b * heads, kk, beam_attn.PARTIAL_FILL)
            label = f"K3 B={b} K={kk} pos={pos}"
            log(f"K3 beam_decode_attention_partial: B={b}, nb={nb}, K={kk}, pos={pos}, "
                f"{ranks} ranks" + (" (every column masked)" if pos == 0 else ""))
            acc, mm, ll = beam_attn.beam_decode_attention_partial(*args)
            acc_p, mm_p, ll_p = beam_attn.beam_decode_attention_partial_plain(*args)
            ctx = acc.reshape(b, nb, heads, d) / ll[..., None]
            ctx_p = acc_p.reshape(b, nb, heads, d) / ll_p[..., None]
            tol = dict(atol=K3_ATOL, rtol=K3_RTOL)
            err = max(compare(f"{label} acc", acc, acc_p, **tol),
                      compare(f"{label} ctx=acc/l", ctx, ctx_p, **tol))
            compare(f"{label} m", mm, mm_p, **tol)
            compare(f"{label} l", ll, ll_p, **tol)
            if b == 8:
                worst = max(worst, err)
        ms, pms = timed(f"K3 B={b} K={kk}",
                        lambda: beam_attn.beam_decode_attention_partial(*args),
                        lambda: beam_attn.beam_decode_attention_partial_plain(*args))
        gms = graph_ms(lambda: beam_attn.beam_decode_attention_partial(*args))
        nbytes = 2 * (b * nb * hd + b * kk * 2 * hd) + 4 * (b * nb * kk + heads * kk) \
            + 4 * (b * nb * hd + 2 * b * nb * heads)
        rec = (worst, ms, pms) + bound(nbytes, bf16_ops=2 * 2 * b * nb * kk * hd)
        log(f"  K3 B={b} K={kk} device time per call (CUDA graph of 20): {gms:.4f} ms; "
            f"bound {rec[3]:.4f} ms ({rec[4]}); {nbytes / gms / 1e6:.1f} GB/s")
        out.setdefault("beam_attn_partial", rec)

    # K4: cross-attention + FFN half-step at T5-small widths; N=32 rows (beam-4
    # at B=8) is the recorded site; N=16 and 128 are beam-4 at B=4 and 32,
    # N=4 and 64 greedy's rows at B=4 and 64, N=20 a ragged row tile
    dm, kc, dff = 512, 4, 2048
    splits = t5_step.split_counts(
        torch.cuda.get_device_properties(device).multi_processor_count, dm, dff)
    for n in (32, 4, 16, 20, 64, 128):
        enc_bias = torch.zeros(n, kc)
        enc_bias[::3, -1] = -1e9
        enc_bias[1] = -1e9  # a fully masked row
        t5_args = (randn(n, dm), 1.0 + randn(dm, scale=0.1, dtype=torch.float32),
                   randn(dm, dm, scale=dm ** -0.5), randn(dm, dm, scale=dm ** -0.5),
                   randn(n, kc, dm), randn(n, kc, dm), enc_bias.to(device),
                   1.0 + randn(dm, scale=0.1, dtype=torch.float32),
                   randn(dm, dff, scale=dm ** -0.5), randn(dff, dm, scale=dff ** -0.5))
        log(f"K4 cross_ffn_block: hidden [{n}, {dm}] bf16, K={kc}, d_ff={dff}, one row fully "
            f"masked; K-splits (wq, wo_c, wi, wo_f) {splits}")
        got = t5_step.cross_ffn_block(*t5_args, heads=heads)
        ref = t5_step.cross_ffn_block_plain(*t5_args, heads=heads)
        err = compare(f"K4 N={n}", got, ref)
        n_diff = int((got != ref).sum())
        log(f"  K4 N={n}: {n_diff} of {got.numel()} bf16 outputs ({n_diff / got.numel():.2%}) "
            f"differ from the plain version's bits")
        if not torch.equal(t5_step.cross_ffn_block(*t5_args, heads=heads), got):
            fail(f"K4 N={n}: two launches on the same inputs differ (split-K is not deterministic)")
        ms, pms = timed(f"K4 N={n}", lambda: t5_step.cross_ffn_block(*t5_args, heads=heads),
                        lambda: t5_step.cross_ffn_block_plain(*t5_args, heads=heads))
        gms = graph_ms(lambda: t5_step.cross_ffn_block(*t5_args, heads=heads))
        nbytes = 2 * (2 * n * dm + 2 * dm * dm + 2 * n * kc * dm + 2 * dm * dff) \
            + 4 * (2 * dm + n * kc)
        rec = (err, ms, pms) + bound(
            nbytes, bf16_ops=2 * n * (2 * dm * dm + 2 * dm * dff + 2 * kc * dm))
        log(f"  K4 N={n} device time per call (CUDA graph of 20): {gms:.4f} ms; "
            f"bound {rec[3]:.4f} ms ({rec[4]})")
        out.setdefault("t5_cross_ffn", rec)
    out.update(phase_decode_kernels(device, g))
    out.update(phase_route_kernels(device, g))
    torch.cuda.synchronize()
    return out


# K1 and K2 at the main path's rows: one request (B=1 L=32), a ragged row
# count (B=3 L=48, M=144), B=4 and B=32 at L=96, K1 at its longest L=128
# (B=4), K2 at long text's rows (M=16384, B=32 L=512); the record is B=32
# L=96, the classify batch of the kernel table
TEXT_SHAPES = ((1, 32, True), (3, 48, True), (4, 96, True), (4, 128, False),
               (32, 512, False), (32, 96, True))


def phase_text_kernels(device, g):
    """K1 and K2 against their plain versions at TEXT_SHAPES (K1 where L
    <= 128, K2 where the flag is set or L = 512): ATOL/RTOL and the share
    of bf16 outputs off the plain version's bits (TEXT_BITS_SHARE,
    TEXT_BITS_ULP); the time per call (CUDA events) and the device time per
    call (CUDA graph of 20) of each, the plain version's time, the bound;
    beside them the device time of the attention core alone (against its
    plain context) and of each of the four GEMM launches with
    ``torch.addmm(bias, a, b)`` on the same operands, the GEMM's yardstick.
    -> ({"bert_attn": record, "fused_ffn": record} at the last shape, the
    inputs at that shape for K6 / K7)."""
    import torch

    from mmdx_tpu_torch import _build
    from mmdx_tpu_torch.ops import bert_attn, fused_ffn, gemm

    bf = torch.bfloat16
    h, heads, f = 768, 12, 3072

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device=device, dtype=bf)

    wqkv, bqkv = randn(h, 3 * h, scale=h ** -0.5), randn(3 * h, scale=0.02)
    wo, bo = randn(h, h, scale=h ** -0.5), randn(h, scale=0.02)
    lns, lnb = 1.0 + randn(h, scale=0.1), randn(h, scale=0.1)
    wi, bi = randn(h, f, scale=h ** -0.5), randn(f, scale=0.02)
    wf, bf_ = randn(f, h, scale=f ** -0.5), randn(h, scale=0.02)
    out = {}
    for b, l, ffn_too in TEXT_SHAPES:
        m = b * l
        x = randn(m, h)
        lens = torch.randint(min(8, l), l + 1, (b,), generator=g)
        kmask = torch.where(torch.arange(l)[None, :] < lens[:, None], 0.0, -1e9)
        kmask = kmask.reshape(m).to(device=device, dtype=torch.float32)
        runs = []
        if l <= bert_attn.MAX_SEQ_LEN:
            kw = dict(seq_len=l, num_heads=heads, eps=1e-12)
            attn_args = (x, kmask, wqkv, bqkv, wo, bo, lns, lnb)
            nbytes = 2 * (2 * m * h + 4 * h * h + 3 * h + 3 * h) + 4 * m
            ops = 2 * m * h * 4 * h + 2 * 2 * b * heads * l * l * (h // heads)
            runs.append(("K1", "bert_attn", f"x [{m}, {h}] bf16 (B={b}, L={l}), {heads} heads",
                         lambda: bert_attn.fused_attention_block(*attn_args, **kw),
                         lambda: bert_attn.fused_attention_block_plain(*attn_args, **kw),
                         bound(nbytes, bf16_ops=ops)))
        if ffn_too or l > bert_attn.MAX_SEQ_LEN:
            ffn_args = (x, wi, bi, wf, bf_, lns, lnb)
            nbytes = 2 * (2 * m * h + 2 * h * f + f + 3 * h)
            runs.append(("K2", "fused_ffn", f"x [{m}, {h}] x [{h}, {f}] x [{f}, {h}] bf16",
                         lambda: fused_ffn.fused_ffn_ln(*ffn_args, eps=1e-12),
                         lambda: fused_ffn.fused_ffn_ln_plain(*ffn_args, eps=1e-12),
                         bound(nbytes, bf16_ops=2 * 2 * m * h * f)))
        for kname, name, what, kernel, plain, (bms, by) in runs:
            label = f"{kname} M={m} (B={b} L={l})"
            log(f"{kname} {'fused_attention_block' if kname == 'K1' else 'fused_ffn_ln'}: {what}")
            got, ref = kernel(), plain()
            err = compare(label, got, ref)
            compare_bits(label, got, ref, TEXT_BITS_SHARE, TEXT_BITS_ULP)
            ms, pms = median_ms(kernel), median_ms(plain)
            gms = graph_ms(kernel)
            log(f"  {label} kernel {ms:.4f} ms, device {gms:.4f} ms (CUDA graph of 20), plain "
                f"{pms:.4f} ms; bound {bms:.4f} ms ({by})")
            out[name] = (err, ms, pms, bms, by, None)
        if l <= bert_attn.MAX_SEQ_LEN:  # the attention core alone
            qkv = randn(m, 3 * h)
            ctx = bert_attn.attention_core(qkv, kmask, l, heads)
            compare(f"core B={b} L={l}", ctx,
                    bert_attn.attention_ctx_f32(qkv, kmask, l, heads).to(bf))
            qt = bert_attn.query_tile(b, l, heads, gemm.sms_of(qkv))
            log(f"  core B={b} L={l} ({qt}-row query tiles): device "
                f"{graph_ms(lambda: bert_attn.attention_core(qkv, kmask, l, heads)) * 1e3:.2f} us")
        products = (("attn_qkv", 3 * h, h, _build.EPI_BIAS_BF16),
                    ("attn_out", h, h, _build.EPI_BIAS_RESID_F32),
                    ("ffn_in", f, h, _build.EPI_BIAS_GELU_BF16),
                    ("ffn_out", h, f, _build.EPI_BIAS_RESID_F32))
        parts = []
        for pname, n, k, epi in products:  # each GEMM beside torch.addmm
            a, w, bias = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n, scale=0.02)
            resid = randn(m, n) if epi == _build.EPI_BIAS_RESID_F32 else None
            plan = gemm.gemm_plan(m, n, k, gemm.sms_of(a), split=resid is not None)
            if plan[3] > 1:  # split-K: f32 partials, bias and residual in the LayerNorm
                epi, bias, resid = _build.EPI_PARTIAL_F32, None, None
            y = torch.empty((plan[3], m, n) if plan[3] > 1 else (m, n), device=device,
                            dtype=bf if epi in (_build.EPI_BIAS_BF16, _build.EPI_BIAS_GELU_BF16)
                            else torch.float32)
            t = graph_ms(lambda: gemm.gemm(a, w, bias, resid, y, epi, plan, pname))
            lib = graph_ms(lambda: torch.addmm(bias if bias is not None else w[0], a, w))
            parts.append(f"{pname} [{m}x{k}]x[{k}x{n}] plan {plan}: {t * 1e3:.2f} us "
                         f"({2 * m * n * k / t / 1e9:.0f} TFLOP/s), addmm {lib * 1e3:.2f} us")
        log("  GEMM device time per launch (CUDA graph of 20): " + "; ".join(parts))
    return out, (x, kmask, wqkv, bqkv, wo, bo, lns, lnb, wi, bi, wf, bf_)


def near_tie(top2, tol_abs=DEC_TOL, tol_rel=DEC_TOL):
    """Where the best two of a set lie within the comparison tolerance (the
    selection may then go either way): top2 [..., 2], values descending."""
    return (top2[..., 0] - top2[..., 1]) <= tol_abs + tol_rel * top2[..., 0].abs()


def phase_decode_kernels(device, g) -> dict:
    """Rows 5 and 7 (the normalised cache reads, bf16 and int8) at greedy's
    B=4, nb=1 and beam's B=8, nb=4 (Lmax 181, 8 heads of 64), and at K=5
    and K=727 with a fully masked query row; rows 10 and 11 in
    ``phase_lm_head``. -> records of the beam shape (rows 5, 7) and of
    rows 10 and 11."""
    import torch
    import torch.nn.functional as F

    from mmdx_tpu_torch.ops import beam_attn

    out = {}
    heads, d = 8, 64
    hd = heads * d
    # greedy and beam at Lmax 181 (the records: beam's); then K = 5, fewer
    # keys than the cluster's 8 blocks, and K = 727, not a multiple of 8,
    # each with one query row whose every column is masked
    for b, nb, lmax in ((4, 1, 181), (8, 4, 181), (4, 1, 5), (2, 1, 727)):
        kk, pos = nb * lmax, lmax - 1
        masked_row = lmax != 181
        q = (torch.randn(b, nb, hd, generator=g) * 0.5).to(device, torch.bfloat16)
        kv32 = torch.randn(b, kk, 2 * hd, generator=g) * 0.5
        kv = kv32.to(device, torch.bfloat16)
        t = torch.arange(lmax)
        bias = (torch.randn(heads, lmax, generator=g) + torch.where(t <= pos, 0.0, -1e9))
        bias = bias.repeat_interleave(nb, dim=1).to(device)
        anc = torch.randint(0, nb, (b, nb, lmax), generator=g)
        anc = torch.where(t[None, None, :] == pos, torch.arange(nb)[None, :, None], anc)
        live = anc[..., None] == torch.arange(nb)
        mask = torch.where(live.reshape(b, nb, kk), 0.0, -1e9)
        if masked_row:
            mask[-1, 0] = -1e9
        mask = mask.to(device)
        kv8, kvs = beam_attn.quantize_kv_rows(kv32[..., :hd].to(device),
                                              kv32[..., hd:].to(device), heads)
        for name, fn, plain, args in (
                ("beam_attn", beam_attn.beam_decode_attention,
                 beam_attn.beam_decode_attention_plain, (q, kv, mask, bias)),
                ("beam_attn_int8", beam_attn.beam_decode_attention_int8,
                 beam_attn.beam_decode_attention_int8_plain, (q, kv8, kvs, mask, bias))):
            row = 5 if name == "beam_attn" else 7
            log(f"row {row} {fn.__name__}: B={b}, nb={nb}, K={kk}, {heads} heads"
                + (", one query row with every column masked" if masked_row else ""))
            got, ref = fn(*args), plain(*args)
            err = compare(f"row {row} B={b} nb={nb} K={kk}", got, ref)
            compare_bits(f"row {row} B={b} nb={nb} K={kk}", got, ref)
            ms, pms = median_ms(lambda: fn(*args)), median_ms(lambda: plain(*args))
            cache_bytes = b * kk * 2 * hd * (2 if row == 5 else 1) + \
                (b * 2 * heads * kk * 4 if row == 7 else 0)
            nbytes = cache_bytes + 2 * 2 * b * nb * hd + 4 * (b * nb * kk + heads * kk)
            bms, by = bound(nbytes, bf16_ops=2 * 2 * b * nb * kk * hd)
            lib_ms = None
            if row == 5:  # the library call of the same function, T5-unscaled
                qh = q.reshape(b, nb, heads, d).transpose(1, 2)
                kh = kv[..., :hd].reshape(b, kk, heads, d).transpose(1, 2)
                vh = kv[..., hd:].reshape(b, kk, heads, d).transpose(1, 2)
                am = (bias[None, :, None, :] + mask[:, None, :, :]).to(torch.bfloat16)
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=am, scale=1.0))
            log(f"  row {row} kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} (median of 30); "
                f"bound {bms:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s")
            gms = graph_ms(lambda: fn(*args))
            glib = None if lib_ms is None else graph_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=am, scale=1.0))
            log(f"  row {row} K={kk} device time per call (CUDA graph of 20): kernel "
                f"{gms:.4f} ms, library {'none' if glib is None else f'{glib:.4f} ms'}; "
                f"{nbytes / gms / 1e6:.1f} GB/s")
            if (b, nb) == (8, 4):
                out[name] = (err, ms, pms, bms, by, lib_ms)

    out.update(phase_lm_head(device, g))
    torch.cuda.synchronize()
    return out


# rows 10 and 11: hidden rows at the decode paths' N (greedy B=4 and B=64,
# beam-4 B=4, 32 and 64) and the edge N = 1; the records are N = 64 (row
# 10, greedy B=64) and N = 128 (row 11, beam-4 B=32)
LM_HEAD_ROWS = (1, 4, 16, 64, 128, 256)
LM_HEAD_RECORD = {"lm_head_greedy": 64, "lm_head_stats": 128}


def lm_head_check(name, hidden, emb, mask, label, exact=False) -> float:
    """Row 10 or 11 against its plain version on one input: cmax (and for
    row 11 the logits, m and L) to DEC_TOL; row 10's carg and selected
    token equal outside near-ties (everywhere with ``exact``: inputs whose
    logits are exact on both sides); row 11 bit-equal over two launches
    (the merge's fixed order). -> max abs error."""
    import torch

    from mmdx_tpu_torch.ops import lm_head

    fn, plain = getattr(lm_head, name), getattr(lm_head, name + "_plain")
    got, ref = fn(hidden, emb, mask), plain(hidden, emb, mask)
    n = hidden.shape[0]
    if name == "lm_head_stats":
        err = max(compare(f"row 11 {label} {k}", a, r, DEC_TOL, DEC_TOL)
                  for k, a, r in zip(("logits", "m", "L", "cmax"), got, ref))
        if not all(torch.equal(a, b) for a, b in zip(fn(hidden, emb, mask), got)):
            fail(f"row 11 {label}: two launches on the same inputs differ")
        log(f"  row 11 {label}: two launches bit-equal")
        return err
    err = compare(f"row 10 {label} cmax", got[0], ref[0], DEC_TOL, DEC_TOL)
    dense = lm_head.LazyLogits(hidden, emb).materialize().masked_fill(mask, float("-inf"))
    none = torch.zeros((), dtype=torch.bool, device=hidden.device)
    ties = none if exact else near_tie(dense.reshape(n, -1, 128).topk(2, dim=-1).values)
    bad = int(((got[1] != ref[1]) & ~ties).sum())
    best = got[0].argmax(-1)
    tok = best * 128 + got[1].gather(1, best[:, None])[:, 0]
    row_ties = none if exact else near_tie(dense.topk(2, dim=-1).values)
    bad_tok = int(((tok != dense.argmax(-1)) & ~row_ties).sum())
    log(f"  row 10 {label}: carg differs at {bad} chunks outside {int(ties.sum())} near-tie "
        f"chunks excluded; tokens differ in {bad_tok} rows outside {int(row_ties.sum())} "
        f"near-tie rows excluded")
    if bad or bad_tok:
        fail(f"row 10 {label}: carg or the selected token disagrees with the plain version")
    return err


def kernel_launches(fn, calls: int = 5) -> float:
    """CUDA kernels per call of ``fn``, as the profiler counts them over
    ``calls`` calls in one window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) / calls


def lm_head_inputs(device, g, n: int, v: int = 32128, dm: int = 512):
    """Row 10/11 inputs at N = n: hidden, and a mask with the eos column
    banned, one fully banned chunk and (N >= 4) one fully banned row."""
    import torch

    hidden = (torch.randn(n, dm, generator=g) * dm ** -0.5).to(device, torch.bfloat16)
    mask = (torch.rand(n, v, generator=g) < 0.001).to(device)
    mask[:, 1] = True  # the eos column, below min length
    mask[0, 128:256] = True  # a fully banned chunk
    if n >= 4:
        mask[-1] = True  # a fully banned row: cmax -inf, carg 0; m and L raw
    return hidden, mask


def lm_head_windows(device) -> None:
    """Rows 10 and 11 at N in LM_HEAD_ROWS: kernels a call as the profiler
    counts them, every window taken before any CUDA graph is captured in the
    process. After graphs are captured and replayed, about one short window
    in 150 to 500 loses its device records, all or part of them (an H100,
    ``scripts/profiler_windows.py``); before any graph, none of 320 did.
    Fails unless every window counts one kernel a call."""
    import torch

    from mmdx_tpu_torch.ops import lm_head

    g = torch.Generator().manual_seed(SEED + 4)
    emb = torch.randn(32128, 512, generator=g).to(device, torch.bfloat16)
    for n in LM_HEAD_ROWS:
        hidden, mask = lm_head_inputs(device, g, n)
        for name in ("lm_head_greedy", "lm_head_stats"):
            fn = getattr(lm_head, name)
            fn(hidden, emb, mask)
            launches = kernel_launches(lambda: fn(hidden, emb, mask))
            if launches != 1:
                fail(f"{name} N={n}: the profiler counts {launches:g} kernels per call, "
                     f"not 1")
    log(f"rows 10, 11: one kernel a call in each of {2 * len(LM_HEAD_ROWS)} profiler "
        f"windows (N = {', '.join(map(str, LM_HEAD_ROWS))})")


def phase_lm_head(device, g) -> dict:
    """Rows 10 and 11 (the streamed lm head, T5 vocabulary 32128 x 512) at
    N in LM_HEAD_ROWS, each with the eos column banned, one fully banned
    chunk and (N >= 4) one fully banned row (one kernel a call:
    ``lm_head_windows``, at the start of phase 2); then exact ties in and
    across chunks at N = 20 over a vocabulary of 2 chunks (small integers,
    so every logit is exact and equal logits tie exactly). -> the records at
    LM_HEAD_RECORD."""
    import torch

    from mmdx_tpu_torch.ops import lm_head

    out = {}
    v, dm = 32128, 512
    emb = torch.randn(v, dm, generator=g).to(device, torch.bfloat16)
    for n in LM_HEAD_ROWS:
        hidden, mask = lm_head_inputs(device, g, n, v, dm)
        for name in ("lm_head_greedy", "lm_head_stats"):
            row = 10 if name == "lm_head_greedy" else 11
            fn, plain = getattr(lm_head, name), getattr(lm_head, name + "_plain")
            plan = lm_head.lm_head_plan(n, v, dm)
            log(f"row {row} {name}: hidden [{n}, {dm}], emb [{v}, {dm}] bf16; plan {plan}")
            err = lm_head_check(name, hidden, emb, mask, f"N={n}")
            ms, pms = (median_ms(lambda: fn(hidden, emb, mask)),
                       median_ms(lambda: plain(hidden, emb, mask)))
            gms = graph_ms(lambda: fn(hidden, emb, mask))
            outb = 8 * n * (v // 128) if row == 10 else 4 * (n * v + 2 * n + n * (v // 128))
            nbytes = 2 * v * dm + 2 * n * dm + n * v + outb
            bms, by = bound(nbytes, bf16_ops=2 * n * v * dm)
            log(f"  {name} N={n}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms (median of 30); device {gms:.4f} ms (CUDA graph of 20, L2 "
                f"warm); bound {bms:.4f} ms ({by}); {nbytes / gms / 1e6:.1f} GB/s")
            if n == LM_HEAD_RECORD[name]:
                out[name] = (err, ms, pms, bms, by, None)
    n, d, v2 = 20, 64, 256
    gt = torch.Generator().manual_seed(SEED + 3)
    hidden = torch.randint(-2, 3, (n, d), generator=gt).to(device, torch.bfloat16)
    emb2 = torch.randint(-1, 2, (v2, d), generator=gt)
    emb2[150:160] = emb2[5]  # equal logits within and across chunks
    emb2[131] = emb2[129]
    emb2 = emb2.to(device, torch.bfloat16)
    mask = (torch.rand(n, v2, generator=gt) < 0.2).to(device)
    mask[2, 128:] = True
    mask[-1] = True
    log(f"rows 10, 11: exact ties, hidden [{n}, {d}] x emb [{v2}, {d}] small integers")
    lm_head_check("lm_head_greedy", hidden, emb2, mask, "ties", exact=True)
    lm_head_check("lm_head_stats", hidden, emb2, mask, "ties")
    return out


def ragged_height(b, w, cin, m, cout, es, proj) -> int:
    """A height near the stage's own whose last band the plan leaves
    ragged (H % TR != 0)."""
    from mmdx_tpu_torch.ops import bottleneck as bn

    for h in range(w + 2, w - 6, -1):
        if h % bn.tc_plan(b, h, w, cin, m, cout, es, proj).tr:
            return h
    fail(f"no ragged band height near {w}")


def row13_cases(ragged: bool = True) -> list:
    """(label, B, H, W, C, M): row 13 at both stages of the turbo route at
    B=32 (the first is the kernel's record) and B=4 (the engine), and a
    ragged last band at each stage."""
    cases = [(f"stage {s} B={b}", b, hw, hw, c, m)
             for b in (32, 4) for s, hw, c, m in ((1, 56, 256, 64), (2, 28, 512, 128))]
    for s, hw, c, m in ((1, 56, 256, 64), (2, 28, 512, 128)) if ragged else ():
        h = ragged_height(32, hw, c, m, c, 1, False)
        cases.append((f"stage {s} B=32 ragged H={h}", 32, h, hw, c, m))
    return cases


def row12_cases(ragged: bool = True) -> list:
    """(label, B, H, W, Cin, M, Cout, projection): row 12 at the three
    shapes of the fused tower (stage 1 block 0 with its projection, stage 1
    blocks 1-2, stage 2 blocks 1-3) at B=32 (the first is the kernel's
    record), two at B=4, and a ragged last band at each stage."""
    shapes = (("stage 1 block 0 (projection)", 56, 64, 64, 256, True),
              ("stage 1 identity", 56, 256, 64, 256, False),
              ("stage 2 identity", 28, 512, 128, 512, False))
    cases = [(f"{label} B=32", 32, hw, hw, cin, m, cout, proj)
             for label, hw, cin, m, cout, proj in shapes]
    cases += [(f"{label} B=4", 4, hw, hw, cin, m, cout, proj)
              for label, hw, cin, m, cout, proj in shapes[::2]]
    for label, hw, cin, m, cout, proj in shapes[::2] if ragged else ():
        h = ragged_height(32, hw, cin, m, cout, 2, proj)
        cases.append((f"{label} B=32 ragged H={h}", 32, h, hw, cin, m, cout, proj))
    return cases


def row13_operands(g, device, b, h, w, c, m):
    """Row 13's input and arguments from ``g``: s8 x, the weights as views
    of K-major storage (as the int8 tower's qparams hold them)."""
    import torch

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)

    def uniform(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(device)

    args = dict(w1=s8(m, c).t(), k1=uniform(m, 1e-4, 1e-3), b1=uniform(m, -2, 2),
                w2flat=s8(m, 9 * m).t(), k2=uniform(m, 1e-5, 1e-4), b2=uniform(m, -2, 2),
                w3=s8(c, m).t(), k3=uniform(c, 1e-4, 1e-3), b3=uniform(c, -2, 2), kx=0.7)
    return s8(b, h, w, c), args


def row12_operands(g, device, b, h, w, cin, m, cout, proj, dt):
    """Row 12's input and arguments from ``g`` in ``dt``: the weights as
    views of K-major storage (as ``Bottleneck.fused_operands`` lays them
    out in bf16), scaled by fan-in; f32 biases."""
    import torch

    def wk(n, k):
        return (torch.randn(n, k, generator=g) * k ** -0.5).to(device, dt)

    def vec(n):
        return (torch.randn(n, generator=g) * 0.1).to(device)

    x = torch.randn(b, h, w, cin, generator=g).to(device, dt)
    # w2: the HWIO view of [M, 9M] (ops/bottleneck.kmajor_hwio)
    args = dict(w1=wk(m, cin).t(), b1=vec(m), w2=wk(m, 9 * m).t().reshape(3, 3, m, m), b2=vec(m),
                w3=wk(cout, m).t(), b3=vec(cout))
    if proj:
        args.update(wp=wk(cout, cin).t(), bp=vec(cout))
    return x, args


def row13_work(b, h, w, c, m):
    """(bytes moved once, int8 operations) of one row-13 call."""
    px = b * h * w
    return (2 * px * c + 2 * c * m + 9 * m * m + 4 * (4 * m + 2 * c),
            2 * px * (2 * c * m + 9 * m * m))


def row12_work(b, h, w, cin, m, cout, proj, es):
    """(bytes moved once, operations) of one row-12 call in ``es``-byte
    elements."""
    px = b * h * w
    macs = cin * m + 9 * m * m + m * cout + (cin * cout if proj else 0)
    return es * px * (cin + cout) + es * macs + 4 * (2 * m + 2 * cout), 2 * px * macs


def phase_route_kernels(device, g) -> dict:
    """Row 9 (flash attention) at BERT-base widths, B=32 and B=4, L=512 and
    344, q/k/v read as head views of a merged projection, a key-mask bias,
    against scaled_dot_product_attention as the library call; row 13 (int8
    fused bottleneck) at ``row13_cases``, bit-equal; row 12 (bf16 and f32
    fused bottleneck) at ``row12_cases``, both with the device time from a
    CUDA graph of 20 calls beside the CUDA-event time; row 17 (fused
    preprocessing) at ``PRE_SHAPES`` (``phase_preprocess``). -> the record
    of the first shape of each."""
    import torch
    import torch.nn.functional as F

    from mmdx_tpu_torch.models.resnet_int8 import full_f32
    from mmdx_tpu_torch.ops import bottleneck as bn
    from mmdx_tpu_torch.ops import flash_attention as fa
    from mmdx_tpu_torch.ops import int8_bottleneck as ib

    bf = torch.bfloat16
    out = {}

    def record(name, rec, label):
        log(f"  {label} kernel {rec[1]:.4f} ms, plain {rec[2]:.4f} ms, library "
            f"{'none' if rec[5] is None else f'{rec[5]:.4f} ms'} (median of 30); "
            f"bound {rec[3]:.4f} ms ({rec[4]})")
        out.setdefault(name, rec)

    heads, d = 12, 64
    hd = heads * d
    # BERT's scale 1/8 on bf16 takes the tensor-core body; the f32 shape and
    # the bf16 one with a scale that is not a power of two (at the first
    # shape, so its time beside the tensor-core body's is the same work) hold
    # the CUDA-core body; the last shape holds the tensor-core body's bias
    # read per element, with a causal mask over the key mask as a full
    # [B, heads, L, L] bias
    for b, l, dt, scale, causal in (
            (32, 512, bf, d ** -0.5, False), (4, 512, bf, d ** -0.5, False),
            (32, 344, bf, d ** -0.5, False), (4, 344, bf, d ** -0.5, False),
            (4, 512, torch.float32, d ** -0.5, False), (32, 512, bf, 0.1, False),
            (4, 344, bf, d ** -0.5, True)):
        qkv = (torch.randn(b * l, 3 * hd, generator=g) * 0.5).to(device, dt)

        def split(i):  # [B, heads, L, d] views of the merged rows, as in BERT
            return qkv[:, i * hd:(i + 1) * hd].reshape(b, l, heads, d).permute(0, 2, 1, 3)

        q, k, v = split(0), split(1), split(2)
        lens = torch.randint(l // 4, l + 1, (b,), generator=g)
        bias = torch.where(torch.arange(l)[None, :] < lens[:, None], 0.0, -1e9)
        bias = bias.reshape(b, 1, 1, l)
        if causal:
            future = torch.arange(l)[None, :] > torch.arange(l)[:, None]
            bias = (bias + torch.where(future, -1e9, 0.0)).expand(b, heads, l, l)
        bias = bias.contiguous().to(device)
        body = "tensor-core" if fa.tensor_core_body(dt, scale) else "CUDA-core"
        mask_kind = "causal + key mask [B, heads, L, L]" if causal else "key mask"
        label = (f"row 9 B={b} L={l} {str(dt)[6:]} scale {scale:g}"
                 + (" causal" if causal else ""))
        log(f"row 9 flash_attention: B={b}, {heads} heads, L={l}, d={d} {str(dt)[6:]}, "
            f"scale {scale:g}, {mask_kind}: the {body} body")
        tc0, fma0 = fa.flash_attention.tc_launches, fa.flash_attention.fma_launches
        with full_f32():
            err = compare(label, fa.flash_attention(q, k, v, bias, scale),
                          fa.flash_attention_plain(q, k, v, bias, scale),
                          FLASH_ATOL, FLASH_RTOL)
            pms = median_ms(lambda: fa.flash_attention_plain(q, k, v, bias, scale))
        ran = ("tensor-core" if fa.flash_attention.tc_launches > tc0 else
               "CUDA-core" if fa.flash_attention.fma_launches > fma0 else "none")
        if ran != body:
            fail(f"{label}: expected the {body} body, the launch went to {ran}")
        ms = median_ms(lambda: fa.flash_attention(q, k, v, bias, scale))
        mask_lib = bias.to(dt)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask_lib, scale=scale))
        nbytes = 4 * b * heads * l * d * q.element_size() + 4 * bias.numel()
        ops = 2 * 2 * b * heads * l * l * d
        rec = (err, ms, pms) + (bound(nbytes, bf16_ops=ops) if dt == bf
                                else bound(nbytes, f32_ops=ops)) + (lib_ms,)
        gms = graph_ms(lambda: fa.flash_attention(q, k, v, bias, scale))
        glib = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask_lib, scale=scale))
        log(f"  {label}: ran the {ran} body; {ops / ms / 1e9:.1f} TFLOP/s achieved; device "
            f"time per call (CUDA graph of 20): kernel {gms:.4f} ms, library {glib:.4f} ms")
        record("flash_attention", rec, label)

    for label, b, h, w, c, m in row13_cases():
        x, args = row13_operands(g, device, b, h, w, c, m)
        plan = bn.tc_plan(b, h, w, c, m, c, 1, False)
        log(f"row 13 fused_bottleneck_int8: {label}, x [{b}, {h}, {w}, {c}] s8, M={m}; "
            f"plan {tuple(plan)}")
        err = compare_exact(f"row 13 {label}", ib.fused_bottleneck_int8(x, **args),
                            ib.fused_bottleneck_int8_plain(x, **args))
        ms = median_ms(lambda: ib.fused_bottleneck_int8(x, **args))
        pms = median_ms(lambda: ib.fused_bottleneck_int8_plain(x, **args))
        gms = graph_ms(lambda: ib.fused_bottleneck_int8(x, **args))
        nbytes, ops = row13_work(b, h, w, c, m)
        rec = (err, ms, pms) + bound(nbytes, int8_ops=ops) + (None,)
        log(f"  device time per call (CUDA graph of 20) {gms:.4f} ms: {ops / gms / 1e9:.1f} "
            f"TOP/s, {nbytes / gms / 1e6:.1f} GB/s, {rec[3] / gms:.1%} of the bound")
        record("int8_bottleneck", rec, f"row 13 {label}")

    for label, b, h, w, cin, m, cout, proj in row12_cases():
        for dt in (bf, torch.float32):
            x, args = row12_operands(g, device, b, h, w, cin, m, cout, proj, dt)
            name = f"row 12 {label} {str(dt)[6:]}"
            plan = bn.bottleneck_plan(b, h, w, cin, m, cout, dt, proj)
            log(f"row 12 fused_bottleneck: {label}, x [{b}, {h}, {w}, {cin}] {str(dt)[6:]}, "
                f"M={m}, Cout={cout}; plan {tuple(plan)}")
            with full_f32():
                err = compare(name, bn.fused_bottleneck(x, **args),
                              bn.fused_bottleneck_plain(x, **args))
                pms = median_ms(lambda: bn.fused_bottleneck_plain(x, **args))
            ms = median_ms(lambda: bn.fused_bottleneck(x, **args))
            gms = graph_ms(lambda: bn.fused_bottleneck(x, **args))
            nbytes, ops = row12_work(b, h, w, cin, m, cout, proj, x.element_size())
            rec = (err, ms, pms) + (bound(nbytes, bf16_ops=ops) if dt == bf
                                    else bound(nbytes, f32_ops=ops)) + (None,)
            log(f"  device time per call (CUDA graph of 20) {gms:.4f} ms: "
                f"{ops / gms / 1e9:.1f} TFLOP/s, {rec[3] / gms:.1%} of the bound")
            if dt == bf:
                record("bottleneck", rec, name)
            else:
                log(f"  {name} kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")

    out["preprocess"] = phase_preprocess(device, g)
    return out


def row17_work(b, h, w, c, out_bytes, crop=224):
    """(bytes, f32 operations) of row 17 on one batch: the input the
    function needs (the rows any kh row reads, over the columns any kw row
    reads) and the compact tap tables (a start and the taps of each row of
    kh and kw) read once, the output written once; two operations for each
    nonzero tap of the row pass over those columns and of the column pass
    (once per pixel for a 1-channel image), and the normalize's multiply
    and subtract per output. The kernel stages whole NHWC rows, so what it
    reads beyond those columns counts against it. From ``ops/resize.py``
    alone, so that it holds for any checkout."""
    from mmdx_tpu_torch.ops import resize as R

    kh, kw = R.fused_resize_crop_matrices(h, w, 256, crop)
    rows = int((kh != 0).any(axis=0).sum())
    cols = (kw != 0).any(axis=0).nonzero()[0]
    span = int(cols.max() - cols.min() + 1)
    taps = [int((k != 0).sum(axis=1).max()) for k in (kh, kw)]
    nbytes = b * rows * span * c + b * crop * crop * 3 * out_bytes + \
        4 * crop * (2 + sum(taps))
    fma = int((kh != 0).sum()) * span * c + crop * int((kw != 0).sum()) * c
    return nbytes, b * (2 * fma + 2 * crop * crop * 3)


def phase_preprocess(device, g):
    """Row 17 (``preprocess_batch_fused``) at ``PRE_SHAPES``, f32 and bf16
    out: one launch a call; held to its plain version (the dense f32
    matmuls, TF32 off), f32 within PRE_ATOL / PRE_RTOL, bf16 within
    PRE_ATOL + BF16_HALF_ULP of the plain f32 values and at most BITS_SHARE
    of its outputs one ulp off the plain version's bf16 bits; the kernel's
    time per call (CUDA events) and its device time from a CUDA graph of 20
    calls (its constants are cached on the device, so a graph can hold the
    call), the bound and its share, the plain version's time, and the
    engine's own route (``preprocess_batch_device``: two einsums and the
    normalize, not one call) in a CUDA graph beside it. -> the record of the
    first shape in f32."""
    import torch

    from mmdx_tpu_torch.models.resnet_int8 import full_f32
    from mmdx_tpu_torch.ops import preprocess as pp

    rec = None
    for b, h, w, c in PRE_SHAPES:
        plan = pp.preprocess_plan(b, h, w, c, 256, 224, 4)
        held = pp.blocks_per_sm(plan)
        log(f"row 17 plan at {pre_label(b, h, w, c)} f32: {plan}; an SM holds {held} "
            f"blocks (occupancy calculator)")
        if held < plan.blocks:
            fail(f"row 17: an SM holds {held} blocks, the plan sizes its grid for "
                 f"{plan.blocks}")
        batch = torch.randint(0, 256, (b, h, w, c), generator=g, dtype=torch.uint8).to(device)
        with full_f32():
            ref = pp.preprocess_batch_fused_plain(batch)
        for dt in (torch.float32, torch.bfloat16):
            label = f"row 17 {pre_label(b, h, w, c)} {str(dt)[6:]}"
            n0 = pp.preprocess_batch_fused.launches
            got = pp.preprocess_batch_fused(batch, out_dtype=dt)
            torch.cuda.synchronize()
            if pp.preprocess_batch_fused.launches != n0 + 1 or got.dtype != dt or \
                    got.shape != ref.shape:
                fail(f"{label}: expected one launch and a {dt} {tuple(ref.shape)} output, got "
                     f"{pp.preprocess_batch_fused.launches - n0} launches, {got.dtype} "
                     f"{tuple(got.shape)}")
            if dt == torch.float32:
                err = compare(label, got, ref, PRE_ATOL, PRE_RTOL)
            else:
                err = compare(f"{label} vs the plain f32 values", got, ref, PRE_ATOL,
                              BF16_HALF_ULP)
                compare_bits(f"{label} vs the plain bf16 output", got,
                             ref.to(torch.bfloat16), BITS_SHARE, 1)
            with full_f32():
                pms = median_ms(lambda: pp.preprocess_batch_fused_plain(batch, out_dtype=dt))
                route = graph_ms(lambda: pp.preprocess_batch_device(batch, out_dtype=dt))
            ms = median_ms(lambda: pp.preprocess_batch_fused(batch, out_dtype=dt))
            gms = graph_ms(lambda: pp.preprocess_batch_fused(batch, out_dtype=dt))
            nbytes, ops = row17_work(b, h, w, c, got.element_size())
            bms, by = bound(nbytes, f32_ops=ops)
            log(f"  {label}: kernel {ms:.4f} ms (CUDA events), device {gms:.4f} ms (CUDA "
                f"graph of 20), {nbytes / gms / 1e6:.1f} GB/s; bound {bms:.4f} ms ({by}), "
                f"{bms / gms:.1%} of it; plain {pms:.4f} ms; engine route "
                f"preprocess_batch_device {route:.4f} ms device (CUDA graph of 20)")
            if rec is None:
                rec = (err, ms, pms, bms, by, None)
    return rec


def int_mm_ms(x, w_t):
    """Device ms of ``torch._int_mm`` (cuBLASLt s8 -> s32) on ``x [M, K]``
    and the K-major ``w_t [N, K]``: the product alone, the int8 GEMM's
    yardstick (no epilogue; never on the main path); None where it refuses
    the shape."""
    import torch

    try:
        torch._int_mm(x, w_t.t())
        return graph_ms(lambda: torch._int_mm(x, w_t.t()))
    except RuntimeError:
        return None


def fmt_ms(t) -> str:
    return "n/a" if t is None else f"{t * 1e3:.2f} us"


# K5 at the int8 tower's shapes at B=32 (and the gray stem at B=512, the
# turbo headline batch): name, M, K (unpadded), N, epilogue, K of the
# second product
K5_SITES = (
    ("layer1 conv1 1x1 (ReLU)", 56 * 56 * 32, 256, 64, "relu", 0),
    ("layer1 conv2 3x3 im2col (ReLU)", 56 * 56 * 32, 9 * 64, 64, "relu", 0),
    ("gray stem 7x7 im2col, positional bias (ReLU)", 112 * 112 * 32, 49, 64, "relu_map", 0),
    ("gray stem at B=512, positional bias (ReLU)", 112 * 112 * 512, 49, 64, "relu_map", 0),
    ("RGB stem 7x7 im2col (ReLU)", 112 * 112 * 32, 147, 64, "relu", 0),
    ("layer4 conv2 3x3 im2col (ReLU)", 49 * 32, 9 * 512, 512, "relu", 0),
    ("layer4 shortcut 1x1 (no ReLU)", 49 * 32, 1024, 2048, "plain", 0),
    ("layer4 conv3 1x1 + residual (ReLU)", 49 * 32, 512, 2048, "res", 0),
    ("layer4 conv3 + shortcut, dual (ReLU)", 49 * 32, 512, 2048, "dual", 1024),
)


def k5_call(k5, epi, x, w, alpha, s8, scales, vec, k2=0, k_major=True, s_out=0.37):
    """(wrapper, plain version, arguments) of the K5 site with epilogue
    ``epi`` on ``x [M, K]`` and the weight ``w`` ([N, K], or [K, N] in a
    checkout older than the K-major layout: ``k_major=False``); the
    residual, the second product and the bias are drawn with ``s8``,
    ``scales``, ``vec`` (a [112 * 112, N] positional bias for "relu_map").
    ``relu`` is the wrappers' keyword: every epilogue but "plain" takes it
    True."""
    m, n = x.shape[0], alpha.shape[0]
    bias = vec(112 * 112, n) if epi == "relu_map" else vec(n)
    if epi == "res":
        return (k5.int8_gemm_res_requant, k5.int8_gemm_res_requant_plain,
                (x, w, alpha, bias, s8(m, n), 0.011, s_out))
    if epi == "dual":
        w2 = s8(n, k2) if k_major else s8(k2, n)
        return (k5.int8_gemm_dual_requant, k5.int8_gemm_dual_requant_plain,
                (x, w, alpha, bias, s8(m, k2), w2, scales(n), vec(n), s_out))
    return k5.int8_gemm_requant, k5.int8_gemm_requant_plain, (x, w, alpha, bias, s_out)


def phase_int8_gemm(device, g):
    """K5 at the int8 tower's shapes at B=32, each epilogue, and the gray stem
    at B=512 (the turbo headline batch: 50,176 row tiles), bit-equal to the
    plain version; per site the time per call (CUDA events), the device time
    per call (CUDA graph of 20), TOP/s and GB/s from it, and the device time
    of ``torch._int_mm`` on the same operands (the product alone). The
    weights are K-major [N, K], as the tower stores them; the stems' K is
    zero-padded to a multiple of 16, as the tower pads its weights and
    im2col columns. -> the record of the layer1 conv1 site."""
    import torch

    from mmdx_tpu_torch.ops import int8_gemm as k5

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)

    def scales(n, lo=1e-4, hi=1e-2):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(device)

    def vec(*shape):
        return torch.randn(*shape, generator=g).to(device)

    def padded(x, w):  # zero columns of x and of w [N, K] up to K % 16 == 0
        pad = -x.shape[1] % k5.K_ALIGN
        return (torch.cat([x, x.new_zeros((x.shape[0], pad))], 1),
                torch.cat([w, w.new_zeros((w.shape[0], pad))], 1))

    record = None
    for name, m, k, n, epi, k2 in K5_SITES:
        x, w, alpha = *padded(s8(m, k), s8(n, k)), scales(n)
        k = x.shape[1]
        fn, plain, args = k5_call(k5, epi, x, w, alpha, s8, scales, vec, k2)
        nbytes, ops = m * k + k * n + 4 * n + 4 * args[3].numel() + m * n, 2 * m * k * n
        relu = epi != "plain"
        if epi == "res":
            nbytes += m * n
        elif epi == "dual":
            nbytes += m * k2 + k2 * n + 8 * n
            ops += 2 * m * k2 * n
        plan = k5.int8_gemm_plan(m, n, k, k5.sms_of(x), k2)
        log(f"K5 {fn.__name__}: {name}: M={m}, K={k}{'+' + str(k2) if k2 else ''}, N={n}, "
            f"plan (bm, bn, stages) {plan}")
        err = compare_exact(f"K5 {name}", fn(*args, relu=relu), plain(*args, relu=relu))
        ms = median_ms(lambda: fn(*args, relu=relu))
        pms = median_ms(lambda: plain(*args, relu=relu))
        gms = graph_ms(lambda: fn(*args, relu=relu))
        lib = int_mm_ms(x, w)
        bms, by = bound(nbytes, int8_ops=ops)
        log(f"  K5 kernel {ms:.4f} ms, device {gms:.4f} ms (CUDA graph of 20), plain "
            f"{pms:.4f} ms; bound {bms:.4f} ms ({by}); achieved {ops / gms / 1e9:.1f} TOP/s, "
            f"{nbytes / gms / 1e6:.1f} GB/s; torch._int_mm (product alone) {fmt_ms(lib)}")
        if record is None:
            record = (err, ms, pms, bms, by)
    k5.reset_launches()
    return record


# the four text projections at BERT-base widths, each with its block's
# dequantizing epilogue: (name, N, K, epilogue)
TEXT_PROJECTIONS = (("attn_qkv", 2304, 768, "DQ_BF16"),
                    ("attn_out", 768, 768, "DQ_RESID_BIAS_F32"),
                    ("ffn_in", 3072, 768, "DQ_GELU_TANH_F32"),
                    ("ffn_out", 768, 3072, "DQ_BIAS_RESID_F32"))


def phase_dequant_epilogues(device, g) -> None:
    """Each of ``gemm_dequant``'s four epilogues at its text projection, at a
    ragged M = 144 and at the classify rows M = 3072, against the plain
    epilogue over ``exact_matmul_s8`` (``gemm_dequant_plain``): bit-equal,
    but tanh-GELU within ATOL/RTOL (tanhf is each library's own); the
    device time of each launch (CUDA graph of 20) beside ``torch._int_mm``
    on the same operands."""
    import torch

    from mmdx_tpu_torch import _build
    from mmdx_tpu_torch.ops import int8_gemm as k5

    for m in (144, 3072):
        parts = []
        for name, n, k, epi_name in TEXT_PROJECTIONS:
            epi = getattr(_build, epi_name)
            x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
            w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(device)
            rs = (1e-3 + 1e-2 * torch.rand(m, generator=g)).to(device)
            cs = (1e-4 + 1e-3 * torch.rand(n, generator=g)).to(device)
            bias = (torch.randn(n, generator=g) * 0.1).to(device, torch.bfloat16)
            resid = torch.randn(m, n, generator=g).to(device, torch.bfloat16)
            resid = None if epi in (_build.DQ_BF16, _build.DQ_GELU_TANH_F32) else resid
            out_dtype = torch.bfloat16 if epi == _build.DQ_BF16 else torch.float32
            args = (x, w, rs, cs, bias, resid, out_dtype, epi)
            got, ref = k5.gemm_dequant(*args), k5.gemm_dequant_plain(*args)
            label = f"gemm_dequant {epi_name} ({name}) M={m}"
            if epi == _build.DQ_GELU_TANH_F32:
                compare(label, got, ref)
                n_off = int((got != ref).sum())
                log(f"  {label}: {n_off} of {got.numel()} outputs ({n_off / got.numel():.4%}) "
                    f"off the plain bits (tanhf)")
            elif not torch.equal(got, ref):
                fail(f"{label}: {int((got != ref).sum())} outputs differ from the plain "
                     f"epilogue's bits")
            else:
                log(f"  {label}: bit-equal to the plain epilogue ({got.numel()} outputs)")
            t = graph_ms(lambda: k5.gemm_dequant(*args))
            parts.append(f"{name} [{m}x{k}]x[{k}x{n}] plan {k5.int8_gemm_plan(m, n, k)}: "
                         f"{t * 1e3:.2f} us ({2 * m * n * k / t / 1e9:.0f} TOP/s), "
                         f"torch._int_mm {fmt_ms(int_mm_ms(x, w))}")
        log(f"  int8 projections M={m}, device time per launch (CUDA graph of 20): "
            + "; ".join(parts))


# K6 and K7 at one request's rows of B=4 (M=384), the classify rows (B=32
# L=96, M=3072, the record) and M=16384 (K6 at long text's B=32 L=512, K7 at
# its longest L=128 with B=128)
INT8_TEXT_SHAPES = ((4, 96, 4, 96), (32, 96, 32, 96), (32, 512, 128, 128))


def phase_int8_text_blocks(device, g, weights) -> dict:
    """K6 and K7 at INT8_TEXT_SHAPES against their plain versions
    (ATOL/RTOL), the share of their bf16 outputs off the plain bits
    (informative: a tanhf or summation-order flip of one int8 intermediate
    moves its whole row), the time per call, the device time per call (CUDA
    graph of 20) and the plain version's time. -> records at M = 3072."""
    import torch

    from mmdx_tpu_torch.ops import bert_attn, fused_ffn

    bf = torch.bfloat16
    wqkv, bqkv, wo, bo, lns, lnb, wi, bi, wf, bf_ = weights
    h, heads, f = 768, 12, 3072
    wqkv_q, wo_q = fused_ffn.quant_weight_cols(wqkv), fused_ffn.quant_weight_cols(wo)
    wi_q, wf_q = fused_ffn.quant_weight_cols(wi), fused_ffn.quant_weight_cols(wf)
    out = {}
    for fb, fl, ab, al in INT8_TEXT_SHAPES:
        runs = []
        m = fb * fl
        x = torch.randn(m, h, generator=g).to(device, bf)
        ffn8 = (x, *wi_q, bi, *wf_q, bf_, lns, lnb)
        nbytes = 2 * 2 * m * h + 2 * h * f + 4 * (f + h) + 2 * (f + 3 * h)
        runs.append(("K6", "fused_ffn_int8", f"fused_ffn_ln_int8 x [{m}, {h}] (B={fb} L={fl})",
                     lambda: fused_ffn.fused_ffn_ln_int8(*ffn8, eps=1e-12),
                     lambda: fused_ffn.fused_ffn_ln_int8_plain(*ffn8, eps=1e-12),
                     bound(nbytes, int8_ops=2 * 2 * m * h * f)))
        ma = ab * al
        xa = x if ma == m else torch.randn(ma, h, generator=g).to(device, bf)
        lens = torch.randint(min(8, al), al + 1, (ab,), generator=g)
        kmask = torch.where(torch.arange(al)[None, :] < lens[:, None], 0.0, -1e9)
        kmask = kmask.reshape(ma).to(device=device, dtype=torch.float32)
        kw = dict(seq_len=al, num_heads=heads, eps=1e-12)
        attn8 = (xa, kmask, *wqkv_q, bqkv, *wo_q, bo, lns, lnb)
        nbytes = 2 * 2 * ma * h + 4 * h * h + 4 * 4 * h + 2 * (3 * h + 3 * h) + 4 * ma
        runs.append(("K7", "bert_attn_int8",
                     f"fused_attention_block_int8 x [{ma}, {h}] (B={ab} L={al})",
                     lambda: bert_attn.fused_attention_block_int8(*attn8, **kw),
                     lambda: bert_attn.fused_attention_block_int8_plain(*attn8, **kw),
                     bound(nbytes, int8_ops=2 * ma * h * 4 * h,
                           bf16_ops=2 * 2 * ab * heads * al * al * (h // heads))))
        for kname, name, what, kernel, plain, (bms, by) in runs:
            log(f"{kname} {what}, int8 weights")
            got, ref = kernel(), plain()
            mm = got.shape[0]
            err = compare(f"{kname} M={mm}", got, ref)
            n_off = int((got != ref).sum())
            ms, pms, gms = median_ms(kernel), median_ms(plain), graph_ms(kernel)
            log(f"  {kname} M={mm}: {n_off} of {got.numel()} bf16 outputs "
                f"({n_off / got.numel():.3%}) off the plain bits; kernel {ms:.4f} ms, device "
                f"{gms:.4f} ms (CUDA graph of 20), plain {pms:.4f} ms; bound {bms:.4f} ms ({by})")
            if mm == 3072:
                out[name] = (err, ms, pms, bms, by, None)
    return out


def launch_counters() -> dict:
    """name -> (read the kernel's launch count, set it to 0)."""
    from mmdx_tpu_torch.ops import (beam_attn, bert_attn, bottleneck, flash_attention,
                                    fused_ffn, int8_bottleneck, int8_gemm, lm_head,
                                    preprocess, t5_step)

    wrappers = {
        "bert_attn": bert_attn.fused_attention_block,
        "fused_ffn": fused_ffn.fused_ffn_ln,
        "beam_attn_partial": beam_attn.beam_decode_attention_partial,
        "t5_cross_ffn": t5_step.cross_ffn_block,
        "fused_ffn_int8": fused_ffn.fused_ffn_ln_int8,
        "bert_attn_int8": bert_attn.fused_attention_block_int8,
        "beam_attn": beam_attn.beam_decode_attention,
        "beam_attn_int8": beam_attn.beam_decode_attention_int8,
        "lm_head_greedy": lm_head.lm_head_greedy,
        "lm_head_stats": lm_head.lm_head_stats,
        "flash_attention": flash_attention.flash_attention,
        "int8_bottleneck": int8_bottleneck.fused_bottleneck_int8,
        "bottleneck": bottleneck.fused_bottleneck,
        "preprocess": preprocess.preprocess_batch_fused,
    }
    counters = {k: (lambda fn=fn: fn.launches, lambda fn=fn: setattr(fn, "launches", 0))
                for k, fn in wrappers.items()}
    counters["int8_gemm"] = (int8_gemm.launches, int8_gemm.reset_launches)
    return counters


def reset_counts(counters) -> None:
    for _, reset in counters.values():
        reset()


def read_counts(counters) -> dict:
    return {k: read() for k, (read, _) in counters.items()}


TEXTS = [
    "62 year old male, productive cough and fever for 3 days, smoker",
    "45F, sharp left-sided chest pain after a fall, no fever",
    "follow-up after pneumonia, shortness of breath on exertion, on 2L O2",
    "routine pre-operative film, no complaints",
]


def report_lengths(ids, eos: int) -> list[int]:
    """Generated tokens per row (eos included), after the start token."""
    out = []
    for row in ids[:, 1:]:
        hit = [i for i, t in enumerate(row.tolist()) if t == eos]
        out.append(hit[0] + 1 if hit else len(row))
    return out


def check_probs(name: str, probs) -> None:
    import numpy as np

    if probs.shape[-1] != 13 or not np.isfinite(probs).all() or \
            probs.min() < 0.0 or probs.max() > 1.0:
        fail(f"{name}: expected 13 finite probabilities in [0, 1], got {probs}")


def check_reports(name: str, ids, gen) -> list[int]:
    lens = report_lengths(ids, gen.eos_token_id)
    if not all(gen.min_new_tokens <= n <= gen.max_new_tokens for n in lens):
        fail(f"{name}: report lengths {lens} outside "
             f"{gen.min_new_tokens}-{gen.max_new_tokens}")
    return lens


DECODE_KERNELS = ("beam_attn_partial", "beam_attn", "beam_attn_int8",
                  "lm_head_greedy", "lm_head_stats")


def check_decode_counts(name, launches, dec_layers, min_steps, read="beam_attn_partial",
                        head=None) -> int:
    """The decode kernels of one route: ``read`` and K4 at ``dec_layers``
    per step, the lm-head kernel ``head`` (if any) at one per step, every
    other decode kernel at 0, over at least ``min_steps`` steps. -> steps."""
    steps = launches[read] // dec_layers
    others = [k for k in DECODE_KERNELS if k not in (read, head) and launches[k]]
    if (launches[read] != launches["t5_cross_ffn"] or launches[read] % dec_layers
            or steps < min_steps or others
            or (head is not None and launches[head] != steps)):
        fail(f"{name} decode kernels: expected {dec_layers} launches per step each of "
             f"{read} and K4{f', 1 of {head}' if head else ''} over >= {min_steps} "
             f"steps and none of {others}, got {launches}")
    return steps


def first_differences(ids, ref) -> list:
    """Per row, the first position where two id arrays differ, or None."""
    import numpy as np

    return [int(d[0]) if d.size else None
            for d in (np.nonzero(a != b)[0] for a, b in zip(ids, ref))]


def synced(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def phase_fast(device, bundle, images, counters):
    import numpy as np

    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    config = bundle.config
    gen = config.generation
    fast = InferenceEngine(bundle, mode="fast", device=device)
    reset_counts(counters)
    out, ms = synced(lambda: fast.infer(images[0], TEXTS[0]))
    after_infer = read_counts(counters)
    check_probs("infer", np.asarray(list(out["disease_probs"].values()), np.float32))
    log(f"  fast infer (1 image + beam-4 report): {ms:.1f} ms, "
        f"report {len(out['report_text'])} chars, launches {after_infer}")
    (probs, z_img, z_txt), cms = synced(lambda: fast.classify_batch(images, TEXTS))
    ids, gms = synced(lambda: fast.generate_report_ids(z_img, z_txt))
    launches = read_counts(counters)
    reports = fast.t5_tok.batch_decode(ids, skip_special_tokens=True)
    check_probs("classify_batch", probs)
    lens = check_reports("fast", ids, gen)
    log(f"  fast classify_batch B=4 (512x512x3 uint8): {cms:.1f} ms; "
        f"generate B=4: {gms:.1f} ms; report tokens {lens}; "
        f"report chars {[len(r) for r in reports]}")
    log(f"  fast launches over infer + batch: {launches}")
    layers = config.text.num_layers
    if launches["bert_attn"] != 2 * layers or launches["fused_ffn"] != 2 * layers or \
            any(launches[k] for k in ("int8_gemm", "fused_ffn_int8", "bert_attn_int8")):
        fail(f"fast text-tower kernels: expected {2 * layers} launches each of K1, K2 "
             f"({layers} per classify) and none of K5-K7, got {launches}")
    dec_layers = config.report.num_decoder_layers
    steps = check_decode_counts("fast", launches, dec_layers, 2 * gen.min_new_tokens)
    log(f"  fast launch counts as expected: {layers} per classify (K1, K2), "
        f"{dec_layers} per decode step over {steps} steps (K3, K4)")

    parity = InferenceEngine(bundle, mode="parity", device=device)
    (pprobs, pz_img, pz_txt), pcms = synced(lambda: parity.classify_batch(images, TEXTS))
    pids, pgms = synced(lambda: parity.generate_report_ids(pz_img, pz_txt))
    check_probs("parity classify_batch", pprobs)
    log(f"  parity classify_batch {pcms:.1f} ms, generate {pgms:.1f} ms; "
        f"max |prob fast - parity| = {float(np.abs(probs - pprobs).max()):.4f}; "
        f"first differing token position per report (None = identical): "
        f"{first_differences(ids, pids)}")
    single = phase_single_modality(fast, parity, images, counters)
    del parity
    for k, n in single.items():
        launches[k] += n
    return launches, fast, probs, (z_img, z_txt)


def phase_single_modality(fast, parity, images, counters) -> dict:
    """``classify_image_batch`` and ``classify_text_batch`` (the warm-up
    heads, BASELINE configs 1-2) in fast mode at B=4: [4, 13] probabilities
    in [0, 1], within 0.1 of the parity engine's (the fast-vs-parity bar),
    K1 and K2 once per BERT layer each in the text call and no kernel in
    the image call (fast mode's image tower is cuDNN). -> launches."""
    import numpy as np

    layers = fast.bundle.config.text.num_layers
    total = {}
    for name, call, expect in (
            ("classify_image_batch", lambda e: e.classify_image_batch(images), {}),
            ("classify_text_batch", lambda e: e.classify_text_batch(TEXTS),
             {"bert_attn": layers, "fused_ffn": layers})):
        reset_counts(counters)
        probs, ms = synced(lambda: call(fast))
        launches = read_counts(counters)
        ref = call(parity)
        if probs.shape != (4, 13):
            fail(f"fast {name}: expected [4, 13] probabilities, got {probs.shape}")
        check_probs(f"fast {name}", probs)
        gap = float(np.abs(probs - ref).max())
        log(f"  fast {name} B=4: {ms:.1f} ms; max |prob fast - parity| = {gap:.4f} (bar 0.1); "
            f"launches {dict((k, n) for k, n in launches.items() if n)}")
        if gap > 0.1:
            fail(f"fast {name}: probabilities differ from parity by {gap:.4f}")
        if {k: n for k, n in launches.items() if n} != expect:
            fail(f"fast {name}: expected launches {expect}, got {launches}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


# the texts of tests/test_native_wordpiece.py and tests/test_native_unigram.py
WORDPIECE_TEXTS = [
    "31 year old male PA view , smoking history of 40 pack years, hypertension",
    "78 year old female PA view , low grade fever, cough, shortness of breath",
    "67M, smoker; dyspnea; CHF history.",
    "",
    "UNKNOWNWORDXYZQ!! multiple   spaces",
    "Patient presente une toux naive cafe",
    "Présente une toux naïve café",
]
UNIGRAM_TEXTS = [
    "",
    "No acute cardiopulmonary abnormality.",
    "Heart size is within normal limits, lungs are clear.",
    "62 year old male PA view, smoking history of 30 pack years",
    "bilateral pleural effusions with atelectasis???",
    "UPPER Case And MiXeD   whitespace\t\ttabs",
    "unicode: café naïve — em-dash … ellipsis ΩΩΩ",
    "q%$#@!* zz xqj zzz",
    "a" * 300,
]


def phase_front_end(engine, bundle, images, device) -> None:
    """The request's host front end: the C++ cores of mmdx_tpu_torch/native
    built from the checkout's sources and in use (the engine's tokenizers
    report native_available, its front_end log says native for all three
    stages, wire_image_u8 resizes through the core); native and Python
    outputs identical on the native tests' texts and on 512x512 RGB and
    gray resizes (also against PIL and ops/resize.resize_u8_exact); the
    host time to tokenize B=32 long texts at max_len 512, native against
    Python; the reference-compatible inference() on the card."""
    import numpy as np
    from PIL import Image

    from mmdx_tpu_torch import native
    from mmdx_tpu_torch.io.images import wire_image_u8
    from mmdx_tpu_torch.ops.resize import resize_u8_exact
    from mmdx_tpu_torch.pipelines.inference_pipeline import clear_model_bundle, inference
    from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer
    from mmdx_tpu_torch.text.wordpiece import WordPieceTokenizer

    if not native.available():
        fail(f"the host cores (mmdx_tpu_torch/native) did not build: {native.build_error()}")
    log(f"  host cores built from mmdx_tpu_torch/native -> {native.library_path().name}")
    want = {"wordpiece": "native", "unigram": "native", "resize": "native"}
    bert, t5 = engine.bert_tok, engine.t5_tok
    if engine.front_end != want or not getattr(bert, "native_available", False) or \
            not getattr(t5, "native_available", False):
        fail(f"front end: expected every stage native, the engine reports {engine.front_end}")
    py_bert = WordPieceTokenizer(vocab=bundle.bert_vocab)
    py_t5 = T5StyleTokenizer(vocab=bundle.t5_vocab, scores=bundle.t5_scores)
    for text in WORDPIECE_TEXTS:
        if bert.encode(text, 96) != py_bert.encode(text, 96):
            fail(f"native WordPiece differs from Python on {text!r}")
    a, b = bert.encode_batch(WORDPIECE_TEXTS, 64), py_bert.encode_batch(WORDPIECE_TEXTS, 64)
    for t in UNIGRAM_TEXTS:
        if t5.encode(t) != py_t5.encode(t) or \
                t5.encode(t, max_length=16) != py_t5.encode(t, max_length=16):
            fail(f"native unigram differs from Python on {t!r}")
    c, d = t5.encode_batch(UNIGRAM_TEXTS, max_length=32), py_t5.encode_batch(
        UNIGRAM_TEXTS, max_length=32)
    if any(not np.array_equal(x[k], y[k]) for x, y in ((a, b), (c, d))
           for k in ("input_ids", "attention_mask")):
        fail("native and Python tokenizers' batches differ")
    log(f"  WordPiece ({len(WORDPIECE_TEXTS)} texts) and unigram ({len(UNIGRAM_TEXTS)} texts): "
        f"native identical to Python")
    rng = np.random.default_rng(SEED + 2)
    for shape in ((512, 512, 3), (512, 512)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        calls = native.resize_u8.calls
        wired = wire_image_u8(img, 256)
        if native.resize_u8.calls != calls + 1:
            fail(f"wire_image_u8 {shape}: the native resize did not answer")
        pil = np.asarray(Image.fromarray(img).resize((256, 256), Image.BILINEAR), np.uint8)
        if not (np.array_equal(wired, pil)
                and np.array_equal(wired, resize_u8_exact(img, 256, 256))):
            fail(f"native resize {shape} -> 256x256 differs from PIL or resize_u8_exact")
    log("  wire_image_u8 512x512 RGB and gray -> 256x256 through the native resize, "
        "bit-equal to PIL and resize_u8_exact")
    words = " ".join(TEXTS + WORDPIECE_TEXTS[:6] + UNIGRAM_TEXTS[1:6]).split()
    texts = [" ".join(rng.choice(words, 300 + 4 * i)) for i in range(32)]
    t0 = time.perf_counter()
    nat = bert.encode_batch(texts, 512)
    t_nat = (time.perf_counter() - t0) * 1e3
    py_bert._wordpiece_cached.cache_clear()
    t0 = time.perf_counter()
    py = py_bert.encode_batch(texts, 512)
    t_cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py_bert.encode_batch(texts, 512)
    t_warm = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(nat["input_ids"], py["input_ids"]):
        fail("native and Python WordPiece differ on the long texts")
    log(f"  host tokenize B=32 at max_len 512 ({int(nat['attention_mask'].sum())} tokens): "
        f"native {t_nat:.2f} ms, Python {t_cold:.2f} ms (word cache cold), "
        f"{t_warm:.2f} ms (warm)")
    out, ms = synced(lambda: inference(bundle, images[0], TEXTS[0], device=device))
    clear_model_bundle()
    if set(out) != {"report_text", "disease_probs", "disease_vector", "model_version"}:
        fail(f"inference(): unexpected keys {sorted(out)}")
    check_probs("inference()", np.asarray(list(out["disease_probs"].values()), np.float32))
    log(f"  inference() (parity engine, beam-4): {ms:.1f} ms, report "
        f"{len(out['report_text'])} chars")


def phase_turbo(device, bundle, images, counters, fast, fast_probs):
    import numpy as np

    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    config = bundle.config
    gen = config.generation
    gray = [np.ascontiguousarray(im[:, :, 0]) for im in images]
    turbo = InferenceEngine(bundle, mode="turbo", device=device)
    if not turbo.text_int8:
        fail("turbo engine built without the W8A8 text blocks (MMDX_TEXT_INT8=0 set?)")
    reset_counts(counters)
    out, ms = synced(lambda: turbo.infer(gray[0], TEXTS[0]))
    check_probs("turbo infer", np.asarray(list(out["disease_probs"].values()), np.float32))
    log(f"  turbo infer (1 gray 512x512 image + beam-4 report): {ms:.1f} ms, of it "
        f"the first-batch calibration + quantization {turbo.calibration_ms:.1f} ms; "
        f"report {len(out['report_text'])} chars")
    results = {}
    for name, imgs in (("gray", gray), ("RGB", images)):
        (probs, z_img, z_txt), cms = synced(lambda: turbo.classify_batch(imgs, TEXTS))
        ids, gms = synced(lambda: turbo.generate_report_ids(z_img, z_txt))
        check_probs(f"turbo classify_batch {name}", probs)
        lens = check_reports(f"turbo {name}", ids, gen)
        log(f"  turbo classify_batch B=4 {name} 512x512 uint8: {cms:.1f} ms; "
            f"generate B=4: {gms:.1f} ms; report tokens {lens}")
        results[name] = probs
    launches = read_counts(counters)
    log(f"  turbo launches over infer + 2 batches: {launches}")
    layers, classifies = config.text.num_layers, 3
    if launches["int8_gemm"] != 53 * classifies:
        fail(f"int8 tower: expected 53 K5 launches per classify ({53 * classifies}), "
             f"got {launches['int8_gemm']}")
    if launches["fused_ffn_int8"] != layers * classifies or \
            launches["bert_attn_int8"] != layers * classifies or \
            launches["bert_attn"] or launches["fused_ffn"]:
        fail(f"turbo text tower: expected {layers * classifies} launches each of K6, K7 "
             f"and none of K1, K2, got {launches}")
    dec_layers = config.report.num_decoder_layers
    steps = check_decode_counts("turbo", launches, dec_layers, 2 * gen.min_new_tokens)
    log(f"  turbo launch counts as expected: 53 per classify (K5), {layers} per "
        f"classify (K6, K7), {dec_layers} per decode step over {steps} steps (K3, K4)")
    fast_gray, _, _ = fast.classify_batch(gray, TEXTS)
    gaps = {"RGB": float(np.abs(results["RGB"] - fast_probs).max()),
            "gray": float(np.abs(results["gray"] - fast_gray).max())}
    log(f"  max |prob turbo - fast|: RGB {gaps['RGB']:.4f}, gray {gaps['gray']:.4f} "
        f"(bar 0.05, the JAX package's turbo guard)")
    if max(gaps.values()) > TURBO_GAP:
        fail(f"turbo probabilities differ from fast mode's by more than {TURBO_GAP}: {gaps}")
    return launches, turbo


def engine_with(bundle, device, env: dict, mode: str = "fast"):
    """An engine built with the switches ``env`` set (the engine reads them
    once, at construction)."""
    import os

    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return InferenceEngine(bundle, mode=mode, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def phase_decode_variants(device, bundle, fast, z4, counters):
    """Greedy and the decode-layer switches at full width, each run with the
    launch counts set to 0 before it and read after it: fast greedy at B=4
    and B=64 (row 5 and K4 at 6 per step), fast beam-4 with MMDX_DEFER_KV=0
    (row 5, no K3), and one engine with MMDX_KV_INT8=1 MMDX_FUSED_LM_HEAD=1:
    beam-4 (row 7, row 11 at 1 per step) and greedy (row 7, row 10); and an
    MMDX_FUSED_LM_HEAD=1 engine's greedy (row 5, row 10), whose ids against
    the dense greedy's are informative. -> summed launches."""
    import numpy as np

    config = bundle.config
    gen, layers = config.generation, config.report.num_decoder_layers
    z_img, z_txt = z4
    z64 = tuple(np.repeat(np.asarray(z.float().cpu()), 16, axis=0) for z in z4)
    total = {}
    ids_of = {}

    def run(name, engine, greedy, z, read, head=None):
        reset_counts(counters)
        ids, ms = synced(lambda: engine.generate_report_ids(*z, greedy=greedy))
        launches = read_counts(counters)
        lens = check_reports(name, ids, gen)
        steps = check_decode_counts(name, launches, layers, gen.min_new_tokens, read, head)
        log(f"  {name}: B={ids.shape[0]} {ms:.1f} ms, {steps} steps, report tokens "
            f"{sorted(set(lens))}, launches {launches}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        ids_of[name] = ids

    run("fast greedy B=4", fast, True, (z_img, z_txt), "beam_attn")
    run("fast greedy B=64", fast, True, z64, "beam_attn")
    nodefer = engine_with(bundle, device, {"MMDX_DEFER_KV": "0"})
    run("beam-4 MMDX_DEFER_KV=0", nodefer, False, (z_img, z_txt), "beam_attn")
    del nodefer
    q8 = engine_with(bundle, device, {"MMDX_KV_INT8": "1", "MMDX_FUSED_LM_HEAD": "1"})
    if not (q8.kv_int8 and q8.fused_lm_head):
        fail("MMDX_KV_INT8=1 MMDX_FUSED_LM_HEAD=1 did not reach the engine")
    run("beam-4 int8 KV + fused lm head", q8, False, (z_img, z_txt), "beam_attn_int8",
        "lm_head_stats")
    run("greedy int8 KV + fused lm head", q8, True, (z_img, z_txt), "beam_attn_int8",
        "lm_head_greedy")
    del q8
    fused = engine_with(bundle, device, {"MMDX_FUSED_LM_HEAD": "1"})
    run("greedy fused lm head B=4", fused, True, (z_img, z_txt), "beam_attn",
        "lm_head_greedy")
    del fused
    diverge = first_differences(ids_of["greedy fused lm head B=4"], ids_of["fast greedy B=4"])
    log(f"  fused-lm-head greedy vs dense greedy, B=4: first differing token position "
        f"per report (None = identical): {diverge} (informative)")
    return total


def long_text(n_words: int) -> str:
    """A patient history of ``n_words`` one-wordpiece words."""
    words = ["cough", "fever", "dyspnea", "effusion", "opacity", "chest", "pain", "left"]
    return " ".join(words[i % len(words)] for i in range(n_words))


def phase_long_text(device, bundle, images, counters) -> dict:
    """Long text at BERT-base's own limit (max_len 512, the buckets 176, 256,
    344): fast classify_batch B=4 in the 344 and 512 buckets runs flash
    attention in all 12 layers and no fused attention block (K1), and in the
    176 bucket neither (the einsum route); the 512-bucket probabilities
    against the parity engine's (the fast-vs-parity bar 0.1). -> launches."""
    import dataclasses

    import numpy as np

    from mmdx_tpu_torch.runtime.engine import InferenceEngine, bucket_ladder

    config = bundle.config
    long_cfg = dataclasses.replace(config, text=dataclasses.replace(config.text, max_len=512))
    lb = dataclasses.replace(bundle, config=long_cfg)
    layers = config.text.num_layers
    if bucket_ladder(512) != (176, 256, 344):
        fail(f"bucket_ladder(512) = {bucket_ladder(512)}, expected (176, 256, 344)")
    fast = InferenceEngine(lb, mode="fast", device=device)
    total = {}
    for n_words, bucket in ((300, 344), (450, 512), (100, 176)):
        texts = [long_text(n_words)] + TEXTS[1:]
        if fast.prep_texts(texts)["input_ids"].shape[1] != bucket:
            fail(f"long text of {n_words} words did not land in the {bucket} bucket")
        reset_counts(counters)
        (probs, _, _), ms = synced(lambda: fast.classify_batch(images, texts))
        launches = read_counts(counters)
        check_probs(f"long text L={bucket}", probs)
        flash = layers if bucket >= 256 else 0
        if launches["flash_attention"] != flash or launches["bert_attn"] or \
                launches["fused_ffn"] != layers:
            fail(f"long text L={bucket}: expected {flash} flash attention, 0 K1 and "
                 f"{layers} K2 launches per classify, got {launches}")
        log(f"  fast classify_batch B=4, L={bucket}: {ms:.1f} ms; launches: flash "
            f"{launches['flash_attention']}, K1 {launches['bert_attn']}, K2 "
            f"{launches['fused_ffn']}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        if bucket == 512:
            del fast
            parity = InferenceEngine(lb, mode="parity", device=device)
            ref, _, _ = parity.classify_batch(images, texts)
            del parity
            gap = float(np.abs(probs - ref).max())
            log(f"  L=512 max |prob fast - parity| = {gap:.4f} (bar 0.1)")
            if gap > 0.1:
                fail(f"long text: fast (flash) and parity differ by {gap:.4f} > 0.1")
            fast = InferenceEngine(lb, mode="fast", device=device)
    return total


def phase_contracts(device) -> None:
    """Launch or raise, at construction: an engine built on the card in fast
    or turbo mode from the narrow test configuration (16-wide heads) is
    refused when it is built, naming the text encoder, K1 and the mode or
    switch; a CPU engine on the same bundle builds and answers."""
    import numpy as np

    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    narrow = bridge.bundle_from_variables(bridge.random_state(cfg, SEED), cfg)
    for mode, switch in (("fast", "fast mode"), ("turbo", "MMDX_TEXT_INT8")):
        try:
            InferenceEngine(narrow, mode=mode, device=device)
        except ValueError as err:
            msg = str(err)
            if not all(w in msg for w in ("text encoder", "K1", switch)):
                fail(f"contracts: the {mode} engine's refusal does not name the layer, K1 "
                     f"and {switch!r}: {msg}")
            log(f"  {mode} engine on the card from 16-wide heads refused at construction: "
                f"{msg[:160]}...")
            continue
        fail(f"contracts: a {mode} engine on the card from 16-wide heads was built")
    cpu = InferenceEngine(narrow, mode="fast", device="cpu")
    img = np.random.default_rng(SEED).integers(0, 256, (70, 70, 3), dtype=np.uint8)
    probs, _, _ = cpu.classify_batch([img], TEXTS[:1])
    check_probs("contracts: CPU engine from 16-wide heads", probs)
    log("  the same bundle on the CPU: engine built, 13 finite probabilities")


def phase_fused_blocks(device, bundle, images, counters, turbo) -> dict:
    """The fused-block routes at full width: a turbo engine with
    MMDX_INT8_FUSED_BLOCKS=1,2 on the unfused turbo engine's int8 tower (5
    row-13 launches and 38 K5 per classify, probabilities within the turbo
    guard 0.05 of the unfused engine's); the fused preprocessing (row 17) of
    the RGB and gray batches beside the matmul preprocessing; the bf16 image
    tower with use_fused_bottleneck (6 row-12 launches) against the cuDNN
    tower of the fast engine. -> launches."""
    import dataclasses

    import numpy as np
    import torch

    from mmdx_tpu_torch.models.layers import cast_
    from mmdx_tpu_torch.models.resnet import ImageEncoder
    from mmdx_tpu_torch.ops.preprocess import (preprocess_batch_device,
                                               preprocess_batch_fused)

    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    gray = [np.ascontiguousarray(im[:, :, 0]) for im in images]
    fused = engine_with(bundle, device, {"MMDX_INT8_FUSED_BLOCKS": "1,2"}, mode="turbo")
    if fused.int8_fused_blocks != (1, 2):
        fail(f"MMDX_INT8_FUSED_BLOCKS=1,2 did not reach the engine: {fused.int8_fused_blocks}")
    fused._qparams = turbo._qparams  # the same calibrated int8 tower
    for name, imgs in (("gray", gray), ("RGB", images)):
        ref, _, _ = turbo.classify_batch(imgs, TEXTS)
        reset_counts(counters)
        (probs, _, _), ms = synced(lambda: fused.classify_batch(imgs, TEXTS))
        launches = read_counts(counters)
        check_probs(f"turbo fused blocks {name}", probs)
        gap = float(np.abs(probs - ref).max())
        log(f"  turbo MMDX_INT8_FUSED_BLOCKS=1,2 classify_batch B=4 {name}: {ms:.1f} ms; "
            f"launches: row 13 {launches['int8_bottleneck']}, K5 {launches['int8_gemm']}; "
            f"max |prob fused - unfused| = {gap:.4f} (bar 0.05)")
        if launches["int8_bottleneck"] != 5 or launches["int8_gemm"] != 38:
            fail(f"turbo fused blocks: expected 5 row-13 and 38 K5 launches per classify, "
                 f"got {launches}")
        if gap > 0.05:
            fail(f"turbo fused blocks: probabilities differ from the unfused tower by {gap:.4f}")
        add(launches)
    del fused

    cfg = bundle.config.image
    encoders = []
    for c in (dataclasses.replace(cfg, use_fused_bottleneck=True), cfg):
        e = ImageEncoder(c)
        e.load_state_dict(bundle.model.image_encoder.state_dict())
        encoders.append(cast_(e, torch.bfloat16).to(device).eval())
    enc, ref_enc = encoders  # the fused tower, the cuDNN tower
    for name, imgs in (("RGB", images), ("gray", gray)):
        batch = torch.from_numpy(np.stack(imgs)).to(device)
        if batch.dim() == 3:
            batch = batch[..., None]
        reset_counts(counters)
        x, ms = synced(lambda: preprocess_batch_fused(batch, cfg.img_size, cfg.resize_size,
                                                      cfg.mean, cfg.std))
        launches = read_counts(counters)
        with torch.inference_mode():
            ref = preprocess_batch_device(batch, cfg.img_size, cfg.resize_size, cfg.mean,
                                          cfg.std)
        compare(f"fused vs matmul preprocessing ({name}, B=4)", x, ref, PRE_ATOL, PRE_RTOL)
        if launches["preprocess"] != 1:
            fail(f"fused preprocessing: expected 1 row-17 launch, got {launches}")
        log(f"  fused preprocessing B=4 {name}: {ms:.2f} ms")
        add(launches)
        if name != "RGB":
            continue
        xb = x.to(torch.bfloat16)
        reset_counts(counters)
        with torch.inference_mode():
            z, ms = synced(lambda: enc.encode(xb))
            launches = read_counts(counters)
            z_ref = ref_enc.encode(xb)
        z, z_ref = z.float(), z_ref.float()
        rel = float((z - z_ref).norm() / z_ref.norm())
        if z.shape != (4, cfg.d_img) or not torch.isfinite(z).all():
            fail(f"fused bf16 tower: expected finite [4, {cfg.d_img}], got {tuple(z.shape)}")
        log(f"  fused bf16 image tower B=4 at {cfg.img_size}: {ms:.1f} ms; row 12 launches "
            f"{launches['bottleneck']}; rel-L2 vs the cuDNN tower {rel:.4f} (bar 0.05)")
        if launches["bottleneck"] != 6:
            fail(f"fused bf16 tower: expected 6 row-12 launches, got {launches}")
        if rel > 0.05:
            fail(f"fused bf16 tower: embeddings differ from the cuDNN tower by {rel:.4f}")
        add(launches)
    return total


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def phase_server(bundle, device, mode: str, n: int, gray: bool,
                 greedy: bool = False) -> None:
    import io

    import numpy as np
    from PIL import Image

    from mmdx_tpu_torch.config import DISEASES
    from mmdx_tpu_torch.serve.wsgi import make_app

    app = make_app(bundle=bundle, engine_mode=mode, generate_reports=True,
                   greedy=greedy, device=device)
    label = f"{mode}{' greedy' if greedy else ''}"
    rng = np.random.default_rng(SEED + 1)
    buf = io.BytesIO()
    shape = (600, 480) if gray else (600, 480, 3)
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(buf, "PNG")
    boundary = b"chipsmokeboundary"
    try:
        for i, text in enumerate(TEXTS[:n]):
            body = b"\r\n".join([
                b"--" + boundary,
                b'Content-Disposition: form-data; name="patient_details"', b"",
                text.encode(),
                b"--" + boundary,
                b'Content-Disposition: form-data; name="image"; filename="x.png"',
                b"Content-Type: image/png", b"", buf.getvalue(),
                b"--" + boundary + b"--"])
            status = {}
            environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/api/predict/",
                       "CONTENT_TYPE": "multipart/form-data; boundary=" + boundary.decode(),
                       "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
            t0 = time.perf_counter()
            raw = b"".join(app(environ, lambda s, h: status.setdefault("s", s)))
            ms = (time.perf_counter() - t0) * 1e3
            payload = json.loads(raw)
            if not status["s"].startswith("200") or \
                    [d["name"] for d in payload.get("diseases", [])] != DISEASES or \
                    not isinstance(payload.get("report_text"), str):
                fail(f"/api/predict/ ({label}) answered {status['s']}: {raw[:300]!r}")
            log(f"  /api/predict/ {label} #{i}: 200 in {ms:.1f} ms, 13 diseases, "
                f"report {len(payload['report_text'])} chars")
    finally:
        if app._batcher is not None:
            app._batcher.stop(drain=True)


def main() -> int:
    if not (ROOT / "mmdx_tpu_torch" / "csrc").is_dir():
        fail("mmdx_tpu_torch/csrc not found next to chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    card = phase_card_and_build()
    device = torch.device("cuda", 0)
    kernel_stats = phase_kernels(device)
    if sys.argv[1:] == ["--kernels"]:
        log("kernel checks passed (phases 1-2 only)")
        return 0

    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.config import DiagnosisConfig

    config = DiagnosisConfig()  # full width: ResNet-50, BERT-base, T5-small
    gen = config.generation
    t0 = time.perf_counter()
    bundle = bridge.bundle_from_variables(bridge.random_state(config, SEED), config)
    log(f"main path: random full-width weights (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in bundle.model.parameters()) / 1e6:.1f} M parameters; "
        f"beam {gen.num_beams}, {gen.min_new_tokens}-{gen.max_new_tokens} new tokens")
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
    log("contracts: the kernels' widths checked at engine construction")
    phase_contracts(device)
    counters = launch_counters()
    log("fast path")
    fast_launches, fast, fast_probs, z4 = phase_fast(device, bundle, images, counters)
    log("front end: the C++ host cores, the tokenizers and the wire resize")
    phase_front_end(fast, bundle, images, device)
    log("turbo path")
    turbo_launches, turbo = phase_turbo(device, bundle, images, counters, fast, fast_probs)
    log("decode variants: greedy and the decode-layer switches")
    variant_launches = phase_decode_variants(device, bundle, fast, z4, counters)
    del fast
    log("long text: max_len 512, flash attention")
    long_launches = phase_long_text(device, bundle, images, counters)
    log("fused blocks: int8 and bf16 fused bottlenecks, fused preprocessing")
    fused_launches = phase_fused_blocks(device, bundle, images, counters, turbo)
    del turbo
    runs = (fast_launches, turbo_launches, variant_launches, long_launches, fused_launches)
    idle = [name for name in KERNELS if not sum(run.get(name, 0) for run in runs)]
    if idle:
        fail(f"kernels never launched on the main paths: {idle}")
    log("server: /api/predict/ through mmdx_tpu_torch.serve.wsgi")
    phase_server(bundle, device, "fast", 3, gray=False)
    phase_server(bundle, device, "turbo", 2, gray=True)
    phase_server(bundle, device, "fast", 1, gray=False, greedy=True)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": sum(run.get(name, 0) for run in runs),
         "max_abs_err": rec[0], "ms": rec[1], "plain_ms": rec[2], "bound_ms": rec[3],
         "bound_by": rec[4], "library_ms": rec[5] if len(rec) > 5 else None}
        for name, rec in ((name, kernel_stats[name]) for name in KERNELS)
    ]}
    log(f"card: {card}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
