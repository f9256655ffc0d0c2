"""Smoke run of the PyTorch port (mmdx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases (any failure exits nonzero):
  1. card and build: the card's name and power limit, torch/CUDA/nvcc
     versions, and the time to build the hand-written kernels from
     mmdx_tpu_torch/csrc with nvcc for sm_90a (one nvcc per source, in
     parallel);
  2. each kernel against its plain PyTorch version on the same inputs at
     serving shapes: max abs/rel error against the stated tolerance (the int8
     GEMM K5 bit for bit), the median time of each over 30 runs (CUDA
     events), and the least time the card could take for the same work;
  3. the main paths at full width (ResNet-50 at 224, BERT-base, fusion 1024,
     T5-small decoder under beam-4, 150-180 new tokens) from random weights
     made from a seed, each with the launch counts set to 0 just before it
     and read just after:
       fast: engine.infer on one image, classify_batch + generate on a batch
       of 4; the same batch in parity mode for comparison;
       turbo: the int8 image tower and the W8A8 text blocks, calibrating on
       its first batch: infer on a gray image, classify_batch on 4 gray and
       on 4 RGB images, generate for both; the turbo-vs-fast gap;
  4. /api/predict/ through the port's WSGI app, in process: fast mode, then
     turbo mode with a gray PNG upload.

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
# K1, K2, K4, K6, K7 end in bf16 outputs of magnitude up to a few units: a
# few bf16 ulps (the Pallas bf16 tests use 3e-2 and 4e-2,
# tests/test_pallas_beam_attn.py:45, tests/test_pallas_t5_step.py:47)
ATOL = RTOL = 4e-2
# K3's acc, m and l are f32 sums over the same bf16 products as its plain
# version, so they agree to f32 summation order, far inside this bound
K3_ATOL, K3_RTOL = 1e-4, 1e-3
# published dense peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
PEAK_BF16, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12

KERNELS = {  # name: (source, TPU kernel it replaces: file:line of pallas_call)
    "bert_attn": ("mmdx_tpu_torch/csrc/bert_attn.cu",
                  "mmdx_tpu/ops/pallas_bert_attn.py:200"),
    "fused_ffn": ("mmdx_tpu_torch/csrc/gemm.cu",
                  "mmdx_tpu/ops/pallas_ffn.py:191"),
    "beam_attn_partial": ("mmdx_tpu_torch/csrc/beam_attn.cu",
                          "mmdx_tpu/ops/pallas_beam_attn.py:220"),
    "t5_cross_ffn": ("mmdx_tpu_torch/csrc/t5_cross_attn.cu",
                     "mmdx_tpu/ops/pallas_t5_step.py:106"),
    "int8_gemm": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                  "mmdx_tpu/ops/pallas_int8_gemm.py:119"),
    "fused_ffn_int8": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                       "mmdx_tpu/ops/pallas_ffn.py:136"),
    "bert_attn_int8": ("mmdx_tpu_torch/csrc/int8_gemm.cu",
                       "mmdx_tpu/ops/pallas_bert_attn.py:177"),
}


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


def bound(nbytes: float, int8_ops: float = 0.0, bf16_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, ref, atol: float = ATOL, rtol: float = RTOL) -> float:
    """Print the max abs and rel error of ``got`` against ``ref``; fail
    unless every element is within atol + rtol * |ref|. -> max abs error."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    diff = (got - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tol=atol {atol} + rtol {rtol}*|ref| -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


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

    from mmdx_tpu_torch.ops import beam_attn, bert_attn, fused_ffn, t5_step

    g = torch.Generator(device="cpu").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(device=device, dtype=dtype)

    def timed(name, kernel, plain):
        ms, pms = median_ms(kernel), median_ms(plain)
        log(f"  {name} kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")
        return ms, pms

    out = {}

    # K1 / K2: BERT-base layer at B=32, L=96
    b, l, h, heads, f = 32, 96, 768, 12, 3072
    m = b * l
    x = randn(m, h)
    lens = torch.randint(8, l + 1, (b,), generator=g)
    kmask = torch.where(torch.arange(l)[None, :] < lens[:, None], 0.0, -1e9)
    kmask = kmask.reshape(m).to(device=device, dtype=torch.float32)
    wqkv, bqkv = randn(h, 3 * h, scale=h ** -0.5), randn(3 * h, scale=0.02)
    wo, bo = randn(h, h, scale=h ** -0.5), randn(h, scale=0.02)
    lns, lnb = 1.0 + randn(h, scale=0.1), randn(h, scale=0.1)
    attn_args = (x, kmask, wqkv, bqkv, wo, bo, lns, lnb)
    kw = dict(seq_len=l, num_heads=heads, eps=1e-12)
    attn_ops = 2 * 2 * b * heads * l * l * (h // heads)  # scores + context
    log(f"K1 fused_attention_block: x [{m}, {h}] bf16 (B={b}, L={l}), {heads} heads")
    err = compare("K1", bert_attn.fused_attention_block(*attn_args, **kw),
                  bert_attn.fused_attention_block_plain(*attn_args, **kw))
    ms, pms = timed("K1", lambda: bert_attn.fused_attention_block(*attn_args, **kw),
                    lambda: bert_attn.fused_attention_block_plain(*attn_args, **kw))
    nbytes = 2 * (2 * m * h + 4 * h * h + 3 * h + 3 * h) + 4 * m
    out["bert_attn"] = (err, ms, pms) + bound(
        nbytes, bf16_ops=2 * m * h * 4 * h + attn_ops)

    wi, bi = randn(h, f, scale=h ** -0.5), randn(f, scale=0.02)
    wf, bf_ = randn(f, h, scale=f ** -0.5), randn(h, scale=0.02)
    ffn_args = (x, wi, bi, wf, bf_, lns, lnb)
    log(f"K2 fused_ffn_ln: x [{m}, {h}] x [{h}, {f}] x [{f}, {h}] bf16")
    err = compare("K2", fused_ffn.fused_ffn_ln(*ffn_args, eps=1e-12),
                  fused_ffn.fused_ffn_ln_plain(*ffn_args, eps=1e-12))
    ms, pms = timed("K2", lambda: fused_ffn.fused_ffn_ln(*ffn_args, eps=1e-12),
                    lambda: fused_ffn.fused_ffn_ln_plain(*ffn_args, eps=1e-12))
    nbytes = 2 * (2 * m * h + 2 * h * f + f + 3 * h)
    out["fused_ffn"] = (err, ms, pms) + bound(nbytes, bf16_ops=2 * 2 * m * h * f)

    # K6 / K7: the W8A8 forms at the same shapes, weights quantized once
    wqkv_q, wo_q = fused_ffn.quant_weight_cols(wqkv), fused_ffn.quant_weight_cols(wo)
    wi_q, wf_q = fused_ffn.quant_weight_cols(wi), fused_ffn.quant_weight_cols(wf)
    attn8 = (x, kmask, *wqkv_q, bqkv, *wo_q, bo, lns, lnb)
    log(f"K7 fused_attention_block_int8: x [{m}, {h}] bf16, int8 weights")
    err = compare("K7", bert_attn.fused_attention_block_int8(*attn8, **kw),
                  bert_attn.fused_attention_block_int8_plain(*attn8, **kw))
    ms, pms = timed("K7", lambda: bert_attn.fused_attention_block_int8(*attn8, **kw),
                    lambda: bert_attn.fused_attention_block_int8_plain(*attn8, **kw))
    nbytes = 2 * 2 * m * h + 4 * h * h + 4 * 4 * h + 2 * (3 * h + 3 * h) + 4 * m
    out["bert_attn_int8"] = (err, ms, pms) + bound(
        nbytes, int8_ops=2 * m * h * 4 * h, bf16_ops=attn_ops)

    ffn8 = (x, *wi_q, bi, *wf_q, bf_, lns, lnb)
    log(f"K6 fused_ffn_ln_int8: x [{m}, {h}] x [{h}, {f}] x [{f}, {h}], int8 weights")
    err = compare("K6", fused_ffn.fused_ffn_ln_int8(*ffn8, eps=1e-12),
                  fused_ffn.fused_ffn_ln_int8_plain(*ffn8, eps=1e-12))
    ms, pms = timed("K6", lambda: fused_ffn.fused_ffn_ln_int8(*ffn8, eps=1e-12),
                    lambda: fused_ffn.fused_ffn_ln_int8_plain(*ffn8, eps=1e-12))
    nbytes = 2 * 2 * m * h + 2 * h * f + 4 * (f + h) + 2 * (f + 3 * h)
    out["fused_ffn_int8"] = (err, ms, pms) + bound(nbytes, int8_ops=2 * 2 * m * h * f)

    out["int8_gemm"] = phase_int8_gemm(device, g)

    # K3: beam self-attention partials, B=8, nb=4, Lmax=181 -> K=724, 8 heads
    b, nb, lmax, heads, d = 8, 4, 181, 8, 64
    kk, hd = nb * lmax, heads * d
    q = randn(b, nb, hd, scale=0.5)
    kv = randn(b, kk, 2 * hd, scale=0.5)
    rel = torch.randn(heads, lmax, generator=g)
    worst = 0.0
    for pos in (0, lmax // 2, lmax - 1):
        t = torch.arange(lmax)
        causal = torch.where(t <= pos, 0.0, -1e9)
        bias = (rel + causal).repeat_interleave(nb, dim=1)
        anc = torch.randint(0, nb, (b, nb, lmax), generator=g)
        anc = torch.where(t[None, None, :] == pos, -1, anc)  # own column dead
        live = anc[..., None] == torch.arange(nb)
        mask = torch.where(live.reshape(b, nb, kk), 0.0, -1e9)
        args = (q, kv, mask.to(device), bias.to(device))
        log(f"K3 beam_decode_attention_partial: B={b}, nb={nb}, K={kk}, pos={pos}"
            + (" (every column masked)" if pos == 0 else ""))
        acc, mm, ll = beam_attn.beam_decode_attention_partial(*args)
        acc_p, mm_p, ll_p = beam_attn.beam_decode_attention_partial_plain(*args)
        ctx = acc.reshape(b, nb, heads, d) / ll[..., None]
        ctx_p = acc_p.reshape(b, nb, heads, d) / ll_p[..., None]
        tol = dict(atol=K3_ATOL, rtol=K3_RTOL)
        worst = max(worst, compare(f"K3 pos={pos} acc", acc, acc_p, **tol),
                    compare(f"K3 pos={pos} ctx=acc/l", ctx, ctx_p, **tol))
        compare(f"K3 pos={pos} m", mm, mm_p, **tol)
        compare(f"K3 pos={pos} l", ll, ll_p, **tol)
    ms, pms = timed(f"K3 (pos={pos})",
                    lambda: beam_attn.beam_decode_attention_partial(*args),
                    lambda: beam_attn.beam_decode_attention_partial_plain(*args))
    nbytes = 2 * (b * nb * hd + b * kk * 2 * hd) + 4 * (b * nb * kk + heads * kk) \
        + 4 * (b * nb * hd + 2 * b * nb * heads)
    out["beam_attn_partial"] = (worst, ms, pms) + bound(
        nbytes, bf16_ops=2 * 2 * b * nb * kk * hd)

    # K4: cross-attention + FFN half-step, N=32 rows, T5-small widths
    n, dm, kc, dff, heads = 32, 512, 4, 2048, 8
    enc_bias = torch.zeros(n, kc)
    enc_bias[::3, -1] = -1e9
    t5_args = (randn(n, dm), 1.0 + randn(dm, scale=0.1, dtype=torch.float32),
               randn(dm, dm, scale=dm ** -0.5), randn(dm, dm, scale=dm ** -0.5),
               randn(n, kc, dm), randn(n, kc, dm), enc_bias.to(device),
               1.0 + randn(dm, scale=0.1, dtype=torch.float32),
               randn(dm, dff, scale=dm ** -0.5), randn(dff, dm, scale=dff ** -0.5))
    log(f"K4 cross_ffn_block: hidden [{n}, {dm}] bf16, K={kc}, d_ff={dff}")
    err = compare("K4", t5_step.cross_ffn_block(*t5_args, heads=heads),
                  t5_step.cross_ffn_block_plain(*t5_args, heads=heads))
    ms, pms = timed("K4", lambda: t5_step.cross_ffn_block(*t5_args, heads=heads),
                    lambda: t5_step.cross_ffn_block_plain(*t5_args, heads=heads))
    nbytes = 2 * (2 * n * dm + 2 * dm * dm + 2 * n * kc * dm + 2 * dm * dff) \
        + 4 * (2 * dm + n * kc)
    out["t5_cross_ffn"] = (err, ms, pms) + bound(
        nbytes, bf16_ops=2 * n * (2 * dm * dm + 2 * dm * dff + 2 * kc * dm))
    torch.cuda.synchronize()
    return out


def phase_int8_gemm(device, g):
    """K5 at the int8 tower's shapes at B=32, each epilogue, and the gray stem
    at B=512 (the turbo headline batch: 100,352 row tiles), bit-equal to the
    plain version. The stems' K is zero-padded to a multiple of 16, as the
    tower pads its weights and im2col columns. -> the record of the layer1
    conv1 site."""
    import torch

    from mmdx_tpu_torch.ops import int8_gemm as k5

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)

    def scales(n, lo=1e-4, hi=1e-2):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(device)

    def vec(*shape):
        return torch.randn(*shape, generator=g).to(device)

    def padded(x, w):  # zero columns of x, zero rows of w up to K % 16 == 0
        pad = -x.shape[1] % k5.K_ALIGN
        return (torch.cat([x, x.new_zeros((x.shape[0], pad))], 1),
                torch.cat([w, w.new_zeros((pad, w.shape[1]))], 0))

    b = 32
    sites = [  # name, M, K, N, epilogue, K of the second product
        ("layer1 conv1 1x1 (ReLU)", 56 * 56 * b, 256, 64, "relu", 0),
        ("layer1 conv2 3x3 im2col (ReLU)", 56 * 56 * b, 9 * 64, 64, "relu", 0),
        ("gray stem 7x7 im2col, positional bias (ReLU)", 112 * 112 * b, 49, 64,
         "relu_map", 0),
        ("gray stem at B=512, positional bias (ReLU)", 112 * 112 * 512, 49, 64,
         "relu_map", 0),
        ("RGB stem 7x7 im2col (ReLU)", 112 * 112 * b, 147, 64, "relu", 0),
        ("layer4 shortcut 1x1 (no ReLU)", 49 * b, 1024, 2048, "plain", 0),
        ("layer4 conv3 1x1 + residual (ReLU)", 49 * b, 512, 2048, "res", 0),
        ("layer4 conv3 + shortcut, dual (ReLU)", 49 * b, 512, 2048, "dual", 1024),
    ]
    record = None
    for name, m, k, n, epi, k2 in sites:
        x, w, alpha = *padded(s8(m, k), s8(k, n)), scales(n)
        k = x.shape[1]
        bias = vec(112 * 112, n) if epi == "relu_map" else vec(n)
        relu, s_out = epi != "plain", 0.37
        nbytes, ops = m * k + k * n + 4 * n + 4 * bias.numel() + m * n, 2 * m * k * n
        if epi == "res":
            args = (x, w, alpha, bias, s8(m, n), 0.011, s_out)
            fn, plain = k5.int8_gemm_res_requant, k5.int8_gemm_res_requant_plain
            nbytes += m * n
        elif epi == "dual":
            args = (x, w, alpha, bias, s8(m, k2), s8(k2, n), scales(n), vec(n), s_out)
            fn, plain = k5.int8_gemm_dual_requant, k5.int8_gemm_dual_requant_plain
            nbytes += m * k2 + k2 * n + 8 * n
            ops += 2 * m * k2 * n
        else:
            args = (x, w, alpha, bias, s_out)
            fn, plain = k5.int8_gemm_requant, k5.int8_gemm_requant_plain
        log(f"K5 {fn.__name__}: {name}: M={m}, K={k}{'+' + str(k2) if k2 else ''}, N={n}")
        err = compare_exact(f"K5 {name}", fn(*args, relu=relu), plain(*args, relu=relu))
        ms = median_ms(lambda: fn(*args, relu=relu))
        pms = median_ms(lambda: plain(*args, relu=relu))
        bms, by = bound(nbytes, int8_ops=ops)
        log(f"  K5 kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30); bound "
            f"{bms:.4f} ms ({by}); achieved {ops / ms / 1e9:.1f} TOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        if record is None:
            record = (err, ms, pms, bms, by)
    k5.reset_launches()
    return record


def launch_counters() -> dict:
    """name -> (read the kernel's launch count, set it to 0)."""
    from mmdx_tpu_torch.ops import beam_attn, bert_attn, fused_ffn, int8_gemm, t5_step

    wrappers = {
        "bert_attn": bert_attn.fused_attention_block,
        "fused_ffn": fused_ffn.fused_ffn_ln,
        "beam_attn_partial": beam_attn.beam_decode_attention_partial,
        "t5_cross_ffn": t5_step.cross_ffn_block,
        "fused_ffn_int8": fused_ffn.fused_ffn_ln_int8,
        "bert_attn_int8": bert_attn.fused_attention_block_int8,
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


def check_decode_counts(name, launches, dec_layers, gen) -> int:
    steps = launches["beam_attn_partial"] // dec_layers
    if (launches["beam_attn_partial"] != launches["t5_cross_ffn"]
            or launches["beam_attn_partial"] % dec_layers
            or steps < 2 * gen.min_new_tokens):
        fail(f"{name} decode kernels: expected {dec_layers} launches per step each "
             f"over >= {2 * gen.min_new_tokens} steps, got {launches}")
    return steps


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
    steps = check_decode_counts("fast", launches, dec_layers, gen)
    log(f"  fast launch counts as expected: {layers} per classify (K1, K2), "
        f"{dec_layers} per decode step over {steps} steps (K3, K4)")

    parity = InferenceEngine(bundle, mode="parity", device=device)
    (pprobs, pz_img, pz_txt), pcms = synced(lambda: parity.classify_batch(images, TEXTS))
    pids, pgms = synced(lambda: parity.generate_report_ids(pz_img, pz_txt))
    check_probs("parity classify_batch", pprobs)
    diverge = []
    for a, b in zip(ids, pids):
        d = np.nonzero(a != b)[0]
        diverge.append(int(d[0]) if d.size else None)
    log(f"  parity classify_batch {pcms:.1f} ms, generate {pgms:.1f} ms; "
        f"max |prob fast - parity| = {float(np.abs(probs - pprobs).max()):.4f}; "
        f"first differing token position per report (None = identical): {diverge}")
    del parity
    return launches, fast, probs


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
    steps = check_decode_counts("turbo", launches, dec_layers, gen)
    log(f"  turbo launch counts as expected: 53 per classify (K5), {layers} per "
        f"classify (K6, K7), {dec_layers} per decode step over {steps} steps (K3, K4)")
    fast_gray, _, _ = fast.classify_batch(gray, TEXTS)
    log(f"  max |prob turbo - fast|: RGB {float(np.abs(results['RGB'] - fast_probs).max()):.4f}, "
        f"gray {float(np.abs(results['gray'] - fast_gray).max()):.4f} (informative)")
    return launches


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def phase_server(bundle, device, mode: str, n: int, gray: bool) -> None:
    import io

    import numpy as np
    from PIL import Image

    from mmdx_tpu_torch.config import DISEASES
    from mmdx_tpu_torch.serve.wsgi import make_app

    app = make_app(bundle=bundle, engine_mode=mode, generate_reports=True,
                   device=device)
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
                fail(f"/api/predict/ ({mode}) answered {status['s']}: {raw[:300]!r}")
            log(f"  /api/predict/ {mode} #{i}: 200 in {ms:.1f} ms, 13 diseases, "
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
    counters = launch_counters()
    log("fast path")
    fast_launches, fast, fast_probs = phase_fast(device, bundle, images, counters)
    log("turbo path")
    turbo_launches = phase_turbo(device, bundle, images, counters, fast, fast_probs)
    del fast
    log("server: /api/predict/ through mmdx_tpu_torch.serve.wsgi")
    phase_server(bundle, device, "fast", 3, gray=False)
    phase_server(bundle, device, "turbo", 2, gray=True)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": fast_launches[name] + turbo_launches[name],
         "max_abs_err": kernel_stats[name][0], "ms": kernel_stats[name][1],
         "plain_ms": kernel_stats[name][2], "bound_ms": kernel_stats[name][3],
         "bound_by": kernel_stats[name][4], "library_ms": None}
        for name in KERNELS
    ]}
    log(f"card: {card}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
