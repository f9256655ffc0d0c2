#!/usr/bin/env python
"""Steady-state timing and a torch.profiler breakdown of the PyTorch port's
fast and turbo paths (mmdx_tpu_torch) on one CUDA card.

    python3 scripts/profile_torch_port.py
    python3 scripts/profile_torch_port.py --fused-lm-head  # the A/B of 6. alone
    python3 scripts/profile_torch_port.py --fused-blocks   # 7. alone

Full-width random weights (seed 0, as chip_smoke.py), fixed 96-token text
(``pad_to``):

  1. fast mode, 256x256x3 uint8 images, for B in 1, 4, 32: ``classify_batch``
     (three repeats) and beam-4 ``generate_report_ids`` (two repeats; random
     weights run all 180 steps), after one warm-up call each, on the host
     clock around ``torch.cuda.synchronize``;
  2. classify on 256x256 gray (1-channel) uint8 images, B in 1, 4, 32 and
     512 (the JAX package's turbo headline batch, ``bench.py``), fast
     against turbo (int8 tower through K5, W8A8 text blocks; the turbo
     engine calibrates on its first batch, a warm-up), in turns fast, turbo,
     turbo, fast, three repeats each;
  3. fast greedy ``generate_report_ids(greedy=True)`` at B=4 and B=64 (two
     repeats after a warm-up; the B=64 conditioning is the B=32 batch's
     twice), on the host clock;
  4. one warm call each of generate B=4, generate B=32, greedy B=4 and
     B=64, classify B=4 and
     gray classify B=32 in fast and turbo mode under ``torch.profiler``: the
     wall time, the device time (the profiler's self CUDA total: the sum of
     the kernels' durations), the busy share = device / wall (the profiler's
     own overhead inflates the wall, so the share is a lower bound), the
     host's self CPU total and op count, the top ops by device time, and for
     the gray classifies the device time of the image tower's convolutions:
     cuDNN's (``aten::cudnn_convolution``) in fast mode against K5
     (``int8_gemm_requant_kernel``) and its im2col/pool glue in turbo mode,
     with K5's and the W8A8 text projections' (``int8_gemm_dequant_kernel``)
     shares of the device time, at B=32 and B=512; for
     every generate K4's share and kernels per step (``decode_shares``),
     with K3's share (beam) or row 5's (greedy), and for fast classify B=4
     and gray B=32 the text tower's GEMM, attention core and LayerNorm
     shares (``text_shares``); the script fails if one of those shares
     reads 0. The full tables go to the git-ignored output
     directory (``out_dir`` below);
  5. the routes of Queue 2 rows 9, 12, 13 and 17, each pair in turns (A, B,
     B, A) three times after a warm-up: long-text fast classify at L=512
     (``max_len`` 512, flash attention in every layer) at B=4 and B=32, the
     latter profiled with row 9's share (both bodies, ``flash_attn*``) and
     the GEMM's and LayerNorm's; turbo classify of 256x256 RGB images at B=32 with and
     without ``MMDX_INT8_FUSED_BLOCKS=1,2`` on the same int8 tower; the bf16
     image tower with ``use_fused_bottleneck`` against the cuDNN tower at
     B=32 on 224x224 inputs; ``preprocess_batch_fused`` against
     ``preprocess_batch_device`` at B=32 on 512x512x3 uint8 images;
  6. the ``MMDX_FUSED_LM_HEAD`` switch (the streamed lm head, rows 10 and
     11, against the dense f32 logits; read when an engine is built, off
     by default): fast generate with the switch on and off, beam-4 at B=4
     and B=32 and greedy at B=4 and B=64, in turns (off, on, on, off)
     three times after a warm-up, then one profiled call of each: device
     ms, busy share and, with the switch on, the share of
     ``lm_head_kernel`` (rows 10 and 11) and its launches, one a decode
     step (K4's launches over the decoder layers); the script fails if
     that share reads 0 or the launches are not one a step;
  7. with ``--fused-blocks`` (alone): the fused bottlenecks end to end,
     each call profiled, in turns (A, B, B, A): turbo classify of 256x256
     gray images at B=32 and B=512 without and with
     ``MMDX_INT8_FUSED_BLOCKS=1,2`` on one calibrated int8 tower, with row
     13's share and launches (5 a classify); the bf16 image tower at B=32 on
     224x224 inputs, cuDNN against ``use_fused_bottleneck``, with row 12's
     share and launches (6 a tower); device ms and busy share of each. The
     script fails if a share reads 0.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 0
TEXTS = ["62 year old male, productive cough and fever for 3 days, smoker",
         "45F, sharp left-sided chest pain after a fall, no fever",
         "follow-up after pneumonia, shortness of breath on exertion, on 2L O2",
         "routine pre-operative film, no complaints"]


def log(msg: str) -> None:
    print(msg, flush=True)


def synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(name: str, fn, out_dir: Path) -> tuple[dict, float]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    host = sum(e.self_cpu_time_total for e in events) / 1e3
    n_ops = sum(1 for e in events if e.device_type == DeviceType.CPU)
    log(f"=== {name}: wall {wall:.1f} ms, device {device:.1f} ms, busy share "
        f"{device / wall:.3f}; host self CPU {host:.1f} ms over {n_ops} host ops")
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=25,
                           max_name_column_width=60)
    (out_dir / f"{name.replace(' ', '_').replace('=', '')}.txt").write_text(table)
    for row in table.splitlines()[3:13]:  # header + top 10 ops by device time
        log(row)
    ops = {a.key: (a.self_device_time_total / 1e3, a.device_time_total / 1e3, a.count)
           for a in averages}
    return ops, device


# the int8 GEMM's two families: the requantizing one (K5, the tower) and
# the dequantizing one (the W8A8 text blocks' projections); older checkouts
# named them int8_gemm_kernel<false> and <true>
K5_NAMES = ("int8_gemm_requant_kernel", "int8_gemm_kernel<false>")
INT8_TEXT_NAMES = ("int8_gemm_dequant_kernel", "int8_gemm_kernel<true>")


def conv_time(name: str, ops: dict, total: float, turbo: bool) -> None:
    """The image tower's convolution device time in one profiled classify:
    cuDNN's in fast mode, K5's (and, apart, the int8 glue's) in turbo, with
    K5's and the text projections' shares of the device time; in turbo,
    exit if either reads 0 (a kernel renamed out of the match)."""
    cudnn = sum(t for k, (_, t, _) in ops.items() if k == "aten::cudnn_convolution")
    k5 = device_ms(ops, lambda k: any(n in k for n in K5_NAMES))
    text = device_ms(ops, lambda k: any(n in k for n in INT8_TEXT_NAMES))
    log(f"--- {name}: convolution device time: cuDNN {cudnn:.3f} ms (its bias adds "
        f"{ops.get('aten::add_', (0, 0, 0))[1]:.3f} ms, ReLUs "
        f"{ops.get('aten::clamp_min', (0, 0, 0))[1]:.3f} ms apart); K5 "
        f"int8_gemm_requant_kernel {k5:.3f} ms ({k5 / total:.1%} of {total:.3f}); the "
        f"text blocks' int8_gemm_dequant_kernel {text:.3f} ms ({text / total:.1%}); "
        f"im2col stacks (aten::cat) {ops.get('aten::cat', (0, 0, 0))[1]:.3f} ms, max-pool "
        f"(aten::maximum) {ops.get('aten::maximum', (0, 0, 0))[1]:.3f} ms")
    if turbo and not (k5 > 0 and text > 0):
        log(f"FAIL: {name}: an int8 GEMM share reads 0 ms (K5 {k5}, text {text})")
        sys.exit(1)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    import subprocess

    from mmdx_tpu_torch.config import DiagnosisConfig
    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"card: {smi.stdout.strip()}")
    out_dir = ROOT / "chiprun_out" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    config = DiagnosisConfig()
    bundle = bridge.bundle_from_variables(bridge.random_state(config, SEED), config)
    engine = InferenceEngine(bundle, mode="fast", device=torch.device("cuda", 0))
    rng = np.random.default_rng(SEED)
    batches = {}
    if "--fused-blocks" in sys.argv[1:]:
        fused_blocks_ab(bundle, rng, out_dir, torch.device("cuda", 0))
        return 0
    only_ab = "--fused-lm-head" in sys.argv[1:]
    for b in (1, 4, 32):
        images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(b)]
        texts = [TEXTS[i % len(TEXTS)] for i in range(b)]

        def classify(images=images, texts=texts, b=b):
            return engine.classify_batch(images, texts, pad_to=b)

        _, z_img, z_txt = classify()
        if only_ab:
            batches[b] = (classify, z_img, z_txt)
            continue
        engine.generate_report_ids(z_img, z_txt)  # warm-up
        cls = sorted(synced_ms(classify)[1] for _ in range(3))
        gen = sorted(synced_ms(lambda: engine.generate_report_ids(z_img, z_txt))[1]
                     for _ in range(2))
        log(f"B={b}: classify ms {cls}, generate ms {gen} (beam 4, 180 max steps)")
        batches[b] = (classify, z_img, z_txt)
    if only_ab:
        fused_lm_head_ab(bundle, engine, batches, out_dir)
        return 0

    turbo = InferenceEngine(bundle, mode="turbo", device=torch.device("cuda", 0))
    gray_batches = {}
    for b in (1, 4, 32, 512):
        images = [rng.integers(0, 256, (256, 256), dtype=np.uint8) for _ in range(b)]
        texts = [TEXTS[i % len(TEXTS)] for i in range(b)]
        calls = {
            mode: (lambda eng=eng, images=images, texts=texts, b=b:
                   eng.classify_batch(images, texts, pad_to=b))
            for mode, eng in (("fast", engine), ("turbo", turbo))}
        for fn in calls.values():
            fn()  # warm-up (turbo: the first-batch calibration)
        times = {"fast": [], "turbo": []}
        for _ in range(3):
            for mode in ("fast", "turbo", "turbo", "fast"):
                times[mode].append(synced_ms(calls[mode])[1])
        log(f"B={b} gray 256x256: classify ms fast {sorted(times['fast'])}, "
            f"turbo {sorted(times['turbo'])}")
        gray_batches[b] = calls
    log(f"turbo first-batch calibration + quantization: {turbo.calibration_ms:.1f} ms")

    greedy_z = {4: batches[4][1:], 64: tuple(torch.cat([z, z]) for z in batches[32][1:])}
    for b, z in greedy_z.items():
        engine.generate_report_ids(*z, greedy=True)  # warm-up
        gen = sorted(synced_ms(lambda: engine.generate_report_ids(*z, greedy=True))[1]
                     for _ in range(2))
        log(f"B={b}: greedy generate ms {gen} (180 max steps)")

    for b in (4, 32):
        _, z_img, z_txt = batches[b]
        ops, total = profiled(f"generate B={b}",
                              lambda: engine.generate_report_ids(z_img, z_txt), out_dir)
        decode_shares(f"generate B={b}", ops, total, beam=True)
    for b, z in greedy_z.items():
        ops, total = profiled(f"greedy generate B={b}",
                              lambda: engine.generate_report_ids(*z, greedy=True), out_dir)
        decode_shares(f"greedy generate B={b}", ops, total, beam=False)
    ops, total = profiled("classify B=4", batches[4][0], out_dir)
    text_shares("classify B=4", ops, total)
    for b in (32, 512):
        for mode in ("fast", "turbo"):
            ops, total = profiled(f"{mode} classify gray B={b}", gray_batches[b][mode], out_dir)
            conv_time(f"{mode} classify gray B={b}", ops, total, mode == "turbo")
            if mode == "fast" and b == 32:
                text_shares("fast classify gray B=32", ops, total)
    long_text_and_fused_routes(bundle, turbo, rng, out_dir, torch.device("cuda", 0))
    fused_lm_head_ab(bundle, engine, batches, out_dir)
    log(f"tables in {out_dir}")
    return 0


def fused_lm_head_ab(bundle, engine, batches, out_dir: Path) -> None:
    """Section 6: generate with ``MMDX_FUSED_LM_HEAD=1`` against the
    default engine ``engine`` on the conditioning of ``batches`` (B -> (fn,
    z_img, z_txt))."""
    import os

    import torch

    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    os.environ["MMDX_FUSED_LM_HEAD"] = "1"
    try:
        fused = InferenceEngine(bundle, mode="fast", device=engine.device)
    finally:
        os.environ.pop("MMDX_FUSED_LM_HEAD")
    if not fused.fused_lm_head or engine.fused_lm_head:
        log("FAIL: MMDX_FUSED_LM_HEAD did not reach the engines as set")
        sys.exit(1)
    z = {4: batches[4][1:], 32: batches[32][1:],
         64: tuple(torch.cat([t, t]) for t in batches[32][1:])}
    for greedy, sizes in ((False, (4, 32)), (True, (4, 64))):
        for b in sizes:
            route = f"{'greedy' if greedy else 'beam-4'} generate B={b}"
            in_turns(route, *((name, lambda eng=eng, b=b: eng.generate_report_ids(
                *z[b], greedy=greedy)) for name, eng in (("default", engine),
                                                         ("MMDX_FUSED_LM_HEAD=1", fused))))
            for name, eng in (("default", engine), ("MMDX_FUSED_LM_HEAD=1", fused)):
                label = f"{route} {name}"
                ops, total = profiled(label, lambda: eng.generate_report_ids(
                    *z[b], greedy=greedy), out_dir)
                if eng is fused:
                    ms = device_ms(ops, lambda k: "lm_head_kernel" in k)
                    share(label, "rows 10/11 (lm_head_kernel)", ms, total)
                    # one lm-head kernel a step: K4 launches once a layer a step
                    heads = sum(c for k, (_, _, c) in ops.items() if "lm_head_kernel" in k)
                    k4 = sum(c for k, (_, _, c) in ops.items() if "t5_cross_ffn_kernel" in k)
                    steps = k4 / bundle.config.report.num_decoder_layers
                    log(f"--- {label}: lm_head_kernel launches {heads} over {steps:g} steps")
                    if ms <= 0 or heads != steps:
                        log(f"FAIL: {label}: the lm head's share reads {ms} ms, or its "
                            f"launches ({heads}) are not one a step ({steps:g})")
                        sys.exit(1)


def device_ms(ops: dict, pred) -> float:
    """Self device time (ms) of the profiled ops whose name ``pred`` takes."""
    return sum(t for k, (t, _, _) in ops.items() if pred(k))


# K4's kernels by name: one launch a layer (t5_cross_ffn_kernel), or, in
# older checkouts, two RMSNorms, the attention core and four launches of the
# shared bf16 GEMM, which decode runs for K4 alone
K4_NAMES = ("t5_cross_ffn_kernel", "t5_cross_attn_kernel", "rmsnorm_bf16_kernel",
            "gemm_bf16_kernel")
# K3's in older and current checkouts (beam_attn_partial_kernel,
# beam_partial_kernel)
K3_NAME = "partial_kernel"


def decode_shares(route: str, ops: dict, total: float, beam: bool, steps: int = 180) -> None:
    """Log K4's (and with ``beam`` K3's, else row 5's) share of a profiled
    generate and K4's kernels per decode step; exit if a share reads 0 (a
    kernel renamed out of the match)."""
    k4 = {k: v for k, v in ops.items() if any(n in k for n in K4_NAMES)}
    per_step = sum(n for _, _, n in k4.values()) / steps
    share(route, f"K4 ({', '.join(sorted(n for n in K4_NAMES if any(n in k for k in k4)))})",
          device_ms(k4, lambda k: True), total)
    log(f"--- {route}: K4 kernels per decode step {per_step:.1f} (over {steps} steps)")
    kernels = {"K3 (partial_kernel)": lambda k: K3_NAME in k} if beam else \
        {"row 5 (beam_attn_kernel)": lambda k: "beam_attn_kernel" in k}
    shares = {"K4": device_ms(k4, lambda k: True)}
    for name, pred in kernels.items():
        shares[name] = device_ms(ops, pred)
        share(route, name, shares[name], total)
    if not all(ms > 0 for ms in shares.values()):
        log(f"FAIL: {route}: a kernel share reads 0 ms: {shares}")
        sys.exit(1)


# the text tower's kernels: the bf16 GEMM (gemm_bf16_kernel in older
# checkouts), the attention core, the LayerNorm
TEXT_KERNELS = {"GEMM (gemm_wgmma_kernel)": ("gemm_wgmma_kernel", "gemm_bf16_kernel"),
                "attention core (bert_attn_kernel)": ("bert_attn_kernel",),
                "LayerNorm (layernorm_f32_bf16_kernel)": ("layernorm_f32_bf16_kernel",)}


def text_shares(route: str, ops: dict, total: float, core: bool = True) -> None:
    """Log the GEMM's, the attention core's and the LayerNorm's shares of a
    profiled classify; exit if the GEMM's (or, with ``core``, the core's)
    reads 0 (a kernel renamed out of the match)."""
    shares = {}
    for name, keys in TEXT_KERNELS.items():
        shares[name] = device_ms(ops, lambda k, keys=keys: any(n in k for n in keys))
        share(route, name, shares[name], total)
    needed = [n for n in TEXT_KERNELS if n.startswith("GEMM") or (core and "core" in n)]
    if not all(shares[n] > 0 for n in needed):
        log(f"FAIL: {route}: a text kernel share reads 0 ms: {shares}")
        sys.exit(1)


def share(route: str, kernel: str, ms: float, total: float) -> None:
    log(f"--- {route}: {kernel} device time {ms:.3f} ms of {total:.3f} ms "
        f"({ms / max(total, 1e-9):.3f})")


def in_turns(label: str, a: tuple, b: tuple) -> None:
    """Time two callables (name, fn) in turns a, b, b, a, three times, after
    one warm-up call each."""
    for _, fn in (a, b):
        fn()
    times = {a[0]: [], b[0]: []}
    for _ in range(3):
        for name, fn in (a, b, b, a):
            times[name].append(synced_ms(fn)[1])
    log(f"{label}: " + ", ".join(f"{k} ms {sorted(v)}" for k, v in times.items()))


def long_text_and_fused_routes(bundle, turbo, rng, out_dir: Path, dev) -> None:
    import dataclasses
    import os

    import numpy as np
    import torch

    from mmdx_tpu_torch.models.layers import cast_
    from mmdx_tpu_torch.models.resnet import ImageEncoder
    from mmdx_tpu_torch.ops.preprocess import (preprocess_batch_device,
                                               preprocess_batch_fused)
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    config = bundle.config
    lb = dataclasses.replace(bundle, config=dataclasses.replace(
        config, text=dataclasses.replace(config.text, max_len=512)))
    fast = InferenceEngine(lb, mode="fast", device=dev)
    words = "cough fever dyspnea effusion opacity chest pain left".split()
    text = " ".join(words[i % len(words)] for i in range(500))
    for b in (4, 32):
        images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(b)]
        fn = (lambda images=images, b=b: fast.classify_batch(images, [text] * b, pad_to=b))
        fn()
        cls = sorted(synced_ms(fn)[1] for _ in range(3))
        log(f"long text L=512 B={b}: fast classify ms {cls}")
        if b == 32:
            ops, total = profiled("fast classify long text L=512 B=32", fn, out_dir)
            # both bodies: flash_attn_tc_kernel (bf16) and flash_attn_kernel
            share("fast classify long text L=512 B=32", "flash_attn kernels (row 9)",
                  device_ms(ops, lambda k: "flash_attn" in k), total)
            text_shares("fast classify long text L=512 B=32", ops, total, core=False)
    del fast

    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(32)]
    os.environ["MMDX_INT8_FUSED_BLOCKS"] = "1,2"
    try:
        fused = InferenceEngine(bundle, mode="turbo", device=dev)
    finally:
        os.environ.pop("MMDX_INT8_FUSED_BLOCKS")
    fused._qparams = turbo._ensure_qparams()
    texts = [TEXTS[i % len(TEXTS)] for i in range(32)]
    in_turns("turbo classify RGB B=32",
             ("unfused", lambda: turbo.classify_batch(images, texts, pad_to=32)),
             ("MMDX_INT8_FUSED_BLOCKS=1,2",
              lambda: fused.classify_batch(images, texts, pad_to=32)))
    ops, _ = profiled("turbo classify RGB B=32 fused blocks",
                      lambda: fused.classify_batch(images, texts, pad_to=32), out_dir)
    k13 = device_ms(ops, is_row13)
    log(f"--- row 13 (bottleneck_tc_kernel<S8>) device time {k13:.3f} ms (5 blocks)")
    del fused

    cfg = config.image
    encoders = []
    for c in (dataclasses.replace(cfg, use_fused_bottleneck=True), cfg):
        e = ImageEncoder(c)
        e.load_state_dict(bundle.model.image_encoder.state_dict())
        encoders.append(cast_(e, torch.bfloat16).to(dev).eval())
    x = torch.randn(32, 224, 224, 3, generator=torch.Generator().manual_seed(SEED))
    x = x.to(dev, torch.bfloat16)
    with torch.inference_mode():
        in_turns("bf16 image tower B=32 at 224",
                 ("cuDNN", lambda: encoders[1].encode(x)),
                 ("use_fused_bottleneck", lambda: encoders[0].encode(x)))
        ops, _ = profiled("fused bf16 image tower B=32", lambda: encoders[0].encode(x),
                          out_dir)
    k12 = device_ms(ops, is_row12)
    log(f"--- row 12 (bottleneck_tc_kernel<Bf16>) device time {k12:.3f} ms (6 blocks)")

    batch = torch.from_numpy(rng.integers(0, 256, (32, 512, 512, 3), dtype=np.uint8)).to(dev)
    in_turns("preprocessing B=32 512x512x3",
             ("matmul", lambda: preprocess_batch_device(batch)),
             ("fused", lambda: preprocess_batch_fused(batch)))


def is_row13(kernel: str) -> bool:  # csrc/implicit_gemm.cuh, s8
    return "bottleneck_tc_kernel" in kernel and "S8" in kernel


def is_row12(kernel: str) -> bool:  # bf16 on the tensor cores, f32 on the CUDA cores
    return ("bottleneck_tc_kernel" in kernel and "Bf16" in kernel) or \
        "bottleneck_kernel<float>" in kernel


def fused_blocks_ab(bundle, rng, out_dir: Path, dev) -> None:
    """Section 7 (``--fused-blocks``)."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from mmdx_tpu_torch.models.layers import cast_
    from mmdx_tpu_torch.models.resnet import ImageEncoder
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    turbo = InferenceEngine(bundle, mode="turbo", device=dev)
    os.environ["MMDX_INT8_FUSED_BLOCKS"] = "1,2"
    try:
        fused = InferenceEngine(bundle, mode="turbo", device=dev)
    finally:
        os.environ.pop("MMDX_INT8_FUSED_BLOCKS")

    def ab(label, calls: dict, pred, launches: int, kernel: str):
        for fn in calls.values():
            fn()  # warm-up
        for name in list(calls)[:1] + list(calls)[1:] * 2 + list(calls)[:1]:
            ops, total = profiled(f"{label} {name}", calls[name], out_dir)
            if name == list(calls)[1]:
                ms = device_ms(ops, pred)
                n = sum(c for k, (_, _, c) in ops.items() if pred(k))
                share(f"{label} {name}", f"{kernel}, {n} launches", ms, total)
                if not ms or n != launches:
                    log(f"FAIL: {label}: {kernel} reads {ms} ms over {n} launches "
                        f"(expected {launches})")
                    sys.exit(1)

    for b in (32, 512):
        images = [rng.integers(0, 256, (256, 256), dtype=np.uint8) for _ in range(b)]
        texts = [TEXTS[i % len(TEXTS)] for i in range(b)]
        turbo.classify_batch(images, texts, pad_to=b)  # the first batch calibrates
        fused._qparams = turbo._ensure_qparams()
        ab(f"turbo classify gray B={b}",
           {"unfused": lambda: turbo.classify_batch(images, texts, pad_to=b),
            "MMDX_INT8_FUSED_BLOCKS=1,2": lambda: fused.classify_batch(images, texts, pad_to=b)},
           is_row13, 5, "row 13")
    del turbo, fused

    cfg = bundle.config.image
    encoders = []
    for c in (cfg, dataclasses.replace(cfg, use_fused_bottleneck=True)):
        e = ImageEncoder(c)
        e.load_state_dict(bundle.model.image_encoder.state_dict())
        encoders.append(cast_(e, torch.bfloat16).to(dev).eval())
    x = torch.randn(32, 224, 224, 3, generator=torch.Generator().manual_seed(SEED))
    x = x.to(dev, torch.bfloat16)
    with torch.inference_mode():
        ab("bf16 image tower B=32 at 224",
           {"cuDNN": lambda: encoders[0].encode(x),
            "use_fused_bottleneck": lambda: encoders[1].encode(x)}, is_row12, 6, "row 12")


if __name__ == "__main__":
    sys.exit(main())
