"""Smoke run of the PyTorch port (mmdx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases (any failure exits nonzero):
  1. card and build: the card's name and power limit, torch/CUDA/nvcc
     versions, and the time to build the hand-written kernels from
     mmdx_tpu_torch/csrc with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the same bf16 inputs at
     serving shapes: max abs/rel error against the stated tolerance, and the
     median time of each over 30 runs (CUDA events);
  3. the fast-mode main path at full width (ResNet-50 at 224, BERT-base,
     fusion 1024, T5-small decoder under beam-4, 150-180 new tokens) from
     random weights made from a seed: engine.infer on one image, then
     classify_batch + generate_reports on a batch of 4, with the kernels'
     launch counts; the same batch in parity mode for comparison;
  4. /api/predict/ through the port's WSGI app, in process.

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
# K1, K2, K4 end in bf16 outputs of magnitude up to a few units: a few bf16
# ulps (the Pallas bf16 tests use 3e-2 and 4e-2, tests/test_pallas_beam_attn.py:45,
# tests/test_pallas_t5_step.py:47)
ATOL = RTOL = 4e-2
# K3's acc, m and l are f32 sums over the same bf16 products as its plain
# version, so they agree to f32 summation order, far inside this bound
K3_ATOL, K3_RTOL = 1e-4, 1e-3

KERNELS = {
    "bert_attn": ("mmdx_tpu_torch/csrc/bert_attn.cu",
                  "mmdx_tpu/ops/pallas_bert_attn.py:200"),
    "fused_ffn": ("mmdx_tpu_torch/csrc/gemm.cu",
                  "mmdx_tpu/ops/pallas_ffn.py:191"),
    "beam_attn_partial": ("mmdx_tpu_torch/csrc/beam_attn.cu",
                          "mmdx_tpu/ops/pallas_beam_attn.py:220"),
    "t5_cross_ffn": ("mmdx_tpu_torch/csrc/t5_cross_attn.cu",
                     "mmdx_tpu/ops/pallas_t5_step.py:106"),
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


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_card_and_build():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
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
    import torch

    from mmdx_tpu_torch.ops import beam_attn, bert_attn, fused_ffn, t5_step

    g = torch.Generator(device="cpu").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(device=device, dtype=dtype)

    out = {}

    # K1 / K2: BERT-base layer at B=32, L=96
    b, l, h, heads, f = 32, 96, 768, 12, 3072
    m = b * l
    x = randn(m, h)
    lens = torch.randint(8, l + 1, (b,), generator=g)
    kmask = torch.where(torch.arange(l)[None, :] < lens[:, None], 0.0, -1e9)
    kmask = kmask.reshape(m).to(device=device, dtype=torch.float32)
    attn_args = (x, kmask, randn(h, 3 * h, scale=h ** -0.5), randn(3 * h, scale=0.02),
                 randn(h, h, scale=h ** -0.5), randn(h, scale=0.02),
                 1.0 + randn(h, scale=0.1), randn(h, scale=0.1))
    kw = dict(seq_len=l, num_heads=heads, eps=1e-12)
    log(f"K1 fused_attention_block: x [{m}, {h}] bf16 (B={b}, L={l}), {heads} heads")
    err = compare("K1", bert_attn.fused_attention_block(*attn_args, **kw),
                  bert_attn.fused_attention_block_plain(*attn_args, **kw))
    ms = median_ms(lambda: bert_attn.fused_attention_block(*attn_args, **kw))
    pms = median_ms(lambda: bert_attn.fused_attention_block_plain(*attn_args, **kw))
    log(f"  K1 kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")
    out["bert_attn"] = (err, ms, pms)

    ffn_args = (x, randn(h, f, scale=h ** -0.5), randn(f, scale=0.02),
                randn(f, h, scale=f ** -0.5), randn(h, scale=0.02),
                1.0 + randn(h, scale=0.1), randn(h, scale=0.1))
    log(f"K2 fused_ffn_ln: x [{m}, {h}] x [{h}, {f}] x [{f}, {h}] bf16")
    err = compare("K2", fused_ffn.fused_ffn_ln(*ffn_args, eps=1e-12),
                  fused_ffn.fused_ffn_ln_plain(*ffn_args, eps=1e-12))
    ms = median_ms(lambda: fused_ffn.fused_ffn_ln(*ffn_args, eps=1e-12))
    pms = median_ms(lambda: fused_ffn.fused_ffn_ln_plain(*ffn_args, eps=1e-12))
    log(f"  K2 kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")
    out["fused_ffn"] = (err, ms, pms)

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
    ms = median_ms(lambda: beam_attn.beam_decode_attention_partial(*args))
    pms = median_ms(lambda: beam_attn.beam_decode_attention_partial_plain(*args))
    log(f"  K3 kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30, pos={pos})")
    out["beam_attn_partial"] = (worst, ms, pms)

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
    ms = median_ms(lambda: t5_step.cross_ffn_block(*t5_args, heads=heads))
    pms = median_ms(lambda: t5_step.cross_ffn_block_plain(*t5_args, heads=heads))
    log(f"  K4 kernel {ms:.4f} ms, plain {pms:.4f} ms (median of 30)")
    out["t5_cross_ffn"] = (err, ms, pms)
    torch.cuda.synchronize()
    return out


def launch_counters():
    from mmdx_tpu_torch.ops import beam_attn, bert_attn, fused_ffn, t5_step

    return {
        "bert_attn": bert_attn.fused_attention_block,
        "fused_ffn": fused_ffn.fused_ffn_ln,
        "beam_attn_partial": beam_attn.beam_decode_attention_partial,
        "t5_cross_ffn": t5_step.cross_ffn_block,
    }


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
def phase_main_path(device):
    import numpy as np

    from mmdx_tpu.config import DiagnosisConfig
    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

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
    fast = InferenceEngine(bundle, mode="fast", device=device)

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out, ms = synced(lambda: fast.infer(images[0], TEXTS[0]))
    after_infer = {k: fn.launches for k, fn in counters.items()}
    check_probs("infer", np.asarray(list(out["disease_probs"].values()), np.float32))
    log(f"  fast infer (1 image + beam-4 report): {ms:.1f} ms, "
        f"report {len(out['report_text'])} chars, launches {after_infer}")
    (probs, z_img, z_txt), cms = synced(lambda: fast.classify_batch(images, TEXTS))
    ids, gms = synced(lambda: fast.generate_report_ids(z_img, z_txt))
    reports = fast.t5_tok.batch_decode(ids, skip_special_tokens=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    check_probs("classify_batch", probs)
    lens = report_lengths(ids, gen.eos_token_id)
    log(f"  fast classify_batch B=4 (512x512x3 uint8): {cms:.1f} ms; "
        f"generate B=4: {gms:.1f} ms; report tokens {lens}; "
        f"report chars {[len(r) for r in reports]}")
    log(f"  launches over infer + batch: {launches}")
    if not all(gen.min_new_tokens <= n <= gen.max_new_tokens for n in lens):
        fail(f"report lengths {lens} outside {gen.min_new_tokens}-{gen.max_new_tokens}")
    layers = config.text.num_layers
    dec_layers = config.report.num_decoder_layers
    if launches["bert_attn"] != 2 * layers or launches["fused_ffn"] != 2 * layers:
        fail(f"text-tower kernels: expected {2 * layers} launches each "
             f"({layers} per classify), got {launches}")
    steps = launches["beam_attn_partial"] // dec_layers
    if (launches["beam_attn_partial"] != launches["t5_cross_ffn"]
            or launches["beam_attn_partial"] % dec_layers
            or steps < 2 * gen.min_new_tokens):
        fail(f"decode kernels: expected {dec_layers} launches per step each over "
             f">= {2 * gen.min_new_tokens} steps, got {launches}")
    log(f"  launch counts as expected: {layers} per classify (K1, K2), "
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
    return launches, bundle


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def phase_server(bundle, device) -> None:
    import io

    import numpy as np
    from PIL import Image

    from mmdx_tpu.config import DISEASES
    from mmdx_tpu_torch.serve.wsgi import make_app

    app = make_app(bundle=bundle, engine_mode="fast", generate_reports=True,
                   device=device)
    rng = np.random.default_rng(SEED + 1)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (600, 480), dtype=np.uint8)).save(buf, "PNG")
    boundary = b"chipsmokeboundary"
    try:
        for i, text in enumerate(TEXTS[:3]):
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
                fail(f"/api/predict/ answered {status['s']}: {raw[:300]!r}")
            log(f"  /api/predict/ #{i}: 200 in {ms:.1f} ms, 13 diseases, "
                f"report {len(payload['report_text'])} chars")
    finally:
        if app._batcher is not None:
            app._batcher.stop(drain=True)


def main() -> int:
    if not (ROOT / "mmdx_tpu_torch" / "csrc").is_dir():
        fail("mmdx_tpu_torch/csrc not found next to chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_card_and_build()
    device = torch.device("cuda", 0)
    kernel_stats = phase_kernels(device)
    launches, bundle = phase_main_path(device)
    log("server: /api/predict/ through mmdx_tpu_torch.serve.wsgi, fast mode")
    phase_server(bundle, device)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": kernel_stats[name][0], "ms": kernel_stats[name][1],
         "plain_ms": kernel_stats[name][2]}
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
