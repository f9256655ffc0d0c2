#!/usr/bin/env python
"""Device time per call of the beam step's kernels and of the shared bf16
GEMM, for any checkout of the PyTorch port, on one CUDA card.

    python3 scripts/bench_decode_kernels.py [PORT_ROOT] [--ranks] [--plans] [--int8] [--lm-head]
                                            [--bottleneck] [--preprocess]

PORT_ROOT (default: this repository) is the directory whose
``mmdx_tpu_torch`` is imported, so one call can time an older checkout
(for example a ``git archive`` of the parent commit) and this one in turns.
Each line is one kernel at one shape: the device time per call from a CUDA
graph of 20 calls (``chip_smoke.graph_ms``, the median of 10 replays),
which leaves out the wrapper's host time:

  K4 ``t5_step.cross_ffn_block`` at T5-small widths, N = 4, 16, 20, 32, 64
  and 128 rows; K3 ``beam_attn.beam_decode_attention_partial`` at beam-4
  (nb 4, K = 724) for B = 4, 8 and 32; rows 5 and 7 (the normalised bf16
  and int8 reads) at greedy B=4 and B=64 (nb 1, K = 181) and at beam B=8;
  K2 ``fused_ffn.fused_ffn_ln`` (two launches of ``csrc/gemm.cu``'s GEMM
  and the LayerNorm) at BERT-base widths for one request (M = 32), B=4
  (M = 384), the classify (M = 3072) and long-text (M = 16384) rows, CUDA
  graphs of 10 calls; K1 ``bert_attn.fused_attention_block`` at B=1 L=32,
  B=4 L=96 and B=32 L=96, and its attention core alone (``csrc/bert_attn.cu``)
  at the same shapes; each of the four GEMM launches of a layer (qkv,
  attention output, FFN in, FFN out, with the block's epilogue and, in a
  checkout that splits K, the split the block runs) at M = 32, 384, 3072
  and 16384, and the same product with the bias epilogue beside
  ``torch.addmm(bias, a, b)`` on the same operands, the GEMM's yardstick;
  K5 (``int8_gemm``) at every site of ``chip_smoke.K5_SITES`` (the int8
  tower's shapes at B=32 and the gray stem at B=512), and K6
  (``fused_ffn_ln_int8``) and K7 (``fused_attention_block_int8``) at M =
  384, 3072 and 16384, CUDA graphs of 10 calls. With ``--int8``, only K5,
  K6 and K7.

With ``--lm-head``, only rows 10 and 11 (``lm_head_greedy``,
``lm_head_stats``, T5 vocabulary 32128 x 512) at N = 4, 16, 64, 128 and 256
rows: the device time per call with L2 cold (a CUDA graph of 20 pairs of a
128 MB flush and a call, less a graph of the 20 flushes alone: in a decode
step the decoder's weights and caches evict the 32.9 MB emb from the 50 MB
L2), the flush a write (``zero_``, which leaves the L2 full of dirty lines
that the call then writes back) or a read (``amax``, clean lines, as the
decoder's weight and cache reads leave it), and warm (a graph of 20 calls),
each beside the dense route it replaces at the same N, cold and warm:
``T5.lm_logits_step``'s f32 product against
the f32 copy of the embedding, then ``masked_fill`` and ``argmax`` (greedy),
or the dense ``candidate_topk`` chain (beam-4, its last ``torch.topk``
without the tie check's host sync); beside row 11, a ``fill_`` of an
[N, 32128] f32 tensor: the logits' bytes written in address order.

With ``--bottleneck``, only rows 12 and 13 (``fused_bottleneck`` in bf16,
``fused_bottleneck_int8``) at every shape of their routes, at B=32 and
B=4 (``chip_smoke.row12_cases`` and ``row13_cases`` without the ragged
heights): each kernel's device time per call beside the unfused route of
the same block on the same inputs, also a graph of 20 calls, and the
bound (``chip_smoke.row12_work``, ``row13_work``) with the kernel's share
of it. Row 12's unfused route is ``models/resnet.Bottleneck`` unfused
(cuDNN's three or four convolutions with the bias adds and ReLUs of its
``forward``), row 13's the int8 tower's ``_conv_s8`` chain (the 3x3 conv's
im2col and three launches of the int8 GEMM, the residual in the last);
neither is one PyTorch call. Weights are handed over as views of K-major
storage where the checkout's wrappers read them so
(``bottleneck.kmajor_ld``), else contiguous. With ``--plans`` as well (a
checkout with ``bottleneck.tc_plan``), each shape also runs at every band
height TR that fits shared memory, beside the one ``tc_plan`` picks.

With ``--preprocess``, only row 17 (``preprocess_batch_fused``) at every
shape of ``chip_smoke.PRE_SHAPES``, f32 and bf16 out: the kernel's device
time per call from a CUDA graph of 20 launches of its entry point with its
constants already on the device (a checkout whose wrapper caches them on
the device is called through the wrapper; an older one, whose wrapper
copies eight host constants a call and writes f32 only, through its
library entry point, with the constants copied once and a cast after each
f32 launch for bf16), its time per call with the host's part (CUDA events
around each call, median of 30), the bound (``chip_smoke.row17_work``) and
its share, and the engine's route ``preprocess_batch_device`` (two einsums and the
normalize; in an older checkout it copies its matrices every call, so it
is timed there with CUDA events around each call, host included).

With ``--ranks`` (a checkout with ``beam_attn.cluster_ranks``), rows 5 and
6 are also timed at every cluster size, 1, 2, 4 and 8 blocks, pinned by
replacing ``cluster_ranks`` for the call, beside the size it picks. With
``--plans`` (a checkout with ``ops/gemm.py``), each GEMM product with the
bias epilogue at M = 384, 3072 and 16384 is also timed at every tile shape
the kernel offers (64 or 128 rows x 64 or 128 columns; 128 x 128 with 3
stages, two blocks to an SM, and with 4, one), beside the plan
``gemm_plan`` picks.
Inputs are made from seed 0 on the host, as in chip_smoke.py.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from mmdx_tpu_torch.ops import beam_attn, t5_step

    tag = root.name if root != HERE else "this tree"
    smoke.log(f"card: {smoke.card_line()}; mmdx_tpu_torch from {root} ({tag})")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(smoke.SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def report(label, fn, calls=20):
        try:
            fn()
        except RuntimeError as e:  # a cluster size whose chunk exceeds shared memory
            smoke.log(f"[{tag}] {label}: does not launch ({e})")
            return
        torch.cuda.synchronize()
        smoke.log(f"[{tag}] {label}: device {smoke.graph_ms(fn, calls) * 1e3:.2f} us per call")

    if "--int8" in sys.argv:
        int8_kernels(report, randn, dev, g, smoke)
        return 0
    if "--lm-head" in sys.argv:
        lm_head_kernels(smoke, dev, g, tag)
        return 0
    if "--bottleneck" in sys.argv:
        bottleneck_kernels(smoke, dev, g, tag)
        return 0
    if "--preprocess" in sys.argv:
        preprocess_kernels(smoke, dev, g, tag)
        return 0
    dm, kc, dff, heads = 512, 4, 2048, 8
    for n in (4, 16, 20, 32, 64, 128):
        enc_bias = torch.zeros(n, kc)
        enc_bias[::3, -1] = -1e9
        a = (randn(n, dm), 1.0 + randn(dm, scale=0.1, dtype=torch.float32),
             randn(dm, dm, scale=dm ** -0.5), randn(dm, dm, scale=dm ** -0.5),
             randn(n, kc, dm), randn(n, kc, dm), enc_bias.to(dev),
             1.0 + randn(dm, scale=0.1, dtype=torch.float32),
             randn(dm, dff, scale=dm ** -0.5), randn(dff, dm, scale=dff ** -0.5))
        report(f"K4 N={n}", lambda a=a: t5_step.cross_ffn_block(*a, heads=heads))

    sweep = "--ranks" in sys.argv and hasattr(beam_attn, "cluster_ranks")
    hd = heads * 64

    def pinned(ranks, fn, *args):
        """fn(*args) on clusters of ``ranks`` blocks."""
        def call():
            picked, beam_attn.cluster_ranks = beam_attn.cluster_ranks, lambda *_: ranks
            try:
                return fn(*args)
            finally:
                beam_attn.cluster_ranks = picked
        return call

    def cache(b, nb, lmax):
        kk = nb * lmax
        q = randn(b, nb, hd, scale=0.5)
        kv32 = torch.randn(b, kk, 2 * hd, generator=g) * 0.5
        bias = torch.randn(heads, lmax, generator=g).repeat_interleave(nb, dim=1).to(dev)
        live = torch.randint(0, nb, (b, nb, lmax), generator=g)[..., None] == torch.arange(nb)
        mask = torch.where(live.reshape(b, nb, kk), 0.0, -1e9).to(dev)
        return q, kv32, mask, bias

    for b in (4, 8, 32):
        q, kv32, mask, bias = cache(b, 4, 181)
        kv = kv32.to(dev, bf)
        fn = beam_attn.beam_decode_attention_partial
        report(f"K3 B={b} nb=4 K=724", lambda: fn(q, kv, mask, bias))
        if sweep:
            pick = beam_attn.cluster_ranks(b * heads, 724, beam_attn.PARTIAL_FILL)
            for r in (1, 2, 4, 8):
                report(f"K3 B={b} nb=4 K=724 ranks={r}{' (picked)' if r == pick else ''}",
                       pinned(r, fn, q, kv, mask, bias))
    for b, nb, lmax in ((4, 1, 181), (64, 1, 181), (8, 4, 181)):
        q, kv32, mask, bias = cache(b, nb, lmax)
        kv = kv32.to(dev, bf)
        kv8, kvs = beam_attn.quantize_kv_rows(kv32[..., :hd].to(dev), kv32[..., hd:].to(dev),
                                              heads)
        kk = nb * lmax
        report(f"row 5 B={b} nb={nb} K={kk}",
               lambda: beam_attn.beam_decode_attention(q, kv, mask, bias))
        report(f"row 7 B={b} nb={nb} K={kk}",
               lambda: beam_attn.beam_decode_attention_int8(q, kv8, kvs, mask, bias))
        if sweep:
            pick = beam_attn.cluster_ranks(b * heads, kk)
            for r in (1, 2, 4, 8):
                report(f"row 5 B={b} nb={nb} K={kk} ranks={r}{' (picked)' if r == pick else ''}",
                       pinned(r, beam_attn.beam_decode_attention, q, kv, mask, bias))

    text_kernels(report, randn, dev, tag)
    int8_kernels(report, randn, dev, g, smoke)
    return 0


def int8_kernels(report, randn, dev, g, smoke):
    """K5 at every site of ``chip_smoke.K5_SITES`` (weights [N, K] where the
    checkout has ``int8_gemm_plan``, else its older [K, N]), and K6 and K7
    at ``chip_smoke.INT8_TEXT_SHAPES`` on the checkout's own
    ``quant_weight_cols``."""
    import torch

    from mmdx_tpu_torch.ops import bert_attn, fused_ffn
    from mmdx_tpu_torch.ops import int8_gemm as k5

    k_major = hasattr(k5, "int8_gemm_plan")

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)

    def scales(n):
        return (1e-4 + 1e-2 * torch.rand(n, generator=g)).to(dev)

    def vec(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    for name, m, k, n, epi, k2 in smoke.K5_SITES:
        k += -k % k5.K_ALIGN  # the tower's zero padding
        x, w = s8(m, k), (s8(n, k) if k_major else s8(k, n))
        fn, _, args = smoke.k5_call(k5, epi, x, w, scales(n), s8, scales, vec, k2, k_major)
        report(f"K5 {name} M={m} K={k} N={n}", lambda fn=fn, args=args, epi=epi:
               fn(*args, relu=epi != "plain"))
    h, f, heads = 768, 3072, 12
    wqkv, wo = randn(h, 3 * h, scale=h ** -0.5), randn(h, h, scale=h ** -0.5)
    wi, wf = randn(h, f, scale=h ** -0.5), randn(f, h, scale=f ** -0.5)
    bqkv, bo, bi, bf_ = (randn(n, scale=0.02) for n in (3 * h, h, f, h))
    lns, lnb = 1.0 + randn(h, scale=0.1), randn(h, scale=0.1)
    q = {k: fused_ffn.quant_weight_cols(w) for k, w in
         (("qkv", wqkv), ("o", wo), ("i", wi), ("f", wf))}
    for fb, fl, ab, al in smoke.INT8_TEXT_SHAPES:
        x = randn(fb * fl, h)
        ffn8 = (x, *q["i"], bi, *q["f"], bf_, lns, lnb)
        report(f"K6 M={fb * fl} (B={fb} L={fl})",
               lambda ffn8=ffn8: fused_ffn.fused_ffn_ln_int8(*ffn8, eps=1e-12), calls=10)
        xa = randn(ab * al, h)
        kmask = torch.zeros(ab * al, device=dev)
        kmask.reshape(ab, al)[:, al - al // 4:] = -1e9
        attn8 = (xa, kmask, *q["qkv"], bqkv, *q["o"], bo, lns, lnb)
        report(f"K7 M={ab * al} (B={ab} L={al})",
               lambda attn8=attn8, al=al: bert_attn.fused_attention_block_int8(
                   *attn8, seq_len=al, num_heads=heads, eps=1e-12), calls=10)


def bottleneck_kernels(smoke, dev, g, tag):
    """Rows 12 and 13 beside their unfused routes (see the module's note)."""
    import torch

    from mmdx_tpu_torch.models import resnet_int8 as ri
    from mmdx_tpu_torch.models.resnet import Bottleneck
    from mmdx_tpu_torch.ops import bottleneck as bn
    from mmdx_tpu_torch.ops import int8_bottleneck as ib

    kmajor = hasattr(bn, "kmajor_ld")
    sweep = "--plans" in sys.argv and hasattr(bn, "tc_plan")

    def sweep_plans(label, module, planner, shape, fn):
        """``fn`` at every band height that fits shared memory, with
        ``module.planner`` returning that plan for the call."""
        b, h, w, _, m, cout, es, proj = shape
        picked, kept = bn.tc_plan(*shape), getattr(module, planner)
        for tr in range(1, min(h, bn.MAX_TR) + 1):
            smem = bn.tc_smem_bytes(w, m, cout, tr, es, proj)
            if smem > bn.SMEM_LIMIT:
                continue
            plan = bn.BottleneckPlan(tr, bn.STAGES[es], 1, (-(-h // tr), b), smem)
            setattr(module, planner, lambda *a, plan=plan: plan)
            try:
                t = smoke.graph_ms(fn)
            finally:
                setattr(module, planner, kept)
            smoke.log(f"[{tag}] {label} TR={tr}{' (picked)' if tr == picked.tr else ''}: "
                      f"device {t * 1e3:.2f} us")

    def layout(args):  # a parent's wrappers take contiguous [K, N] weights
        return args if kmajor else {k: v.contiguous() if torch.is_tensor(v) else v
                                    for k, v in args.items()}

    def line(label, fn, unfused, work, **kind):
        fn()
        unfused()
        torch.cuda.synchronize()
        k, u = smoke.graph_ms(fn), smoke.graph_ms(unfused)
        bms, by = smoke.bound(*work[:1], **{kind["ops"]: work[1]})
        smoke.log(f"[{tag}] {label}: device {k * 1e3:.2f} us per call; unfused route "
                  f"{u * 1e3:.2f} us (not one call); bound {bms * 1e3:.2f} us ({by}), "
                  f"{bms / k:.1%} of it")

    for label, b, h, w, c, m in smoke.row13_cases(ragged=False):
        x, args = smoke.row13_operands(g, dev, b, h, w, c, m)
        args = layout(args)
        qc = {}
        for name, wk in (("conv1", args["w1"]), ("conv2", args["w2flat"]), ("conv3", args["w3"])):
            wk = wk.t().contiguous()  # [co, K]
            co = wk.shape[0]
            shape = (3, 3, m, m) if name == "conv2" else (1, 1, wk.shape[1], co)
            qc[name] = {"w": ri.hwio_view(wk, shape), "wk": wk,
                        "ws": (1e-3 + 1e-3 * torch.rand(co, generator=g)).to(dev),
                        "b": torch.randn(co, generator=g).to(dev)}
        sx, s1, s2, so = 0.05, 0.04, 0.03, 0.06

        def unfused(x=x, qc=qc, b=b, h=h, w=w):
            a, _, _ = ri._conv_s8(x, qc["conv1"], sx, s1, 1)
            a, _, _ = ri._conv_s8(a.reshape(b, h, w, -1), qc["conv2"], s1, s2, 1)
            return ri._conv_s8(a.reshape(b, h, w, -1), qc["conv3"], s2, so, 1,
                               res=x.reshape(b * h * w, -1), rs=sx)[0]

        line(f"row 13 {label} x [{b}, {h}, {w}, {c}] M={m}",
             lambda x=x, args=args: ib.fused_bottleneck_int8(x, **args), unfused,
             smoke.row13_work(b, h, w, c, m), ops="int8_ops")
        if sweep:
            sweep_plans(f"row 13 {label}", ib, "tc_plan", (b, h, w, c, m, c, 1, False),
                        lambda x=x, args=args: ib.fused_bottleneck_int8(x, **args))

    for label, b, h, w, cin, m, cout, proj in smoke.row12_cases(ragged=False):
        x, args = smoke.row12_operands(g, dev, b, h, w, cin, m, cout, proj, torch.bfloat16)
        args = layout(args)
        blk = Bottleneck(cin, m, 1, proj)
        with torch.no_grad():
            for conv, wt in ((blk.conv1, args["w1"]), (blk.conv3, args["w3"])) + (
                    ((blk.downsample, args["wp"]),) if proj else ()):
                conv.weight.copy_(wt.t()[:, :, None, None])
            blk.conv2.weight.copy_(args["w2"].permute(3, 2, 0, 1))
            for conv, bias in ((blk.conv1, "b1"), (blk.conv2, "b2"), (blk.conv3, "b3")) + (
                    ((blk.downsample, "bp"),) if proj else ()):
                conv.bias.copy_(args[bias])
        blk = blk.to(dev, torch.bfloat16).to(memory_format=torch.channels_last).eval()
        xn = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory

        def unfused(blk=blk, xn=xn):
            with torch.inference_mode():
                return blk(xn)

        line(f"row 12 {label} x [{b}, {h}, {w}, {cin}] M={m} Cout={cout}",
             lambda x=x, args=args: bn.fused_bottleneck(x, **args), unfused,
             smoke.row12_work(b, h, w, cin, m, cout, proj, 2), ops="bf16_ops")
        if sweep:
            sweep_plans(f"row 12 {label}", bn, "bottleneck_plan",
                        (b, h, w, cin, m, cout, 2, proj),
                        lambda x=x, args=args: bn.fused_bottleneck(x, **args))


def preprocess_kernels(smoke, dev, g, tag):
    """Row 17's kernel body and the engine's route (see the module's note)."""
    import torch

    from mmdx_tpu_torch import _build
    from mmdx_tpu_torch.ops import preprocess as pp

    cached = hasattr(pp, "device_tables")
    crop = 224

    def body(batch, dt):
        """The kernel alone: a launch of the entry point with its constants
        on the device."""
        if cached:
            return lambda: pp.preprocess_batch_fused(batch, out_dtype=dt)
        b, h, w, c = batch.shape
        kh, kw, (hlo, hhi), (wlo, whi), scale, shift = pp._fused_consts(
            h, w, 256, crop, pp.IMAGENET_MEAN, pp.IMAGENET_STD)
        consts = [torch.from_numpy(a).to(dev) for a in (kh, kw, hlo, hhi, wlo, whi, scale,
                                                          shift)]
        w0, w1 = int(wlo.min()), int(whi.max())
        rows = max(1, min(16, pp._PREPROC_SMEM // max(1, 4 * (w1 - w0))))
        out = torch.empty((b, crop, crop, 3), dtype=torch.float32, device=dev)

        def call():
            _build.check(_build.lib().mmdx_preprocess(
                batch.data_ptr(), *(t.data_ptr() for t in consts), out.data_ptr(), b, h, w,
                c, crop, rows, w0, w1, _build.stream(batch)), "row 17")
            return out if dt == torch.float32 else out.to(dt)

        return call

    for b, h, w, c in smoke.PRE_SHAPES:
        batch = torch.randint(0, 256, (b, h, w, c), generator=g, dtype=torch.uint8).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            fn = body(batch, dt)
            fn()
            torch.cuda.synchronize()
            k = smoke.graph_ms(fn)
            e = smoke.median_ms(fn)
            route = lambda: pp.preprocess_batch_device(batch, out_dtype=dt)  # noqa: E731
            if cached:
                r = f"{smoke.graph_ms(route) * 1e3:.2f} us device"
            else:
                r = f"{smoke.median_ms(route) * 1e3:.2f} us per call (CUDA events)"
            nbytes, ops = smoke.row17_work(b, h, w, c, 2 if dt == torch.bfloat16 else 4)
            bms, by = smoke.bound(nbytes, f32_ops=ops)
            smoke.log(f"[{tag}] row 17 {smoke.pre_label(b, h, w, c)} {str(dt)[6:]}: device "
                      f"{k * 1e3:.2f} us per call, {e * 1e3:.2f} us with the host (CUDA "
                      f"events); bound {bms * 1e3:.2f} us ({by}), "
                      f"{bms / k:.1%} of it; engine route {r}")


def lm_head_kernels(smoke, dev, g, tag):
    """Rows 10 and 11 beside the dense route at N = 4, 16, 64, 128, 256, L2
    cold and warm (see the module's note)."""
    import torch

    from mmdx_tpu_torch.ops import lm_head

    v, dm, eos = 32128, 512, 1
    flush_buf = torch.zeros(32 * 2 ** 20, dtype=torch.float32, device=dev)  # 128 MB

    def cold(fn, flush):
        return smoke.graph_ms(lambda: (flush(), fn())) - smoke.graph_ms(flush)

    def times(fn):
        """(cold after a write flush, cold after a read flush, warm) device
        us per call."""
        fn()
        torch.cuda.synchronize()
        return (cold(fn, flush_buf.zero_) * 1e3, cold(fn, flush_buf.amax) * 1e3,
                smoke.graph_ms(fn) * 1e3)

    emb = torch.randn(v, dm, generator=g).to(dev, torch.bfloat16)
    w32 = emb.float()  # T5._lm_weight_f32: the cached f32 copy
    for n in (4, 16, 64, 128, 256):
        raw = torch.randn(n, dm, generator=g).to(dev, torch.bfloat16)
        hidden = raw * dm ** -0.5
        mask = (torch.rand(n, v, generator=g) < 0.001).to(dev)
        mask[:, eos] = True
        b, nb = max(1, n // 4), min(4, n)
        scores = torch.randn(b, nb, generator=g).to(dev)

        def dense_logits():
            return (raw * dm ** -0.5).to(torch.float32) @ w32.t()

        def dense_greedy():
            return dense_logits().masked_fill(mask, float("-inf")).argmax(-1)

        def dense_beam():
            x = dense_logits()
            m = x.amax(dim=-1, keepdim=True)
            lse = torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))
            a = x.clone()
            a[:, eos] = float("-inf")
            a = a.masked_fill(mask, float("-inf"))
            adjusted = ((a - m) - lse) + scores.reshape(n, 1)
            return torch.topk(adjusted.reshape(b, nb * v), 2 * nb + 1, dim=1)

        for row, name, dense, what in (
                (10, "lm_head_greedy", dense_greedy, "product, masked_fill, argmax"),
                (11, "lm_head_stats", dense_beam, "product, candidate_topk chain")):
            fn = getattr(lm_head, name)
            kernel = times(lambda: fn(hidden, emb, mask))
            route = times(dense)
            fill = ""
            if row == 11:  # the logits' bytes written in address order, for reference
                logits = torch.empty(n, v, device=dev)
                f = times(lambda: logits.fill_(0.5))
                fill = (f"; fill_ of the [{n}, {v}] f32 logits cold {f[0]:.2f}, {f[1]:.2f} us, "
                        f"warm {f[2]:.2f} us")
            smoke.log(f"[{tag}] row {row} {name} N={n}: device cold (write flush, read "
                      f"flush) {kernel[0]:.2f}, {kernel[1]:.2f} us, warm {kernel[2]:.2f} us "
                      f"per call; dense route ({what}) cold {route[0]:.2f}, {route[1]:.2f} us, "
                      f"warm {route[2]:.2f} us{fill}")


def text_kernels(report, randn, dev, tag):
    """K1, its attention core, K2 and the four GEMM launches of a BERT-base
    layer; through ``ops/gemm.py`` where the checkout has it, else through
    the older ``mmdx_gemm_bf16`` entry point (one launch per product)."""
    import torch

    from mmdx_tpu_torch import _build
    from mmdx_tpu_torch.ops import bert_attn, fused_ffn

    try:
        from mmdx_tpu_torch.ops import gemm
    except ImportError:
        gemm = None
    h, f, heads = 768, 3072, 12
    attn_w = (randn(h, 3 * h, scale=h ** -0.5), randn(3 * h, scale=0.02),
              randn(h, h, scale=h ** -0.5), randn(h, scale=0.02), 1.0 + randn(h, scale=0.1),
              randn(h, scale=0.1))
    for b, l in ((1, 32), (4, 96), (32, 96)):
        m = b * l
        x, qkv = randn(m, h), randn(m, 3 * h)
        kmask = torch.zeros(m, device=dev)
        kmask.reshape(b, l)[:, l - l // 4:] = -1e9
        kw = dict(seq_len=l, num_heads=heads, eps=1e-12)
        report(f"K1 B={b} L={l}",
               lambda: bert_attn.fused_attention_block(x, kmask, *attn_w, **kw))
        if hasattr(bert_attn, "attention_core"):
            core = (lambda: bert_attn.attention_core(qkv, kmask, l, heads))
        else:
            ctx = torch.empty(m, h, device=dev, dtype=torch.bfloat16)
            core = (lambda: _build.check(_build.lib().mmdx_bert_attn(
                qkv.data_ptr(), kmask.data_ptr(), ctx.data_ptr(), b, l, h, heads, 0.125,
                _build.stream(qkv)), "core"))
        report(f"attention core B={b} L={l}", core)
    for m in (32, 384, 3072, 16384):
        a = (randn(m, h), randn(h, f, scale=h ** -0.5), randn(f, scale=0.02),
             randn(f, h, scale=f ** -0.5), randn(h, scale=0.02), 1.0 + randn(h, scale=0.1),
             randn(h, scale=0.1))
        report(f"K2 M={m}", lambda a=a: fused_ffn.fused_ffn_ln(*a, eps=1e-12), calls=10)
        for name, n, k, epi in (("qkv", 3 * h, h, 1), ("attn_out", h, h, 3),
                                ("ffn_in", f, h, 2), ("ffn_out", h, f, 3)):
            x, w, bias = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n, scale=0.02)
            resid = randn(m, n) if epi == 3 else None
            if gemm is not None:
                plan = gemm.gemm_plan(m, n, k, gemm.sms_of(x), split=epi == 3)
                e, bb, rr = (4, None, None) if plan[3] > 1 else (epi, bias, resid)
                y = torch.empty((plan[3], m, n) if plan[3] > 1 else (m, n), device=dev,
                                dtype=torch.bfloat16 if e in (1, 2) else torch.float32)
                fn = (lambda x=x, w=w, bb=bb, rr=rr, y=y, e=e, plan=plan:
                      gemm.gemm(x, w, bb, rr, y, e, plan, name))
                plan_tag = f" plan {plan}"
            else:
                y = torch.empty((m, n), device=dev,
                                dtype=torch.bfloat16 if epi in (1, 2) else torch.float32)
                fn = (lambda x=x, w=w, bias=bias, resid=resid, y=y, epi=epi:
                      _build.check(_build.lib().mmdx_gemm_bf16(
                          x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                          None if resid is None else resid.data_ptr(), y.data_ptr(),
                          m, n, k, epi, _build.stream(x)), name))
                plan_tag = ""
            report(f"GEMM {name} M={m} N={n} K={k}{plan_tag}", fn)
            # the yardstick: the bias epilogue (one bf16 product, no split)
            # beside torch.addmm, the one PyTorch call of that function
            yb = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
            if gemm is not None:
                bplan = gemm.gemm_plan(m, n, k, gemm.sms_of(x))
                bias_fn = (lambda x=x, w=w, bias=bias, yb=yb, bplan=bplan:
                           gemm.gemm(x, w, bias, None, yb, 1, bplan, name))
            else:
                bias_fn = (lambda x=x, w=w, bias=bias, yb=yb:
                           _build.check(_build.lib().mmdx_gemm_bf16(
                               x.data_ptr(), w.data_ptr(), bias.data_ptr(), None, yb.data_ptr(),
                               m, n, k, 1, _build.stream(x)), name))
            report(f"GEMM {name} M={m} N={n} K={k} bias epilogue", bias_fn)
            if m == 384 and name == "qkv":  # the host's share: enqueue only
                bias_fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    bias_fn()
                host = (time.perf_counter() - t0) / 2000 * 1e6
                torch.cuda.synchronize()
                print(f"[{tag}] GEMM {name} M={m} bias epilogue: host {host:.2f} us "
                      f"per call (wrapper, plan, TMA descriptors, launch)", flush=True)
            report(f"torch.addmm {name} M={m} N={n} K={k}",
                   lambda x=x, w=w, bias=bias: torch.addmm(bias, x, w))
            if "--plans" in sys.argv and gemm is not None and m >= 384:
                for plan in ((64, 64, 4, 1), (64, 128, 4, 1), (128, 64, 4, 1),
                             (128, 128, 3, 1), (128, 128, 4, 1)):
                    if n % plan[1]:
                        continue
                    pick = " (picked)" if plan == gemm.gemm_plan(m, n, k, gemm.sms_of(x)) else ""
                    report(f"GEMM {name} M={m} N={n} K={k} bias epilogue plan {plan}{pick}",
                           lambda x=x, w=w, bias=bias, yb=yb, plan=plan:
                           gemm.gemm(x, w, bias, None, yb, 1, plan, name))


if __name__ == "__main__":
    sys.exit(main())
