#!/usr/bin/env python
"""Where the time of the wgmma GEMMs goes, on one CUDA card: the bf16 GEMM
(``csrc/gemm.cu``), with ``--int8`` the int8 GEMM (``csrc/int8_gemm.cu``),
with ``--lm-head`` the streamed lm head (``csrc/lm_head.cu``, rows 10, 11),
with ``--bottleneck`` the fused bottlenecks' implicit GEMM
(``csrc/implicit_gemm.cuh``, rows 12, 13), with ``--preprocess`` the fused
preprocessing (``csrc/preprocess.cu``, row 17).

    python3 scripts/ablate_gemm.py [--int8 | --lm-head | --bottleneck | --preprocess]
                                   [--only=VARIANT,VARIANT]

Builds variants of the port's kernels from copies of ``mmdx_tpu_torch`` in
a temporary directory, each with one part of the GEMM taken out of its
source by a text substitution:

  base          the kernel as it is;
  no epilogue   the consumers return after their last MMA (no bias, no
                staging, no stores);
  no MMA        the wgmma instructions removed (loads, barriers and the
                epilogue stay);
  no loads      the producer arrives on each stage's barrier without a TMA
                copy (the MMAs read whatever the ring holds);
  no divide     (int8) the requant's rint(y / s_out) as a multiply by the
                reciprocal alone: no true division, no check for a tie;
  no merge      (lm head) the stats' CTAs return after their epilogue and
                ticket: no wait for the count, no merge of the partials;
  no logits     (lm head) the stats' logits are not stored;
  one logits chunk  (lm head) every CTA stores its logits over chunk 0's
                columns: the same bytes, a 64 KB footprint that stays in L2;
  streaming stores  (lm head) the logits stored with st.global.cs
                (evict first);
  no conv2      (bottleneck) the 3x3 conv's nine taps are not run (conv3
                reads whatever the a2 tile holds);
  no loads      (bottleneck) no cp.async copy of x rows or weights into the
                ring (the MMAs read whatever the ring holds);
  no epilogue   (bottleneck) a1, a2 and the outputs are not stored (the
                stores stay behind a test the compiler cannot decide, so the
                MMAs whose sums they would store stay too);
  no row pass, no column pass, no passes  (preprocess) the pass (or both)
                is skipped (the next step reads whatever shared memory holds);
  no loads      (preprocess) no cp.async copy of the input rows;
  no stores     (preprocess) the output leaves shared memory behind a test
                the compiler cannot decide, never taken;
  no passes, loads or stores  (preprocess) the block's loop, tables and
                barriers alone;
  one lane, four lanes  (preprocess) each thread sums one (four) of the
                row pass's quads at a time (two in the kernel);
  no conversion (preprocess) the row pass's bytes are not converted to
                f32 (each 32-bit word is read as a float);

and times each, in turns twice: the bf16 GEMM with the bias epilogue on the
plan ``gemm_plan`` picks, at BERT-base's products for the classify rows (M =
3072) and long text's (M = 16384) and at B=4 (M = 384); the int8 GEMM at
chip_smoke.py's K5 sites (the gray stem at B=32 and B=512, layer1 conv1,
layer4 conv3 + residual) and at the text blocks' four projections with their
epilogues at M = 3072: the device time per call from a CUDA graph of 20
calls (``chip_smoke.graph_ms``); the bottlenecks at B=32, row 12 at stage 1
block 0 and stage 2, row 13 at stages 1 and 2, as a graph of 20 calls; row
17 at B=32 512x512 RGB and gray and 256x256 RGB, f32 out, as a graph of 20
calls, each at the plan's blocks an SM and at three and at four, at
512x512 RGB also with the bands' height TRo capped at 4 and 16 and with a
block a band (no persistent loop); the lm head's greedy at N = 4 and 64 and
stats at N = 16, 128 and 256 (T5 vocabulary 32128 x 512), each with L2
warm (a graph of 20 calls) and cold (a graph of 20 pairs of a 128 MB read
and a call, less the reads alone). The variants compute wrong numbers; only
their times mean something. Inputs are made from seed 0, as in
chip_smoke.py.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MAIN_LOOP_WAIT = "  wgmma_wait<0>();\n  fence_operands(acc);\n"
MMA = """      wgmma_tile<BN>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                     wgmma_desc(b + kk * 16 * (BK * 2), BOX, 1024));"""
LOADS = """        mbar_expect_tx(&full[s], STAGE);
        const int kc = (k0 + i) * BK;
        tma_load_2d(st, &map_a, kc, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + A_BYTES + c * BOX, &map_b, n0 + c * 64, kc, &full[s]);"""
VARIANTS = {
    "base": (None, None),
    "no epilogue": (MAIN_LOOP_WAIT, MAIN_LOOP_WAIT + "  if (M > 0) return;\n"),
    "no MMA": (MMA, "      ;"),
    "no loads": (LOADS, "        mbar_arrive(&full[s]);"),
}

I8_MAIN_LOOP_WAIT = """  wgmma_wait<0>();
  fence_operands(acc);
  if constexpr (kDual) fence_operands(acc2);
"""
I8_MMA = """        if constexpr (kDual) {
          if (second) wgmma_s8<BN>(acc2, da, db);
          else wgmma_s8<BN>(acc, da, db);
        } else {
          wgmma_s8<BN>(acc, da, db);
        }"""
I8_LOADS = """        mbar_expect_tx(&full[s], STAGE);
        const bool second = kDual && i >= steps1;
        const int kc = (second ? i - steps1 : i) * BK;
        tma_load_2d(st, second ? map_a2 : map_a, kc, m0, &full[s]);
        tma_load_2d(st + A_BYTES, second ? map_b2 : map_b, kc, n0, &full[s]);"""
I8_TIE = ("  if (fabsf(__fsub_rn(t, q)) > 0.5f - 0x1p-12f) "
          "q = rintf(__fdiv_rn(y, s_out));\n")
I8_VARIANTS = {
    "base": (None, None),
    "no epilogue": (I8_MAIN_LOOP_WAIT, I8_MAIN_LOOP_WAIT + "  if (p.M > 0) return;\n"),
    "no MMA": (I8_MMA, "        ;"),
    "no loads": (I8_LOADS, "        (void)st;\n        mbar_arrive(&full[s]);"),
    "no divide": (I8_TIE, ""),
}

LM_EPILOGUE = """      epilogue<STATS>(acc, smem + s * STAGE + wg * 64 * CHUNK, p, g * RG + wg * 64, chunk, t);
"""
LM_LOGITS = """        store_logits(acc, p, g * RG + wg * 64, chunk, t);
"""
LM_MMA = """          wgmma_bf16_m64n128<0>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                                wgmma_desc(b + kk * 32, 16, 1024));"""
LM_LOADS = """          if (k < p.ksteps) {
            mbar_expect_tx(&full[s], STAGE);
            tma_load_2d(st, &map_e, k * BK, col0, &full[s]);
            tma_load_2d(st + EMB_BOX, &map_h, k * BK, g * RG, &full[s]);
          } else {
            mbar_expect_tx(&full[s], RG * CHUNK);
            tma_load_2d(st, &map_m, col0, g * RG, &full[s]);
          }"""
LM_MERGE = """    __syncthreads();
    const int k = (int)(ticket % C) - (C - R);"""
LM_STORE = """        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);"""
LM_OUT = "float* out = p.logits + (size_t)n * p.V + chunk * CHUNK + 2 * (t % 4);"
LM_VARIANTS = {
    "base": (None, None),
    "no epilogue": [(LM_EPILOGUE, ""), (LM_LOGITS, "")],
    "no MMA": (LM_MMA, "          ;"),
    "no loads": (LM_LOADS, "          (void)st;\n          mbar_arrive(&full[s]);"),
    "no merge": (LM_MERGE, "    if (p.N > 0) return;\n" + LM_MERGE),
    "no logits": (LM_STORE, "        (void)out;"),
    "one logits chunk": (LM_OUT, LM_OUT.replace("chunk * CHUNK + ", "")),
    "streaming stores": (LM_STORE, LM_STORE.replace(
        "*reinterpret_cast<float2*>(out + 8 * j) =", "__stcs(reinterpret_cast<float2*>(out + 8 * j),")
        .replace("acc[4 * j + 2 * h + 1]);", "acc[4 * j + 2 * h + 1]));")),
}

LM_TIME = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from mmdx_tpu_torch.ops import lm_head
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(cs.SEED)
v, dm = 32128, 512
emb = torch.randn(v, dm, generator=g).to(dev, torch.bfloat16)
buf = torch.zeros(32 * 2 ** 20, device=dev)
parts = []
for name, n in (("greedy", 4), ("greedy", 64), ("stats", 16), ("stats", 128), ("stats", 256)):
    h = (torch.randn(n, dm, generator=g) * dm ** -0.5).to(dev, torch.bfloat16)
    mask = (torch.rand(n, v, generator=g) < 0.001).to(dev)
    fn = getattr(lm_head, "lm_head_" + name)
    call = lambda: fn(h, emb, mask)
    warm = cs.graph_ms(call)
    cold = cs.graph_ms(lambda: (buf.amax(), call())) - cs.graph_ms(buf.amax)
    parts.append(f"{name} N={n} cold {cold * 1e3:.2f} us, warm {warm * 1e3:.2f} us")
cs.log(f"{sys.argv[3]}: " + "; ".join(parts))
"""

TIME = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from mmdx_tpu_torch.ops import gemm
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(cs.SEED)
def rn(*s, scale=1.0):
    return (torch.randn(*s, generator=g) * scale).to(dev, torch.bfloat16)
parts = []
for m in (384, 3072, 16384):
    for n, k in ((2304, 768), (768, 768), (3072, 768), (768, 3072)):
        a, b, bias = rn(m, k), rn(k, n, scale=k ** -0.5), rn(n, scale=0.02)
        y = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
        plan = gemm.gemm_plan(m, n, k, gemm.sms_of(a))
        t = cs.graph_ms(lambda: gemm.gemm(a, b, bias, None, y, 1, plan, "x"))
        parts.append(f"M={m} N={n} K={k} {plan} {t * 1e3:.2f} us")
cs.log(f"{sys.argv[3]}: " + "; ".join(parts))
"""

I8_TIME = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops import int8_gemm as k5
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(cs.SEED)
def s8(*s):
    return torch.randint(-127, 128, s, generator=g, dtype=torch.int8).to(dev)
def f32(*s):
    return (1e-3 + 1e-2 * torch.rand(*s, generator=g)).to(dev)
parts = []
for name, m, k, n, res, rows in (("gray stem B=32", 401408, 64, 64, False, 12544),
                                 ("gray stem B=512", 6422528, 64, 64, False, 12544),
                                 ("layer1 conv1", 100352, 256, 64, False, 0),
                                 ("layer4 conv3 + res", 1568, 512, 2048, True, 0)):
    x, w, alpha = s8(m, k), s8(n, k), f32(n)
    bias = f32(rows, n) if rows else f32(n)
    r = s8(m, n) if res else None
    fn = ((lambda: k5.int8_gemm_res_requant(x, w, alpha, bias, r, 0.01, 0.37)) if res
          else (lambda: k5.int8_gemm_requant(x, w, alpha, bias, 0.37)))
    parts.append(f"{name} {k5.int8_gemm_plan(m, n, k)} {cs.graph_ms(fn) * 1e3:.2f} us")
m = 3072
for name, n, k, epi in cs.TEXT_PROJECTIONS:
    x, w, rs, cs_ = s8(m, k), s8(n, k), f32(m), f32(n)
    bias = f32(n).to(torch.bfloat16)
    resid = s8(m, n).to(torch.bfloat16) if "RESID" in epi else None
    dt = torch.bfloat16 if epi == "DQ_BF16" else torch.float32
    e = getattr(_build, epi)
    t = cs.graph_ms(lambda: k5.gemm_dequant(x, w, rs, cs_, bias, resid, dt, e))
    parts.append(f"{name} M={m} {k5.int8_gemm_plan(m, n, k)} {t * 1e3:.2f} us")
cs.log(f"{sys.argv[3]}: " + "; ".join(parts))
"""


BN_MMA = [("""      E::mma(acc[0][2 * j], fa0, fb[j][0], fb[j][1]);
      E::mma(acc[0][2 * j + 1], fa0, fb[j][2], fb[j][3]);""", "      (void)fb;"),
          ("""        E::mma(acc[1][2 * j], fa1, fb[j][0], fb[j][1]);
        E::mma(acc[1][2 * j + 1], fa1, fb[j][2], fb[j][3]);""", "        (void)fa1;")]
BN_VARIANTS = {
    "base": (None, None),
    "no conv2": [("    conv2<E, 2>(p, bd);\n", ""), ("    conv2<E, 1>(p, bd);\n", "")],
    "no loads": [("""    cp_async16(slot + n * SLOT_PITCH + part * 16,
               base + (size_t)(n0 + n) * ld_bytes + kb + part * 16);""", "    (void)base;"),
                 ("    cp_async16(slot + r * SLOT_PITCH + part * 16, src, ok);",
                  "    (void)src;")],
    "no epilogue": [(f"E::store({dst} + ", f"if (p.H < 0) E::store({dst} + ")
                    for dst in ("dst", "a2row", "stage")]
                   + [("*reinterpret_cast<uint4*>(out + ",
                       "if (p.H < 0) *reinterpret_cast<uint4*>(out + ")],
    "no MMA": BN_MMA,
}

BN_TIME = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from mmdx_tpu_torch.ops import bottleneck as bn
from mmdx_tpu_torch.ops import int8_bottleneck as ib
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(cs.SEED)
parts = []
for label, hw, cin, m, cout, proj in (("row 12 stage 1 block 0", 56, 64, 64, 256, True),
                                      ("row 12 stage 2", 28, 512, 128, 512, False)):
    x, a = cs.row12_operands(g, dev, 32, hw, hw, cin, m, cout, proj, torch.bfloat16)
    parts.append(f"{label} {cs.graph_ms(lambda: bn.fused_bottleneck(x, **a)) * 1e3:.2f} us")
for label, hw, c, m in (("row 13 stage 1", 56, 256, 64), ("row 13 stage 2", 28, 512, 128)):
    x, a = cs.row13_operands(g, dev, 32, hw, hw, c, m)
    parts.append(f"{label} {cs.graph_ms(lambda: ib.fused_bottleneck_int8(x, **a)) * 1e3:.2f} us")
cs.log(f"{sys.argv[3]}: " + "; ".join(parts))
"""

PP_ROW = "    // row pass: tmp[i][j*C + c]"
PP_COL_IF = "    for (int o = tid; o < p.crop; o += PP_THREADS) {"
PP_VARIANTS = {
    "base": (None, None),
    "no row pass": (PP_ROW, "    if (p.H < 0)\n" + PP_ROW),
    "no column pass": (PP_COL_IF, "    if (p.H < 0)\n" + PP_COL_IF),
    "no passes": [(PP_ROW, "    if (p.H < 0)\n" + PP_ROW),
                  (PP_COL_IF, "    if (p.H < 0)\n" + PP_COL_IF)],
    "no passes, loads or stores": [
        (PP_ROW, "    if (p.H < 0)\n" + PP_ROW),
        (PP_COL_IF, "    if (p.H < 0)\n" + PP_COL_IF),
        ("      cp_async16(buf + 16 * k, p.img + g);", "      (void)g;"),
        ("    for (int k = tid; k < vecs; k += PP_THREADS) dst[k] = src[k];",
         "    if (p.H < 0)\n      for (int k = tid; k < vecs; k += PP_THREADS) dst[k] = src[k];")],
    "no loads": ("      cp_async16(buf + 16 * k, p.img + g);", "      (void)g;"),
    "no stores": ("    for (int k = tid; k < vecs; k += PP_THREADS) dst[k] = src[k];",
                  "    if (p.H < 0)\n      for (int k = tid; k < vecs; k += PP_THREADS) "
                  "dst[k] = src[k];"),
    "one lane": ("constexpr int PP_LANES = 2;", "constexpr int PP_LANES = 1;"),
    "four lanes": ("constexpr int PP_LANES = 2;", "constexpr int PP_LANES = 4;"),
    "no conversion": ("fmaf(c, byte_to_f32(v, k), s[l][k])",
                      "fmaf(c, __uint_as_float(v + k), s[l][k])"),
}

PP_TIME = r"""
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from mmdx_tpu_torch.ops import preprocess as pp
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(cs.SEED)
parts = []
for b, h, w, c in ((32, 512, 512, 3), (32, 512, 512, 1), (32, 256, 256, 3)):
    x = torch.randint(0, 256, (b, h, w, c), generator=g, dtype=torch.uint8).to(dev)
    kept = pp.BLOCK_CHOICES
    for choices in (kept, (3,), (4,)):
        pp.BLOCK_CHOICES = choices
        pp.preprocess_plan.cache_clear()
        plan = pp.preprocess_plan(b, h, w, c, 256, 224, 4)
        parts.append(f"{cs.pre_label(b, h, w, c)} {plan.blocks} blocks an SM (held "
                     f"{pp.blocks_per_sm(plan)}) of TRo={plan.tro} "
                     f"{cs.graph_ms(lambda: pp.preprocess_batch_fused(x)) * 1e3:.2f} us")
    pp.BLOCK_CHOICES = kept
    pp.preprocess_plan.cache_clear()
    if (h, c) != (512, 3):
        continue
    for tro in (4, 16):
        pp.MAX_TRO, kept = tro, pp.MAX_TRO
        pp.preprocess_plan.cache_clear()
        parts.append(f"TRo={pp.preprocess_plan(b, h, w, c, 256, 224, 4).tro} "
                     f"{cs.graph_ms(lambda: pp.preprocess_batch_fused(x)) * 1e3:.2f} us")
        pp.MAX_TRO = kept
        pp.preprocess_plan.cache_clear()
    planner = pp.preprocess_plan
    pp.preprocess_plan = lambda *a: planner(*a)._replace(grid=b * -(-224 // planner(*a).tro))
    parts.append(f"a block a band {cs.graph_ms(lambda: pp.preprocess_batch_fused(x)) * 1e3:.2f} us")
    pp.preprocess_plan = planner
cs.log(f"{sys.argv[3]}: " + "; ".join(parts))
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    source, variants, timer = (
        ("int8_gemm.cu", I8_VARIANTS, I8_TIME) if "--int8" in sys.argv[1:]
        else ("lm_head.cu", LM_VARIANTS, LM_TIME) if "--lm-head" in sys.argv[1:]
        else ("implicit_gemm.cuh", BN_VARIANTS, BN_TIME) if "--bottleneck" in sys.argv[1:]
        else ("preprocess.cu", PP_VARIANTS, PP_TIME) if "--preprocess" in sys.argv[1:]
        else ("gemm.cu", VARIANTS, TIME))
    src = (ROOT / "mmdx_tpu_torch" / "csrc" / source).read_text()
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    if only:  # --only=base,two lanes: these variants alone
        variants = {k: v for k, v in variants.items() if k in only[0]}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, edit in variants.items():
            d = Path(tmp) / name.replace(" ", "_")
            shutil.copytree(ROOT / "mmdx_tpu_torch", d / "mmdx_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            text = src
            # one (old, new) substitution, or a list of them
            for old, new in (edit if isinstance(edit, list) else [edit]):
                if old is None:
                    continue
                if text.count(old) != 1:
                    print(f"FAIL: {name}: the text to take out is not in csrc/{source} once")
                    return 1
                text = text.replace(old, new)
            (d / "mmdx_tpu_torch" / "csrc" / source).write_text(text)
            builds[name] = (d, subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                 "from mmdx_tpu_torch import _build; _build.build()", str(d)]))
        for name, (_, proc) in builds.items():
            if proc.wait() != 0:
                print(f"FAIL: {name}: build failed")
                return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", flush=True)
        for _ in range(2):
            for name, (d, _) in builds.items():
                r = subprocess.run([sys.executable, "-c", timer, str(d), str(ROOT), name])
                if r.returncode != 0:
                    return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
