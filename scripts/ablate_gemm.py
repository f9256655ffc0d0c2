#!/usr/bin/env python
"""Where the bf16 GEMM's time goes (``csrc/gemm.cu``), on one CUDA card.

    python3 scripts/ablate_gemm.py

Builds four variants of the port's kernels from copies of
``mmdx_tpu_torch`` in a temporary directory, each with one part of the
GEMM taken out of ``csrc/gemm.cu`` by a text substitution:

  base          the kernel as it is;
  no epilogue   the consumers return after their last MMA (no bias, no
                staging, no stores);
  no MMA        the wgmma instructions removed (loads, barriers and the
                epilogue stay);
  no loads      the producer arrives on each stage's barrier without a TMA
                copy (the MMAs read whatever the ring holds);

and times each, in turns twice, with the bias epilogue on the plan
``gemm_plan`` picks, at BERT-base's products for the classify rows (M =
3072) and long text's (M = 16384) and at B=4 (M = 384): the device time per
call from a CUDA graph of 20 calls (``chip_smoke.graph_ms``). The variants
compute wrong numbers; only their times mean something. Inputs are made
from seed 0, as in chip_smoke.py.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    src = (ROOT / "mmdx_tpu_torch" / "csrc" / "gemm.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, (old, new) in VARIANTS.items():
            d = Path(tmp) / name.replace(" ", "_")
            shutil.copytree(ROOT / "mmdx_tpu_torch", d / "mmdx_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            if old is not None:
                if src.count(old) != 1:
                    print(f"FAIL: {name}: the text to take out is not in csrc/gemm.cu once")
                    return 1
                (d / "mmdx_tpu_torch" / "csrc" / "gemm.cu").write_text(src.replace(old, new))
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
                r = subprocess.run([sys.executable, "-c", TIME, str(d), str(ROOT), name])
                if r.returncode != 0:
                    return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
