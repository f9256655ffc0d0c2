#!/usr/bin/env python
"""How often ``torch.profiler`` records no device activity for a short
window on one CUDA card, by the way the window is taken.

    python3 scripts/profiler_windows.py [--windows N] [VARIANT ...]

Each variant runs in a process of its own (a fresh CUPTI), builds the port's
kernels, and takes WINDOWS profiler windows of CALLS calls of the streamed
lm head's greedy kernel (row 10, N = 64, T5 vocabulary 32128 x 512, one
kernel a call), the short window ``chip_smoke.py`` took to count launches
before it read them from a captured graph (``chip_smoke.graph_nodes``). It
prints, per variant, the windows whose trace held no CUDA kernel event, and
the kernels counted per call in the others:

  plain       synchronize, ``profile(activities=[CPU, CUDA])``, the calls,
              synchronize, exit (``chip_smoke.py``'s window before this
              script);
  cuda-only   the same with ``activities=[CUDA]``;
  warm        one window taken and thrown away first, then as plain;
  sleep       as plain, with 20 ms of sleep after the last synchronize,
              inside the window;
  long        as plain with 40 calls a window;
  graphs      as plain, each window after a CUDA graph of 20 calls is
              captured and replayed 12 times (``chip_smoke.graph_ms``);
  graphs-warm as graphs, with a window taken and thrown away between the
              graph and the counted window;
  graphs-sleep  as graphs, with 50 ms of sleep between them;
  graphs-long as graphs, the counted window 40 calls long;
  smoke       as plain, each window in ``chip_smoke.phase_lm_head``'s
              order: the calls checked, the window, 33 calls timed between
              CUDA events, then a CUDA graph captured and replayed.

Without arguments every variant runs, one process each; ``--windows N``
takes N windows a variant (default 40).
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("plain", "cuda-only", "warm", "sleep", "long", "graphs", "graphs-warm",
            "graphs-sleep", "graphs-long", "smoke")
WINDOWS, CALLS = 40, 5  # default windows a variant, calls a window


def count_kernels(prof) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def window(variant: str, fn) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if variant.startswith("graphs") or variant == "smoke":
        import chip_smoke

        if variant == "smoke":
            fn()
            k = window("plain", fn)
            chip_smoke.median_ms(fn)
            chip_smoke.graph_ms(fn)
            return k
        chip_smoke.graph_ms(fn)
        if variant == "graphs-warm":
            window("plain", fn)
        elif variant == "graphs-sleep":
            time.sleep(0.05)
        variant = "long" if variant == "graphs-long" else "plain"
    acts = ([ProfilerActivity.CUDA] if variant == "cuda-only"
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    calls = 40 if variant == "long" else CALLS
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if variant == "sleep":
            time.sleep(0.02)
    return count_kernels(prof) / calls


def run(variant: str, windows: int) -> int:
    import torch

    from mmdx_tpu_torch.ops import lm_head

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda", 0)
    v, d, n = 32128, 512, 64
    emb = torch.randn(v, d, generator=g).to(dev, torch.bfloat16)
    hidden = (torch.randn(n, d, generator=g) * d ** -0.5).to(dev, torch.bfloat16)
    mask = (torch.rand(n, v, generator=g) < 0.001).to(dev)

    def fn():
        return lm_head.lm_head_greedy(hidden, emb, mask)

    fn()
    if variant == "warm":
        window("plain", fn)
    per_call = [window(variant, fn) for _ in range(windows)]
    empty = [i for i, k in enumerate(per_call) if k == 0]
    kept = sorted({k for k in per_call if k})
    print(f"{variant}: {len(empty)} of {windows} windows recorded no kernel "
          f"(windows {empty}); kernels per call in the others {kept}", flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    windows = WINDOWS
    if "--windows" in args:
        i = args.index("--windows")
        windows = int(args[i + 1])
        del args[i:i + 2]
    if len(args) == 1:
        return run(args[0], windows)
    rc = 0
    for name in args or VARIANTS:
        rc |= subprocess.run([sys.executable, __file__, name, "--windows",
                              str(windows)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
