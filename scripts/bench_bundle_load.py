#!/usr/bin/env python
"""Host time to load a full-width ``.mmdx`` bundle, for any checkout of the
PyTorch port.

    python3 scripts/bench_bundle_load.py BUNDLE [PORT_ROOT ...] [--repeat N]

BUNDLE is written first if it does not exist (``new_random_bundle(seed=0)``
at full width: ResNet-50, BERT-base, T5-small, vocab 32128). Each
PORT_ROOT (default: this repository) is a directory whose
``mmdx_tpu_torch`` is imported in a fresh process, so one call can time an
older checkout (for example a ``git archive`` of the parent commit) and
this one in turns; list the roots in the order to run them, such as
parent, change, change, parent. Each process loads the bundle N times and
prints one JSON line: the root, ``load_bundle`` seconds (file read, header
and the variable tree's decode) and ``to_torch`` seconds (the bridge into
the serving modules, on the CPU) per load. The file is read from the page
cache after the first load: these are warm reads. No card is needed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(bundle: Path, repeat: int) -> dict:
    from mmdx_tpu_torch.checkpoints.bundle import load_bundle

    load_s, to_torch_s = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        mb = load_bundle(bundle)
        t1 = time.perf_counter()
        mb.to_torch()
        t2 = time.perf_counter()
        load_s.append(t1 - t0)
        to_torch_s.append(t2 - t1)
        del mb
    return {"load_bundle_s": load_s, "to_torch_s": to_torch_s}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bundle", type=Path)
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.bundle, args.repeat)), flush=True)
        return 0
    if not args.bundle.exists():
        sys.path.insert(0, str(ROOT))
        from mmdx_tpu_torch.checkpoints.bundle import new_random_bundle, save_bundle

        t0 = time.perf_counter()
        save_bundle(new_random_bundle(seed=0), args.bundle, timestamped_copy=False)
        print(f"wrote {args.bundle} ({args.bundle.stat().st_size / 2 ** 20:.0f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for root in args.roots or [ROOT]:
        root = root.resolve()
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
                f"sys.argv = [''] + {[str(args.bundle.resolve()), '--child', '--repeat', str(args.repeat)]!r}; "
                f"sys.path.insert(1, {str(ROOT / 'scripts')!r}); "
                "import bench_bundle_load as b; raise SystemExit(b.main())")
        out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                             capture_output=True, text=True).stdout
        print(json.dumps({"root": str(root), **json.loads(out.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
