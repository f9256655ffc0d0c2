#!/usr/bin/env python
"""Registers, stack and spills of every kernel in ``mmdx_tpu_torch/csrc``,
as ``nvcc -Xptxas -v`` reports them for ``sm_90a``, and the count of its
tensor-core and TMA instructions in the SASS, on a machine with the CUDA
toolkit (no card needed).

    python3 scripts/ptxas_report.py [SOURCE.cu ...]

Compiles each source (default: every ``csrc/*.cu``) with the flags of
``mmdx_tpu_torch/_build.py`` plus ``-Xptxas -v``, one nvcc per source in
parallel, into a temporary object, and prints one line per kernel: its
demangled name (template arguments, no parameters), registers, stack
frame, spill stores and loads, and from ``cuobjdump -sass`` the number of
HGMMA (wgmma on bf16), IGMMA (wgmma on s8), HMMA (mma.sync on bf16), IMMA
(mma.sync on s8), UTMALDG (TMA tile load), LDGSTS (cp.async) and LDSM
(ldmatrix) instructions.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG", "LDGSTS", "LDSM")


def sass_counts(obj: Path) -> dict:
    """{mangled kernel name: {op: count}} from ``cuobjdump -sass``."""
    from mmdx_tpu_torch import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True, text=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    return counts


def main() -> int:
    from mmdx_tpu_torch import _build

    names = sys.argv[1:] or [p.name for p in sorted(_build.CSRC.glob("*.cu"))]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(name, subprocess.Popen(
            [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", f"{tmp}/{name}.o",
             str(_build.CSRC / name)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for name in names]
        rc = 0
        for name, proc in procs:
            _, err = proc.communicate()
            rc |= proc.returncode
            sass = sass_counts(Path(f"{tmp}/{name}.o")) if proc.returncode == 0 else {}
            kernel = None
            for line in err.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    mangled = m.group(1)
                    kernel = subprocess.run(["c++filt", mangled], capture_output=True,
                                            text=True).stdout.strip() or mangled
                    kernel = re.sub(r"\(anonymous namespace\)::", "", kernel).split("(")[0]
                    frame = ""
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m:
                    frame = f"stack {m.group(1)} B, spills {m.group(2)}/{m.group(3)} B"
                m = re.search(r"Used (\d+) registers", line)
                if m and kernel:
                    ops = ", ".join(f"{k} {v}" for k, v in sass.get(mangled, {}).items() if v)
                    print(f"{name}: {kernel}: {m.group(1)} registers, {frame}"
                          + (f"; SASS {ops}" if ops else ""), flush=True)
                    kernel = None
            if proc.returncode:
                print(f"{name}: nvcc failed ({proc.returncode}):\n{err}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
