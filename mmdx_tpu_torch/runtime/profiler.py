"""Tracing and timing helpers over ``torch.profiler``.

Port of ``mmdx_tpu/runtime/profiler.py``:

* ``device_trace(log_dir)`` records CPU activity, and CUDA activity where a
  card is present, around a block and writes a Chrome/Perfetto trace,
  ``<log_dir>/trace.json`` (open it in Perfetto or ``chrome://tracing``);
* ``annotate(name)`` is a named ``record_function`` range inside it;
* ``Timings`` logs host wall-clock scopes; ``scope(name, sync=True)``
  synchronizes the device before it stops the clock, as the JAX module's
  ``block_until_ready``, so a scope around an engine call holds its device
  work. ``summary()`` has the JAX module's keys.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Capture a trace of the block into ``<log_dir>/trace.json``.

        with device_trace("/tmp/mmdx_trace"):
            engine.classify_batch(imgs, texts)

    CUDA activity is recorded where a card is present. The profiler object
    is yielded (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """Named sub-span inside a trace."""
    return torch.profiler.record_function(name)


class Timings:
    """Host-side wall-clock scopes with aggregate stats."""

    def __init__(self):
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def scope(self, name: str, sync: bool = False, device=None):
        """Time the block; with ``sync`` the CUDA device (``device``, else
        the current one) is synchronized before the clock stops. A CPU
        ``device`` has nothing to wait for."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.device(device or "cuda").type == "cuda" \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize(device)
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.records.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_ms": 1e3 * sum(xs) / len(xs),
                "p50_ms": 1e3 * xs_sorted[len(xs) // 2],
                "max_ms": 1e3 * xs_sorted[-1],
            }
        return out
