"""Training checkpoint and resume with ``torch.save``.

Port of ``mmdx_tpu/checkpoints/orbax_io.py`` (``save_train_state``,
``latest_step``, ``restore_train_state``, at most ``max_to_keep`` = 3 kept).
A state is a dict of tensors and plain values (the fusion trainer's
parameters, optimizer state, step and dropout generator state), written
atomically to ``<directory>/<step>/train_state.pt``, as orbax lays out one
directory per step.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import torch

FILE = "train_state.pt"


def steps(directory: str | Path) -> list[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / FILE).is_file())


def save_train_state(directory: str | Path, state: dict[str, Any], step: int,
                     max_to_keep: int = 3) -> Path:
    """Write ``state`` for ``step``, then drop all but the newest
    ``max_to_keep`` steps."""
    d = Path(directory) / str(step)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (FILE + ".tmp")
    torch.save(state, tmp)
    tmp.replace(d / FILE)
    for old in steps(directory)[:-max_to_keep]:
        shutil.rmtree(Path(directory) / str(old))
    return d / FILE


def latest_step(directory: str | Path) -> int | None:
    s = steps(directory)
    return s[-1] if s else None


def restore_train_state(directory: str | Path, step: int | None = None,
                        map_location=None):
    """-> (state, step) of ``step`` or the latest, or (None, None) when the
    directory holds none."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None, None
    state = torch.load(Path(directory) / str(step) / FILE, map_location=map_location,
                       weights_only=True)
    return state, step
