"""Pipeline entry-point commands.

Port of ``mmdx_tpu/scheduler/commands.py``: the same three commands over the
port's pipelines, with the same styled output, failure notification and
re-raise. They mirror the reference's Django management commands (reference
``backend/api/management/commands/run_daily_feature_pipeline.py:5-21`` and
``run_daily_training_pipeline.py:5-21``).

Usage:
    python -m mmdx_tpu_torch.scheduler.commands [--cpu] run_daily_feature_pipeline
    python -m mmdx_tpu_torch.scheduler.commands [--cpu] run_daily_training_pipeline
    python -m mmdx_tpu_torch.scheduler.commands [--cpu] prepare_raw_data

Each command function takes ``device``: None is the first CUDA card, and a
command raises without one; ``--cpu`` (``device="cpu"``) runs on the CPU.

Environment:
    MMDX_DATA_ROOT      object-store root directory (default ./mmdx_data)
    MMDX_REGISTRY_ROOT  model-registry root (default <data-root>/registry)
    MMDX_FUSION_STEPS   fusion training steps (default 300)
    MMDX_PREP_EXAMPLES  synthetic examples for prepare_raw_data (default 100)
    MMDX_BUNDLE_PATH    where the training command also writes the bundle
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _world():
    from mmdx_tpu_torch.checkpoints.registry import LocalModelRegistry
    from mmdx_tpu_torch.io.feature_store import FeatureStore
    from mmdx_tpu_torch.io.store import LocalFSStore, register_store

    root = Path(os.getenv("MMDX_DATA_ROOT", "mmdx_data"))
    store = register_store(LocalFSStore(root / "store", bucket="medical-ml-bucket"))
    fs = FeatureStore(object_store=store)
    registry = LocalModelRegistry(os.getenv("MMDX_REGISTRY_ROOT", root / "registry"))
    return store, fs, registry


def _run(name, fn):
    """Styled run wrapper + outcome notification (the reference's Celery
    tasks wire send_mail into these pipelines; scheduler/notify.py)."""
    from mmdx_tpu_torch.scheduler.notify import make_event, notifier_from_env

    print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] Starting {name}...")
    try:
        fn()
    except Exception as e:
        print(f"{name} FAILED: {e}", file=sys.stderr)
        try:
            notifier_from_env()(make_event(name, "failed", error=str(e)))
        except Exception as ne:  # notification failure must not mask the run error
            print(f"notify failed: {ne}", file=sys.stderr)
        raise  # re-raise so schedulers mark the run failed (reference :19-21)
    print(f"{name} completed successfully.")


def _device(device):
    from mmdx_tpu_torch.runtime.engine import resolve_device

    return resolve_device(device)


def prepare_raw_data(device=None):
    """One-shot data prep (reference raw_data_pre_preparation.py capability,
    synthetic source offline)."""
    from mmdx_tpu_torch.pipelines.data_prep import (prepare_raw_dataset,
                                                    synthetic_raw_examples)

    _device(device)
    store, _, _ = _world()
    n = int(os.getenv("MMDX_PREP_EXAMPLES", "100"))
    df = prepare_raw_dataset(synthetic_raw_examples(n), store)
    print(f"prepared {len(df)} rows -> {store.url_for('raw_data/dataset.parquet')}")


def run_daily_feature_pipeline(device=None):
    from mmdx_tpu_torch.pipelines.feature_pipeline import run_feature_pipeline

    _device(device)
    store, fs, _ = _world()
    df = run_feature_pipeline(store, fs)
    print(f"inserted {len(df)} rows into feature group")


def run_daily_training_pipeline(device=None):
    from mmdx_tpu_torch.pipelines.training_pipeline import (TrainingOptions,
                                                            run_training_pipeline)

    device = _device(device)
    _, fs, registry = _world()
    result = run_training_pipeline(
        fs, registry,
        options=TrainingOptions(fusion_steps=int(os.getenv("MMDX_FUSION_STEPS", "300"))),
        device=device,
    )
    print(f"published version {result['version']}; metrics {result['metrics']}")


COMMANDS = {
    "prepare_raw_data": prepare_raw_data,
    "run_daily_feature_pipeline": run_daily_feature_pipeline,
    "run_daily_training_pipeline": run_daily_training_pipeline,
}


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m mmdx_tpu_torch.scheduler.commands [--cpu] "
              f"{{{'|'.join(COMMANDS)}}}")
        return 2
    _run(argv[0], lambda: COMMANDS[argv[0]](device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
