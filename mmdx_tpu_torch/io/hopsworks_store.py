"""Gated Hopsworks adapters for the feature-store and model-registry planes.

Copy of ``mmdx_tpu/io/hopsworks_store.py`` over the port's ``save_bundle`` and
``load_bundle``, with one repair: the latest-event dedup sorts by
``event_time`` with a stable sort, so of rows with equal timestamps the one
inserted last wins (the JAX module's default quicksort left that choice to
the sort), as in the port's ``io/feature_store.py``.

The reference's production blob plane is Hopsworks: the feature pipeline
writes cleaned rows into feature group ``cxr_features`` (reference
``backend/ml/pipelines/feature_pipeline.py:71-88``), training reads them back
deduplicated per ``image_url`` (``training_pipeline.py:72-90``), and trained
models are published to / loaded from the project model registry
(``training_pipeline.py:650-803``, ``inference_pipeline.py:37-41,53-139``).

These adapters implement the SAME pluggable surfaces as the local
implementations (``io/feature_store.FeatureStore`` duck-type,
``checkpoints/registry.LocalModelRegistry`` duck-type) over the Hopsworks
client, so pipelines swap backends by construction only:

    fs = HopsworksFeatureStore(project_name="medical_ml_project")
    fg = fs.get_or_create_feature_group("cxr_features", version=1,
                                        primary_key=["image_url"])
    fg.insert(df)                     # -> fg.insert(df, write_options=...)
    df = fg.read(columns, dedup=True) # -> select(...).read() + latest-event dedup

Import-gated like ``io/store.S3Store``: the ``hopsworks`` package is an
optional dependency; without it, construction raises ImportError unless a
``client`` (the hopsworks module or a fake) is injected. Contract tests run against fakes
(tests/test_torch_hopsworks.py) — no live calls anywhere.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from pathlib import Path

DEFAULT_PROJECT = "medical_ml_project"  # training_pipeline.py:60
DEFAULT_FEATURE_GROUP = "cxr_features"  # feature_pipeline.py:69


def _login(client, project_name: str | None):
    """hopsworks.login(project=...) — reference training_pipeline.py:74."""
    if client is None:
        import hopsworks as client  # gated: an optional dependency

    if project_name:
        return client.login(project=project_name)
    return client.login()


class HopsworksFeatureGroup:
    """Adapter over a hopsworks feature-group handle.

    Duck-types ``io/feature_store.FeatureGroup``: insert / select /
    select_all / read(columns, dedup).
    """

    def __init__(self, fg, primary_key: list[str]):
        self._fg = fg
        self.name = getattr(fg, "name", "")
        self.version = getattr(fg, "version", 1)
        self.primary_key = list(primary_key or [])

    def insert(self, df, wait_for_job: bool = False) -> None:
        """Append rows, adding event_time if missing.

        Mirrors feature_pipeline.py:72,87-88 (pd.Timestamp.now event_time;
        ``write_options={"wait_for_job": False}`` so the caller is not
        blocked on the materialization job).
        """
        import pandas as pd

        df = df.copy()
        if "event_time" not in df.columns:
            df["event_time"] = pd.Timestamp.now(tz="UTC")
        self._fg.insert(df, write_options={"wait_for_job": bool(wait_for_job)})

    def select(self, columns: list[str] | None = None):
        return self._fg.select(columns) if columns else self._fg.select_all()

    def select_all(self):
        return self._fg.select_all()

    def read(self, columns: list[str] | None = None, dedup: bool = True):
        """Query + latest-event_time dedup per primary key
        (training_pipeline.py:79-89)."""
        q = self.select(columns)
        df = q.read()
        if dedup and "event_time" in df.columns and self.primary_key:
            df = (
                df.sort_values("event_time", kind="stable")
                .groupby(self.primary_key, as_index=False)
                .tail(1)
                .reset_index(drop=True)
            )
        if columns:
            df = df[[c for c in columns if c in df.columns]]
        return df


class HopsworksFeatureStore:
    """Duck-types ``io/feature_store.FeatureStore`` over a Hopsworks project."""

    def __init__(self, project_name: str | None = None, client=None,
                 project=None):
        if project is None:
            project = _login(client, project_name or os.environ.get(
                "HOPSWORKS_PROJECT", DEFAULT_PROJECT))
        self.project = project
        self._fs = project.get_feature_store()

    def get_or_create_feature_group(
        self, name: str, version: int = 1, primary_key: list[str] | None = None,
        online_enabled: bool = True, **_,
    ) -> HopsworksFeatureGroup:
        """feature_pipeline.py:79-85 call shape (event_time column declared)."""
        fg = self._fs.get_or_create_feature_group(
            name=name,
            version=version,
            primary_key=list(primary_key or ["image_url"]),
            event_time="event_time",
            online_enabled=online_enabled,
        )
        return HopsworksFeatureGroup(fg, primary_key or ["image_url"])

    def get_feature_group(self, name: str, version: int = 1,
                          primary_key: list[str] | None = None):
        """training_pipeline.py:78 read-side handle."""
        fg = self._fs.get_feature_group(name=name, version=version)
        return HopsworksFeatureGroup(fg, primary_key or ["image_url"])


def _sanitize(s: str, max_len: int = 120) -> str:
    """Registry-safe name/description (training_pipeline.py:622-647 intent:
    strip characters Hopsworks rejects, cap length)."""
    s = re.sub(r"[^A-Za-z0-9 _.\-]", "_", str(s)).strip()
    return s[:max_len] if max_len else s


class HopsworksModelRegistry:
    """Duck-types ``checkpoints/registry.LocalModelRegistry`` over the
    Hopsworks model registry.

    Publish stages an artifact directory ``{bundle.mmdx, config.json,
    metrics.json}`` (the native layout LocalModelRegistry uses) and uploads
    it via ``registry_model.save(dir)`` — the same create-then-upload flow as
    the reference (training_pipeline.py:753-770), including the
    python-API-first / generic-API-fallback dance.
    """

    MODEL_NAME = "fusion_model_T5"  # training_pipeline.py:1106

    def __init__(self, project_name: str | None = None, client=None,
                 project=None):
        if project is None:
            project = _login(client, project_name or os.environ.get(
                "HOPSWORKS_PROJECT", DEFAULT_PROJECT))
        self.project = project
        self._mr = project.get_model_registry()

    def versions(self, name: str) -> list[int]:
        models = self._mr.get_models(name=name) or []
        return sorted(m.version for m in models)

    def latest_version(self, name: str) -> int:
        """max version over get_models — inference_pipeline.py:37-41."""
        vs = self.versions(name)
        if not vs:
            raise LookupError(f"No models named '{name}' found.")
        return vs[-1]

    def create_model(self, name: str, bundle, version: int | None = None,
                     metrics: dict | None = None, description: str = "") -> int:
        from mmdx_tpu_torch.checkpoints.bundle import save_bundle

        if version is None:
            vs = self.versions(name)
            version = (vs[-1] + 1) if vs else 1
        safe_name = _sanitize(name, 120)
        safe_desc = _sanitize(description, 250)
        f = bundle.config.fusion
        schema = {"input": [1, f.d_img + f.d_txt], "output": [1, f.n_disease]}
        tmp = tempfile.mkdtemp(prefix="mmdx_registry_")
        try:
            bundle.version = version
            save_bundle(bundle, Path(tmp) / "bundle.mmdx",
                        timestamped_copy=False)
            (Path(tmp) / "config.json").write_text(
                json.dumps(bundle.config.to_reference_json(), indent=2))
            (Path(tmp) / "metrics.json").write_text(json.dumps(
                {"metrics": metrics or {}, "description": safe_desc,
                 "model_schema": schema}, indent=2))
            try:
                registry_model = self._mr.python.create_model(
                    name=safe_name, version=version, metrics=metrics or {},
                    description=safe_desc)
            except Exception:
                # python model API first, generic fallback
                # (training_pipeline.py:753-767)
                registry_model = self._mr.create_model(
                    name=safe_name, version=version, metrics=metrics or {},
                    description=safe_desc)
            registry_model.save(tmp)
            return int(getattr(registry_model, "version", version))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def get_model(self, name: str, version: int | None = None):
        """Download the artifact dir and load the native bundle
        (inference_pipeline.py:53-139 flow, native format)."""
        from mmdx_tpu_torch.checkpoints.bundle import load_bundle

        if version is None:
            version = self.latest_version(name)
        model = self._mr.get_model(name=name, version=version)
        local_dir = Path(model.download())
        bundle = load_bundle(local_dir / "bundle.mmdx")
        bundle.version = version
        return bundle

    def get_metrics(self, name: str, version: int | None = None) -> dict:
        if version is None:
            version = self.latest_version(name)
        model = self._mr.get_model(name=name, version=version)
        local_dir = Path(model.download())
        p = local_dir / "metrics.json"
        return json.loads(p.read_text()) if p.exists() else {}
