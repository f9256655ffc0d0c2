"""Feature-store abstraction — the Hopsworks-feature-group equivalent.

Copy of ``mmdx_tpu/io/feature_store.py``, with one repair: the latest-event
dedup sorts by ``event_time`` with a stable sort, so of rows with equal
timestamps the one inserted last wins (the JAX module's default quicksort
left that choice to the sort).

The reference writes cleaned rows into a Hopsworks feature group keyed by
``image_url`` with an ``event_time`` column and reads them back deduplicated to
the latest event (reference ``backend/ml/pipelines/feature_pipeline.py:71-88``,
``training_pipeline.py:72-90``).  This module provides the same surface over a
pluggable backend: parquet-on-object-store for dev/prod-lite, in-memory for
tests.
"""
from __future__ import annotations

import io
from dataclasses import dataclass, field


@dataclass
class FeatureGroup:
    name: str
    version: int
    primary_key: list[str]
    store: "FeatureStore"
    online_enabled: bool = True

    def _key(self) -> str:
        return f"feature_groups/{self.name}_v{self.version}.parquet"

    def _meta_key(self) -> str:
        return f"feature_groups/{self.name}_v{self.version}.meta.json"

    def insert(self, df, wait_for_job: bool = False) -> None:
        """Append rows (adds event_time if missing), persist as parquet.

        Group metadata (primary_key) persists in a sidecar JSON: the
        latest-event dedup contract must hold for readers in OTHER
        processes (the daily training pipeline), not just the process that
        created the group."""
        import json

        import pandas as pd

        df = df.copy()
        if "event_time" not in df.columns:
            df["event_time"] = pd.Timestamp.now(tz="UTC")
        existing = self.read_raw()
        if existing is not None:
            df = pd.concat([existing, df], ignore_index=True)
        buf = io.BytesIO()
        df.to_parquet(buf, index=False)
        self.store.object_store.put(self._key(), buf.getvalue())
        self.store.object_store.put(self._meta_key(), json.dumps({
            "primary_key": self.primary_key,
            "online_enabled": self.online_enabled,
        }).encode())

    def read_raw(self):
        import pandas as pd

        if not self.store.object_store.exists(self._key()):
            return None
        return pd.read_parquet(io.BytesIO(self.store.object_store.get(self._key())))

    def select(self, columns: list[str] | None = None):
        return _Query(self, columns)

    def select_all(self):
        return _Query(self, None)

    def read(self, columns: list[str] | None = None, dedup: bool = True):
        """Latest-event_time row per primary key (training_pipeline.py:86-89);
        on equal timestamps the row inserted last."""
        df = self.read_raw()
        if df is None:
            raise LookupError(f"feature group {self.name} v{self.version} is empty")
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


@dataclass
class _Query:
    fg: FeatureGroup
    columns: list[str] | None

    def as_of(self, ts):
        return self

    def read(self):
        return self.fg.read(self.columns)


@dataclass
class FeatureStore:
    object_store: object  # mmdx_tpu_torch.io.store.ObjectStore
    _groups: dict = field(default_factory=dict)

    def get_or_create_feature_group(
        self, name: str, version: int = 1, primary_key: list[str] | None = None,
        online_enabled: bool = True, **_,
    ) -> FeatureGroup:
        key = (name, version)
        if key not in self._groups:
            if primary_key is None:
                # recover the persisted key schema so dedup survives across
                # processes (the writer and the training reader are
                # different runs)
                import json

                meta_key = f"feature_groups/{name}_v{version}.meta.json"
                if self.object_store.exists(meta_key):
                    meta = json.loads(self.object_store.get(meta_key))
                    primary_key = meta.get("primary_key") or None
                    online_enabled = meta.get("online_enabled", online_enabled)
            self._groups[key] = FeatureGroup(
                name=name, version=version, primary_key=primary_key or [],
                store=self, online_enabled=online_enabled,
            )
        return self._groups[key]

    def get_feature_group(self, name: str, version: int = 1) -> FeatureGroup:
        fg = self.get_or_create_feature_group(name, version)
        if fg.read_raw() is None:
            raise LookupError(f"feature group {name} v{version} not found")
        return fg
