"""Feature pipeline: raw parquet -> validated features -> feature store.
Copy of ``mmdx_tpu/pipelines/feature_pipeline.py``.

Mirrors the reference ``backend/ml/pipelines/feature_pipeline.py``:
``load_raw_data`` (:61-66) reads the prepared parquet from the object store and
enforces the schema (:41-58); ``save_cleaned_raw_data_to_feature_store``
(:71-88) stamps ``event_time`` and inserts into the ``cxr_features`` group
keyed by ``image_url``.
"""
from __future__ import annotations

import io

import numpy as np

FEATURE_GROUP_NAME = "cxr_features"  # reference feature_pipeline.py:69
FEATURE_GROUP_VERSION = 1
RAW_COLUMNS = ["image_url", "patient_details", "disease_classification_vector", "report"]
N_DISEASES = 13


def enforce_raw_data_columns(df):
    """Schema/dtype validation (reference :41-58 — including the 13-length
    disease-vector check; the reference's error text says 14, a known quirk)."""
    df = df.copy()
    missing = [c for c in RAW_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(f"raw data missing columns: {missing}")
    for col in ("image_url", "patient_details", "report"):
        df[col] = df[col].astype(str)

    def to_vec(v):
        arr = np.asarray(list(v), dtype=np.float32)
        if arr.shape != (N_DISEASES,):
            raise ValueError(
                f"Expected disease vector of length {N_DISEASES}, got {arr.shape}"
            )
        return arr

    df["disease_classification_vector"] = df["disease_classification_vector"].map(to_vec)
    return df[RAW_COLUMNS]


def load_raw_data(store, parquet_key: str = "raw_data/dataset.parquet"):
    """Read + validate the prepared dataset parquet (reference :61-66)."""
    import pandas as pd

    df = pd.read_parquet(io.BytesIO(store.get(parquet_key)), columns=RAW_COLUMNS)
    return enforce_raw_data_columns(df)


def save_cleaned_raw_data_to_feature_store(df, feature_store) -> None:
    """Stamp event_time + upsert into the feature group (reference :71-88)."""
    import pandas as pd

    df = df.copy()
    df["event_time"] = pd.Timestamp.now(tz="UTC")
    fg = feature_store.get_or_create_feature_group(
        name=FEATURE_GROUP_NAME,
        version=FEATURE_GROUP_VERSION,
        primary_key=["image_url"],
        online_enabled=True,
    )
    fg.insert(df, wait_for_job=False)


def load_features_labels_from_feature_store(feature_store):
    """Training-side read with latest-event dedup (training_pipeline.py:72-90)."""
    fg = feature_store.get_feature_group(FEATURE_GROUP_NAME, FEATURE_GROUP_VERSION)
    cols = RAW_COLUMNS + ["event_time"]
    return fg.read(columns=cols)


def run_feature_pipeline(store, feature_store,
                         parquet_key: str = "raw_data/dataset.parquet"):
    """End-to-end daily feature pipeline (reference feature_pipeline_tests, :92-101)."""
    df = load_raw_data(store, parquet_key)
    save_cleaned_raw_data_to_feature_store(df, feature_store)
    return df
