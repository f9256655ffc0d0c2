"""The port's Hopsworks adapters (``io/hopsworks_store.py``) on the CPU,
with fake clients and no live calls: the JAX package's contract cases
(``tests/test_hopsworks_adapters.py``), with the fakes copied from there, and
the stable dedup: 64 keys inserted twice under one timestamp, where the row
inserted last wins for every key. The JAX adapter's default quicksort does
not promise that (it kept the later row for 3 of the 64 keys with pandas
3.0.3 and numpy 2.0.2).

Each test is held to 120 s by an alarm, and a watchdog ends a worker blocked
past 180 s.
"""
import faulthandler
import json
import shutil
import signal
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from mmdx_tpu_torch.checkpoints.bundle import new_random_bundle
from mmdx_tpu_torch.checkpoints.train_bridge import flatten
from mmdx_tpu_torch.io.hopsworks_store import (HopsworksFeatureStore,
                                               HopsworksModelRegistry, _sanitize)


@pytest.fixture(autouse=True)
def time_guard():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


# ---------------------------------------------------------------- fakes
class FakeQuery:
    def __init__(self, df, columns):
        self._df = df
        self._cols = columns

    def as_of(self, ts):
        return self

    def read(self):
        df = self._df.copy()
        if self._cols:
            df = df[[c for c in self._cols if c in df.columns]]
        return df


class FakeFG:
    def __init__(self, name, version, primary_key, event_time, online_enabled):
        self.name = name
        self.version = version
        self.primary_key = primary_key
        self.event_time = event_time
        self.online_enabled = online_enabled
        self.df = pd.DataFrame()
        self.insert_calls = []

    def insert(self, df, write_options=None):
        self.insert_calls.append({"write_options": write_options})
        self.df = pd.concat([self.df, df], ignore_index=True)

    def select(self, columns):
        return FakeQuery(self.df, columns)

    def select_all(self):
        return FakeQuery(self.df, None)


class FakeFS:
    def __init__(self):
        self.groups = {}

    def get_or_create_feature_group(self, name, version, primary_key,
                                    event_time, online_enabled):
        key = (name, version)
        if key not in self.groups:
            self.groups[key] = FakeFG(name, version, primary_key, event_time,
                                      online_enabled)
        return self.groups[key]

    def get_feature_group(self, name, version):
        return self.groups[(name, version)]


class FakeRegistryModel:
    def __init__(self, name, version, metrics, description, store_dir):
        self.name = name
        self.version = version
        self.metrics = metrics
        self.description = description
        self._store_dir = store_dir

    def save(self, local_dir):
        dest = self._store_dir / self.name / f"v{self.version}"
        if dest.exists():
            shutil.rmtree(dest)
        shutil.copytree(local_dir, dest)

    def download(self):
        return str(self._store_dir / self.name / f"v{self.version}")


class FakePythonAPI:
    def __init__(self, registry, fail=False):
        self._registry = registry
        self.fail = fail
        self.calls = []

    def create_model(self, name, version, metrics, description):
        self.calls.append(name)
        if self.fail:
            raise RuntimeError("python API unavailable")
        return self._registry._make(name, version, metrics, description)


class FakeModelRegistry:
    def __init__(self, store_dir, python_fails=False):
        self._store_dir = Path(store_dir)
        self.models = {}  # name -> {version: FakeRegistryModel}
        self.python = FakePythonAPI(self, fail=python_fails)
        self.generic_calls = []

    def _make(self, name, version, metrics, description):
        m = FakeRegistryModel(name, version, metrics, description,
                              self._store_dir)
        self.models.setdefault(name, {})[version] = m
        return m

    def create_model(self, name, version, metrics, description):
        self.generic_calls.append(name)
        return self._make(name, version, metrics, description)

    def get_models(self, name):
        return list(self.models.get(name, {}).values())

    def get_model(self, name, version):
        return self.models[name][version]


class FakeProject:
    def __init__(self, fs=None, mr=None):
        self._fs = fs
        self._mr = mr

    def get_feature_store(self):
        return self._fs

    def get_model_registry(self):
        return self._mr


class FakeHopsworksModule:
    """Stands in for `import hopsworks` in the login path."""

    def __init__(self, project):
        self._project = project
        self.login_calls = []

    def login(self, project=None):
        self.login_calls.append(project)
        return self._project


# ---------------------------------------------------------------- feature store
def _rows(urls, t0="2026-01-01", step_s=1):
    ts = pd.Timestamp(t0, tz="UTC")
    return pd.DataFrame({
        "image_url": urls,
        "patient_details": [f"details {u}" for u in urls],
        "disease_classification_vector": [np.zeros(13, np.float32).tolist() for _ in urls],
        "report": [f"report {u}" for u in urls],
        "event_time": [ts + pd.Timedelta(seconds=step_s * i) for i in range(len(urls))],
    })


def test_feature_store_insert_contract():
    fake_fs = FakeFS()
    module = FakeHopsworksModule(FakeProject(fs=fake_fs))
    store = HopsworksFeatureStore(project_name="medical_ml_project", client=module)
    assert module.login_calls == ["medical_ml_project"]
    fg = store.get_or_create_feature_group("cxr_features", version=1,
                                           primary_key=["image_url"])
    raw = fake_fs.groups[("cxr_features", 1)]
    assert raw.event_time == "event_time" and raw.online_enabled is True
    assert raw.primary_key == ["image_url"]
    fg.insert(_rows(["s3://b/a.jpg", "s3://b/b.jpg"]).drop(columns=["event_time"]))
    assert raw.insert_calls[0]["write_options"] == {"wait_for_job": False}
    assert "event_time" in raw.df.columns and len(raw.df) == 2


def test_feature_store_read_dedups_latest_event():
    fake_fs = FakeFS()
    store = HopsworksFeatureStore(project=FakeProject(fs=fake_fs))
    fg = store.get_or_create_feature_group("cxr_features", version=1,
                                           primary_key=["image_url"])
    fg.insert(_rows(["s3://b/a.jpg", "s3://b/b.jpg"], "2026-01-01"))
    newer = _rows(["s3://b/a.jpg"], "2026-02-01")
    newer["report"] = ["updated report"]
    fg.insert(newer)
    out = store.get_feature_group("cxr_features", 1, primary_key=["image_url"]).read(
        columns=["image_url", "report", "event_time"])
    assert len(out) == 2
    assert out.set_index("image_url")["report"]["s3://b/a.jpg"] == "updated report"
    assert len(fg.read(dedup=False)) == 3


def test_dedup_of_equal_timestamps_keeps_the_row_inserted_last():
    fake_fs = FakeFS()
    fg = HopsworksFeatureStore(project=FakeProject(fs=fake_fs)).get_or_create_feature_group(
        "cxr_features", version=1, primary_key=["image_url"])
    urls = [f"s3://b/{i:02d}.jpg" for i in range(64)]
    first, second = _rows(urls, step_s=0), _rows(urls, step_s=0)
    second["report"] = [f"second {u}" for u in urls]
    fg.insert(first)
    fg.insert(second)
    out = fg.read(columns=["image_url", "report", "event_time"])
    assert len(out) == 64
    rep = out.set_index("image_url")["report"]
    assert [rep[u] for u in urls] == [f"second {u}" for u in urls]


# ---------------------------------------------------------------- registry
@pytest.fixture(scope="module")
def small_bundle():
    return new_random_bundle(seed=0, small=True)


def test_registry_publish_load_roundtrip(tmp_path, small_bundle):
    mr = FakeModelRegistry(tmp_path / "store")
    reg = HopsworksModelRegistry(project=FakeProject(mr=mr))
    v = reg.create_model("fusion_model_T5", small_bundle,
                         metrics={"val_auroc_micro": 0.874, "val_rougeL": 0.214},
                         description="contract test")
    assert v == 1
    assert mr.python.calls == ["fusion_model_T5"] and mr.generic_calls == []
    assert reg.create_model("fusion_model_T5", small_bundle) == 2
    assert reg.latest_version("fusion_model_T5") == 2
    d = Path(mr.models["fusion_model_T5"][1].download())
    assert (d / "bundle.mmdx").exists()
    cfg = json.loads((d / "config.json").read_text())
    assert cfg["fusion"]["d_img"] == small_bundle.config.fusion.d_img
    met = json.loads((d / "metrics.json").read_text())
    assert met["metrics"]["val_auroc_micro"] == 0.874
    f = small_bundle.config.fusion
    assert met["model_schema"] == {"input": [1, f.d_img + f.d_txt],
                                   "output": [1, f.n_disease]}
    loaded = reg.get_model("fusion_model_T5", version=1)
    assert loaded.version == 1 and loaded.config == small_bundle.config
    got, ref = flatten(loaded.variables), flatten(small_bundle.variables)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert reg.get_model("fusion_model_T5").version == 2
    assert reg.get_metrics("fusion_model_T5", 1)["description"] == "contract test"


def test_registry_generic_fallback(tmp_path, small_bundle):
    mr = FakeModelRegistry(tmp_path / "store", python_fails=True)
    reg = HopsworksModelRegistry(project=FakeProject(mr=mr))
    assert reg.create_model("fusion model: T5!", small_bundle) == 1
    assert mr.generic_calls == ["fusion model_ T5_"]
    with pytest.raises(LookupError):
        reg.latest_version("missing_model")


def test_sanitize():
    assert _sanitize("a/b:c") == "a_b_c"
    assert len(_sanitize("x" * 500, max_len=120)) == 120


def test_login_without_hopsworks_raises_import_error(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_hopsworks(name, *a, **kw):
        if name == "hopsworks":
            raise ImportError("No module named 'hopsworks'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_hopsworks)
    with pytest.raises(ImportError):
        HopsworksFeatureStore(project_name="p")
