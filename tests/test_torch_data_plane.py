"""The port's data plane (``io/store.py``, ``io/feature_store.py``,
``pipelines/{data_prep,feature_pipeline,dataloader,losses,metrics}.py``)
against the JAX package's, on the CPU.

* ``tests/test_io_fixes.py``'s cases (``:12``, ``:26``, ``:40``, ``:108``)
  for the port's store, feature store and dataloader;
* the latest-event dedup on equal timestamps: the row inserted last wins
  (the port's stable sort; the JAX module's default sort keeps the older row
  for 61 of the 64 keys of this case);
* data prep, the feature pipeline and the dataloader give the JAX package's
  rows, arrays and batches; ``prepared_rows`` gives them without pandas;
* the losses and metrics equal the JAX functions on the same inputs.

Each test is held to 120 s by an alarm, and a watchdog ends a worker
blocked past 180 s.
"""
import faulthandler
import random
import signal
import threading
import time

import numpy as np
import pytest
import torch

from mmdx_tpu_torch.io.store import InMemoryStore, LocalFSStore, open_url, register_store


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


# ---------------------------------------------------------------------------
# tests/test_io_fixes.py's cases, on the port
# ---------------------------------------------------------------------------
def test_store_url_roundtrip_relative_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    store = register_store(LocalFSStore(root="data/store", bucket="port-bucket"))
    store.put("chest-x-ray-images/a.jpg", b"JPEGDATA")
    url = store.url_for("chest-x-ray-images/a.jpg")
    assert url == "file://port-bucket/chest-x-ray-images/a.jpg"
    assert open_url(url) == b"JPEGDATA"
    assert store.list("chest") == ["chest-x-ray-images/a.jpg"]


def test_store_key_escape_blocked(tmp_path):
    root = tmp_path / "store"
    sibling = tmp_path / "store-backup"
    sibling.mkdir()
    (sibling / "x").write_bytes(b"secret")
    s = LocalFSStore(root=root)
    with pytest.raises(ValueError, match="escapes"):
        s.get("../store-backup/x")
    with pytest.raises(ValueError, match="escapes"):
        s.put("../store-backup/y", b"z")


def test_feature_group_dedup_survives_new_process(tmp_path):
    import pandas as pd

    from mmdx_tpu_torch.io.feature_store import FeatureStore

    writer = FeatureStore(object_store=LocalFSStore(root=tmp_path / "s"))
    fg = writer.get_or_create_feature_group("cxr_features", version=1,
                                            primary_key=["image_url"])
    fg.insert(pd.DataFrame({"image_url": ["u1", "u2"], "v": [1, 2]}))
    fg.insert(pd.DataFrame({"image_url": ["u1"], "v": [9]}))
    reader = FeatureStore(object_store=LocalFSStore(root=tmp_path / "s"))
    got = reader.get_feature_group("cxr_features", version=1).read()
    assert len(got) == 2, got
    assert int(got.set_index("image_url").loc["u1", "v"]) == 9


def test_dataloader_early_break_stops_worker():
    from mmdx_tpu_torch.pipelines.dataloader import CXRImageDataset, DataLoader

    class _DS(CXRImageDataset):
        def __getitem__(self, i):
            return np.zeros((8, 8, 3), np.float32), self.labels[i]

    n = 64
    ds = _DS(image_urls=["u%d" % i for i in range(n)], labels=[np.zeros(13, np.float32)] * n)
    for _ in DataLoader(ds, batch_size=4, prefetch=2):
        break
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "mmdx-loader" and t.is_alive() for t in threading.enumerate()):
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name == "mmdx-loader" and t.is_alive()], "prefetch worker leaked"


# ---------------------------------------------------------------------------
# Queue 3: the dedup on equal timestamps
# ---------------------------------------------------------------------------
def test_dedup_on_equal_timestamps_keeps_the_last_insert():
    """64 keys inserted twice with one timestamp: every key reads its second
    value (a non-stable sort keeps an arbitrary one of the two)."""
    import pandas as pd

    from mmdx_tpu_torch.io.feature_store import FeatureStore

    fs = FeatureStore(object_store=InMemoryStore("dedup-bucket"))
    fg = fs.get_or_create_feature_group("g", 1, primary_key=["image_url"])
    t = pd.Timestamp("2026-01-01", tz="UTC")
    keys = [f"u{i}" for i in range(64)]
    fg.insert(pd.DataFrame({"image_url": keys, "v": [0] * 64, "event_time": [t] * 64}))
    fg.insert(pd.DataFrame({"image_url": keys, "v": [1] * 64, "event_time": [t] * 64}))
    got = fg.read()
    assert sorted(got["image_url"]) == sorted(keys)
    assert (got["v"] == 1).all(), int((got["v"] == 1).sum())


# ---------------------------------------------------------------------------
# data prep, feature pipeline and loader against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds():
    from mmdx_tpu.io.feature_store import FeatureStore as JaxFeatureStore
    from mmdx_tpu.io.store import InMemoryStore as JaxStore, register_store as jax_register
    from mmdx_tpu.pipelines import data_prep as jax_prep, feature_pipeline as jax_features
    from mmdx_tpu_torch.io.feature_store import FeatureStore
    from mmdx_tpu_torch.pipelines import data_prep, feature_pipeline

    jstore = jax_register(JaxStore("plane-bucket"))
    jfs = JaxFeatureStore(object_store=jstore)
    jdf = jax_prep.prepare_raw_dataset(jax_prep.synthetic_raw_examples(10, seed=3), jstore)
    jax_features.run_feature_pipeline(jstore, jfs)
    store = register_store(InMemoryStore("plane-bucket"))
    fs = FeatureStore(object_store=store)
    df = data_prep.prepare_raw_dataset(data_prep.synthetic_raw_examples(10, seed=3), store)
    feature_pipeline.run_feature_pipeline(store, fs)
    feature_pipeline.run_feature_pipeline(store, fs)  # idempotent upsert
    return dict(jdf=jdf, df=df, jfs=jfs, fs=fs, store=store, jstore=jstore)


def _frames_equal(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        if c == "disease_classification_vector":
            assert all(np.array_equal(x, y) for x, y in zip(a[c], b[c]))
        elif c != "event_time":
            assert a[c].tolist() == b[c].tolist(), c


def test_data_prep_and_features_match_jax(worlds):
    from mmdx_tpu.pipelines.feature_pipeline import (
        load_features_labels_from_feature_store as jax_read, load_raw_data as jax_raw)
    from mmdx_tpu_torch.pipelines.data_prep import prepared_rows, synthetic_raw_examples
    from mmdx_tpu_torch.pipelines.feature_pipeline import (
        load_features_labels_from_feature_store, load_raw_data)

    _frames_equal(worlds["df"], worlds["jdf"])
    assert worlds["store"].list() == worlds["jstore"].list()
    assert worlds["store"].get("raw_data/dataset.parquet") == worlds["jstore"].get(
        "raw_data/dataset.parquet")
    _frames_equal(load_raw_data(worlds["store"]), jax_raw(worlds["jstore"]))
    feats = load_features_labels_from_feature_store(worlds["fs"])
    assert len(feats) == worlds["df"]["image_url"].nunique() and "event_time" in feats.columns
    _frames_equal(feats, jax_read(worlds["jfs"]))
    rows = prepared_rows(synthetic_raw_examples(10, seed=3), InMemoryStore("plane-bucket"))
    for c, values in rows.items():
        ref = worlds["df"][c].tolist()
        assert all(np.array_equal(x, y) for x, y in zip(values, ref)), c


@pytest.mark.parametrize("seed", range(4))
def test_labeler_and_patient_details_match_jax(seed):
    from mmdx_tpu.pipelines import data_prep as jax_prep
    from mmdx_tpu_torch.pipelines import data_prep

    rng = random.Random(seed)
    report = " ".join(rng.choice(data_prep.REPORT_PHRASES) for _ in range(3))
    vec = data_prep.rule_based_disease_labeler(report)
    assert vec == jax_prep.rule_based_disease_labeler(report)
    assert data_prep.synthesize_patient_details(vec, random.Random(seed), report) == \
        jax_prep.synthesize_patient_details(vec, random.Random(seed), report)
    text = f"bits: {' '.join(str(b) for b in vec)} (13 bits, 0=absent)"
    assert data_prep.parse_label_bits(text) == jax_prep.parse_label_bits(text) == vec


def test_dataloader_batches_match_jax(worlds):
    from mmdx_tpu.pipelines.dataloader import (CXRImageDataset as JaxDataset,
                                               DataLoader as JaxLoader)
    from mmdx_tpu_torch.pipelines.dataloader import CXRImageDataset, DataLoader

    df = worlds["df"]
    port = DataLoader(CXRImageDataset.from_dataframe(df, img_size=48, resize_size=56),
                      batch_size=4, seed=5, drop_last=True)
    ref = JaxLoader(JaxDataset.from_dataframe(worlds["jdf"], img_size=48, resize_size=56),
                    batch_size=4, seed=5, drop_last=True)
    assert len(port) == len(ref) == 2
    for _ in range(2):  # two epochs: the shuffle reseeds per epoch
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for (x, y), (rx, ry) in zip(got, want):
            assert x.shape == (4, 48, 48, 3) and x.dtype == np.float32
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------
def test_losses_match_jax():
    from mmdx_tpu.pipelines import losses as jax_losses
    from mmdx_tpu_torch.pipelines import losses

    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((4, 13)) * 8).astype(np.float32)
    y = (rng.random((4, 13)) > 0.5).astype(np.float32)
    rep = rng.standard_normal((3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int64)
    labels[0, 4:] = losses.IGNORE_INDEX
    labels[2, :] = losses.IGNORE_INDEX
    t = torch.from_numpy
    np.testing.assert_allclose(float(losses.bce_with_logits(t(logits), t(y))),
                               float(jax_losses.bce_with_logits(logits, y)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.t5_cross_entropy(t(rep), t(labels))),
                               float(jax_losses.t5_cross_entropy(rep, labels)), rtol=1e-6)
    total, parts = losses.fusion_loss(t(logits), t(y), t(rep), t(labels), gen_weight=0.5)
    ref_total, ref_parts = jax_losses.fusion_loss(logits, y, rep, labels, gen_weight=0.5)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    for k in ("cls", "gen"):
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]), rtol=1e-6)
    total, parts = losses.fusion_loss(t(logits), t(y))
    assert float(parts["gen"]) == 0.0 and float(total) == float(parts["cls"])
    all_ignored = torch.full((2, 3), losses.IGNORE_INDEX)
    assert float(losses.t5_cross_entropy(torch.zeros(2, 3, 5), all_ignored)) == 0.0


def test_metrics_match_jax():
    from mmdx_tpu.pipelines import metrics as jax_metrics
    from mmdx_tpu_torch.pipelines import metrics

    rng = np.random.default_rng(2)
    y = (rng.random((9, 13)) > 0.6).astype(np.float32)
    s = np.round(rng.random((9, 13)), 1)  # ties
    assert metrics.auroc_micro(y, s) == jax_metrics.auroc_micro(y, s)
    assert np.isnan(metrics.auroc_micro(np.zeros((2, 3)), s[:2, :3]))
    refs = ["the lungs are clear", "mild cardiomegaly with effusion", ""]
    cands = ["lungs clear", "mild cardiomegaly", "anything"]
    assert metrics.rouge_l_corpus(refs, cands) == jax_metrics.rouge_l_corpus(refs, cands)
    assert metrics.rouge_l("a b c", "a b c") == 1.0
