"""``run_training_pipeline`` on the port against the JAX package's, end to
end on the CPU, mirroring ``tests/test_pipelines.py:108``.

Both packages prepare the same world (12 synthetic examples, seed 1) into
their own in-memory store and feature store, and train the same small-config
variables (``bridge.random_state``, seed 0) with the same options: image
phases 1 + 1 steps, text 2 + 2, fusion 6 at batch 6, evaluation with greedy
reports, int8 calibration, publication to a registry and a local bundle.
Dropout is 0 in this configuration: JAX's and torch's random streams cannot
match.

Tolerances, as measured against what training moves:
* every train loss within 1e-4 relative (the image phase-2 step's f32
  gradients are ill-conditioned at 64x64, see tests/test_torch_training.py,
  and the fusion embeddings inherit that);
* the text tower's published weights within 1e-5 (its phases are
  well-conditioned; measured 1.3e-6);
* each group of published leaves by ||got - ref|| / ||ref - init||, the
  port's gap to the JAX run against how far the JAX run moved them (a
  per-element bound of about lr per step cannot fail: two AdamW runs part
  by up to that when a near-zero gradient changes sign). Measured: image
  backbone 0.354 (phase 2's ill-conditioned gradients), image heads 0.027,
  report decoder 0.040, fusion heads 0.044, text tower 5.7e-5, BatchNorm
  statistics 5.7e-4. An update of the wrong sign gives about 2, one scaled
  by 2 or 0.5 about 1 and 0.5, one scaled by 1.1 about 0.1 (0.38 in the
  backbone);
* BatchNorm statistics within 2e-3 of their magnitude, and the persisted
  int8 activation scales within 2% (measured 0.6%).

The port's run alone: a version is published, the fusion loss falls, the
int8 scales are persisted for every site, and the published model serves in
parity and (with those scales, no first-batch calibration) turbo mode.
"""
import dataclasses
import faulthandler
import signal

import jax
import numpy as np
import pytest

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.checkpoints import train_bridge as tb

STEPS = dict(image_phase1_steps=1, image_phase2_steps=1, text_steps_per_phase=2,
             fusion_steps=6, fusion_batch=6, image_batch=6, log_every=6)


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmdx_tpu.checkpoints.bundle import ModelBundle as JaxBundle
    from mmdx_tpu.checkpoints.registry import LocalModelRegistry as JaxRegistry
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.io.feature_store import FeatureStore as JaxFeatureStore
    from mmdx_tpu.io.store import InMemoryStore as JaxStore, register_store as jax_register
    from mmdx_tpu.pipelines import data_prep as jax_prep, feature_pipeline as jax_features
    from mmdx_tpu.pipelines import training_pipeline as jax_training
    from mmdx_tpu_torch.checkpoints.bundle import new_random_bundle
    from mmdx_tpu_torch.checkpoints.registry import LocalModelRegistry
    from mmdx_tpu_torch.io.feature_store import FeatureStore
    from mmdx_tpu_torch.io.store import InMemoryStore, register_store
    from mmdx_tpu_torch.pipelines import data_prep, feature_pipeline, training_pipeline

    tmp = tmp_path_factory.mktemp("training")
    cfg = bridge.small_config()
    cfg = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, hidden_dropout=0.0),
        fusion=dataclasses.replace(cfg.fusion, dropout=0.0),
        generation=dataclasses.replace(cfg.generation, max_new_tokens=8,
                                       min_new_tokens=2, num_beams=2))
    port_bundle = new_random_bundle(0, cfg)
    jax_bundle = JaxBundle(
        config=JaxConfig.from_json(cfg.to_json()), variables=port_bundle.variables,
        bert_vocab=port_bundle.bert_vocab, t5_vocab=port_bundle.t5_vocab,
        t5_scores=port_bundle.t5_scores, class_names=port_bundle.class_names,
        thresholds=port_bundle.thresholds)

    jstore = jax_register(JaxStore("train-e2e-bucket"))
    jfs = JaxFeatureStore(object_store=jstore)
    jax_prep.prepare_raw_dataset(jax_prep.synthetic_raw_examples(12, seed=1), jstore)
    jax_features.run_feature_pipeline(jstore, jfs)
    store = register_store(InMemoryStore("train-e2e-bucket"))
    fs = FeatureStore(object_store=store)
    data_prep.prepare_raw_dataset(data_prep.synthetic_raw_examples(12, seed=1), store)
    feature_pipeline.run_feature_pipeline(store, fs)
    jax_rows = jax_features.load_features_labels_from_feature_store(jfs)
    rows = feature_pipeline.load_features_labels_from_feature_store(fs)
    assert jax_rows["image_url"].tolist() == rows["image_url"].tolist()

    ref = jax_training.run_training_pipeline(
        jfs, JaxRegistry(tmp / "jax_registry"), bundle=jax_bundle,
        options=jax_training.TrainingOptions(
            log=lambda s: None, local_bundle_path=str(tmp / "jax.mmdx"), **STEPS))
    registry = LocalModelRegistry(tmp / "registry")
    got = training_pipeline.run_training_pipeline(
        fs, registry, bundle=port_bundle,
        options=training_pipeline.TrainingOptions(
            log=lambda s: None, local_bundle_path=str(tmp / "port.mmdx"), **STEPS),
        device="cpu")
    return dict(ref=ref, got=got, registry=registry, tmp=tmp, init=port_bundle.variables)


def test_losses_match_jax(runs):
    ref, got = runs["ref"]["losses"], runs["got"]["losses"]
    assert set(ref) == set(got)
    for key in ref:
        assert len(got[key]) == len(ref[key]), key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, err_msg=key)


# ||got - ref|| / ||ref - init|| over each group of published leaves
GROUP_GAP = {"image_backbone": 0.45, "image_heads": 0.06, "report_decoder": 0.08,
             "fusion_heads": 0.08, "text": 1e-3, "batch_stats": 5e-3}


def _group(key: str) -> str:
    if key.startswith("batch_stats."):
        return "batch_stats"
    if key.startswith("params.text_encoder."):
        return "text"
    if key.startswith("params.image_encoder.backbone."):
        return "image_backbone"
    if key.startswith("params.image_encoder."):
        return "image_heads"
    if key.startswith("params.fusion.report_model."):
        return "report_decoder"
    assert key.startswith("params.fusion."), key
    return "fusion_heads"


def test_published_variables_match_jax(runs):
    ref = tb.flatten(jax.tree.map(np.asarray, runs["ref"]["bundle"].variables))
    got = tb.flatten(runs["got"]["bundle"].variables)
    init = tb.flatten(runs["init"])
    assert set(ref) == set(got)
    gap = {g: 0.0 for g in GROUP_GAP}
    moved = dict(gap)
    leaves_moved = 0
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
        diff = float(np.abs(got[k] - v).max())
        if k.startswith("batch_stats."):
            assert diff <= 2e-3 * max(float(np.abs(v).max()), 1.0), (k, diff)
        elif k.startswith("params.text_encoder."):
            assert diff <= 1e-5, (k, diff)
        gap[_group(k)] += float(np.sum((got[k] - v).astype(np.float64) ** 2))
        moved[_group(k)] += float(np.sum((v - init[k]).astype(np.float64) ** 2))
        leaves_moved += not np.array_equal(v, init[k])
    assert leaves_moved > 0.9 * len(ref)  # training moved nearly every leaf
    for g, limit in GROUP_GAP.items():
        assert moved[g] > 0, g
        assert np.sqrt(gap[g] / moved[g]) <= limit, (g, np.sqrt(gap[g] / moved[g]), limit)
    rs = runs["ref"]["bundle"].metadata["int8_scales"]
    gs = runs["got"]["bundle"].metadata["int8_scales"]
    assert set(rs) == set(gs)
    for site, amax in rs.items():
        assert abs(gs[site] - amax) <= 0.02 * amax, site


def test_port_pipeline_publishes_a_serving_model(runs):
    from mmdx_tpu_torch.models.resnet_int8 import calibration_sites
    from mmdx_tpu_torch.pipelines.data_prep import synthetic_raw_examples
    from mmdx_tpu_torch.pipelines.inference_pipeline import (get_engine,
                                                             get_model_bundle,
                                                             load_model_from_registry)
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    got, registry = runs["got"], runs["registry"]
    assert got["version"] == 1 and registry.latest_version("fusion_model_T5") == 1
    assert (runs["tmp"] / "port.mmdx").exists()
    assert set(got) == {"bundle", "version", "metrics", "losses", "reports"}
    losses = got["losses"]["fusion"]
    assert losses[-1] < losses[0]
    assert "val_auroc_micro" in got["metrics"] and len(got["reports"]) == 6
    scales = got["bundle"].metadata["int8_scales"]
    assert not set(calibration_sites()) - set(scales)
    assert all(v > 0 for v in scales.values())
    assert registry.get_metrics("fusion_model_T5")["metrics"]["final_fusion_loss"] == losses[-1]

    loaded = load_model_from_registry(registry)
    assert loaded.version == 1 and loaded.metadata["int8_scales"] == scales
    image = synthetic_raw_examples(1, seed=9)[0].image_bytes
    out = get_engine(loaded, device="cpu").infer(
        image, "67M smoker dyspnea",
        gen_kwargs=dict(max_new_tokens=6, min_new_tokens=1, num_beams=2))
    assert len(out["disease_probs"]) == 13 and out["model_version"] == 1
    local = get_model_bundle(runs["tmp"] / "port.mmdx")
    probs_local, _, _ = InferenceEngine(local, mode="parity", device="cpu").classify_batch(
        [image], ["67M smoker dyspnea"])
    np.testing.assert_array_equal(
        probs_local[0], np.float32([out["disease_probs"][n] for n in loaded.class_names]))
    turbo = InferenceEngine(loaded, mode="turbo", device="cpu")
    probs, _, _ = turbo.classify_batch([image], ["67M smoker dyspnea"])
    assert turbo.scales_source == "bundle" and np.isfinite(probs).all()
