"""The port's offline batch inference CLI (``pipelines/batch_inference.py``)
on the CPU.

Five PNG studies of mixed shapes and channels are written from a numpy seed
(the JAX test's ``sample_image_paths`` needs the reference checkout), with
patient details for some of them, and served from one small ``.mmdx`` bundle:

* the port's CLI and the JAX CLI, both ``--cpu --mode parity --gen off
  --batch 2``, write the same lines in the same (sorted) order: the same
  keys, names, disease vectors and model version, probabilities within 1e-5;
* the port's ``--gen greedy`` reports are the port engine's
  ``generate_reports(greedy=True)`` on the same chunks, the ragged tail of
  one study generated at its own batch size (unpadded);
* without ``--cpu`` and without a card, the CLI raises.

Each test is held to 120 s by an alarm, and a watchdog ends a worker blocked
past 180 s.
"""
import dataclasses
import faulthandler
import io
import json
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from mmdx_tpu_torch.checkpoints import bundle as port_bundle
from mmdx_tpu_torch.config import DISEASES
from mmdx_tpu_torch.pipelines import batch_inference

KEYS = {"image", "report_text", "disease_probs", "disease_vector", "model_version"}


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
def studies(tmp_path_factory):
    """(image dir, details json, bundle path): 5 PNGs from seed 0 (RGB and
    gray, four shapes), a non-image file that is skipped, details for three
    studies, and a small bundle with short reports (version 6)."""
    d = tmp_path_factory.mktemp("batch")
    images = d / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    shapes = [(80, 72, 3), (64, 64, 1), (96, 64, 3), (70, 90, 1), (64, 80, 3)]
    for i, shape in enumerate(shapes):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a[..., 0] if shape[-1] == 1 else a).save(buf, format="PNG")
        (images / f"study_{4 - i}.png").write_bytes(buf.getvalue())
    (images / "notes.txt").write_text("not an image")
    details = {"study_0.png": "62 year old male, productive cough and fever",
               "study_2.png": "chest pain after a fall",
               "study_3.png": "follow-up after pneumonia, shortness of breath"}
    (d / "details.json").write_text(json.dumps(details))
    b = port_bundle.new_random_bundle(seed=3, small=True)
    gen = dataclasses.replace(b.config.generation, max_new_tokens=10, min_new_tokens=3)
    b.config = dataclasses.replace(b.config, generation=gen)
    b.version = 6
    path = port_bundle.save_bundle(b, d / "bundle.mmdx", timestamped_copy=False)
    return images, d / "details.json", path


def cli_args(studies, out, *extra):
    images, details, bundle = studies
    return ["--images", str(images), "--out", str(out), "--bundle", str(bundle),
            "--details-json", str(details), "--batch", "2", *extra]


def read_lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_matches_the_jax_cli(studies, tmp_path):
    from mmdx_tpu.pipelines import batch_inference as jax_batch_inference

    args = ("--cpu", "--mode", "parity", "--gen", "off")
    assert batch_inference.main(cli_args(studies, tmp_path / "port.jsonl", *args)) == 5
    jax_batch_inference.main(cli_args(studies, tmp_path / "jax.jsonl", *args))
    got, ref = read_lines(tmp_path / "port.jsonl"), read_lines(tmp_path / "jax.jsonl")
    assert [r["image"] for r in got] == [r["image"] for r in ref] == \
        [f"study_{i}.png" for i in range(5)]
    for g, r in zip(got, ref):
        assert set(g) == set(r) == KEYS
        assert list(g["disease_probs"]) == list(r["disease_probs"]) == DISEASES
        p, q = (np.array(list(x["disease_probs"].values())) for x in (g, r))
        assert np.abs(p - q).max() < 1e-5, g["image"]
        assert ((p >= 0) & (p <= 1)).all()
        assert g["disease_vector"] == r["disease_vector"]
        assert g["model_version"] == r["model_version"] == 6
        assert g["report_text"] == r["report_text"] == ""


def test_greedy_reports_are_the_engines_on_the_same_chunks(studies, tmp_path):
    from mmdx_tpu_torch.io.images import wire_image_u8
    from mmdx_tpu_torch.pipelines.inference_pipeline import get_model_bundle
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    images, details, bundle_path = studies
    out = tmp_path / "greedy.jsonl"
    batch_inference.main(cli_args(studies, out, "--cpu", "--mode", "parity",
                                  "--gen", "greedy"))
    got = read_lines(out)
    bundle = get_model_bundle(bundle_path)
    engine = InferenceEngine(bundle, mode="parity", canonical_size=256, device="cpu")
    texts = json.loads(details.read_text())
    paths = sorted(images.glob("*.png"))
    want = []
    for chunk in (paths[0:2], paths[2:4], paths[4:5]):
        imgs = [wire_image_u8(p.read_bytes(), bundle.config.image.resize_size, square=True)
                for p in chunk]
        probs, z_img, z_txt = engine.classify_batch(
            imgs, [texts.get(p.name, "") for p in chunk], pad_to=2)
        assert z_img.shape[0] == len(chunk)
        want += [engine.result_dict(pr, rep) for pr, rep in
                 zip(probs, engine.generate_reports(z_img, z_txt, greedy=True))]
    assert [g["report_text"] for g in got] == [w["report_text"] for w in want]
    assert all(g["report_text"] for g in got)
    for g, w in zip(got, want):
        assert g["disease_probs"] == w["disease_probs"]


def test_cli_raises_without_a_card(studies, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_inference.main(cli_args(studies, tmp_path / "x.jsonl", "--gen", "off"))
    with pytest.raises(SystemExit):
        batch_inference.main(["--images", str(tmp_path), "--out", str(tmp_path / "y.jsonl"),
                              "--cpu"])
