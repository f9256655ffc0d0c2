"""The port imports no jax/flax, and its WSGI app answers /api/predict/ with
the reference JSON contract (the shape tests/test_serve.py checks)."""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_or_flax():
    """The whole port, an engine built from seeded numpy weights and a
    classify on uint8 ndarrays, in a fresh interpreter: no jax, no flax, no
    module of mmdx_tpu, and no image decode module (the ndarray path decodes
    nothing)."""
    code = """
import sys
import numpy as np
import mmdx_tpu_torch, mmdx_tpu_torch._build
import mmdx_tpu_torch.serve.wsgi, mmdx_tpu_torch.pipelines.inference_pipeline
from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.runtime.engine import InferenceEngine
cfg = bridge.small_config()
bundle = bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg)
img = np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)
probs, _, _ = InferenceEngine(bundle, mode="parity", device="cpu").classify_batch(
    [img], ["cough"])
assert probs.shape == (1, 13), probs.shape
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mmdx_tpu")]
bad += [m for m in ("mmdx_tpu_torch.io.images",) if m in sys.modules]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _call(app, method, path, body=b"", content_type=""):
    status = {}
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    raw = b"".join(app(environ, lambda s, h: status.setdefault("s", s)))
    return status["s"], raw


@pytest.fixture(scope="module")
def app():
    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.serve.wsgi import make_app

    cfg = bridge.small_config()
    bundle = bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg)
    app = make_app(bundle=bundle, engine_mode="fast", generate_reports=True,
                   gen_overrides=dict(max_new_tokens=6, min_new_tokens=1, num_beams=2),
                   device="cpu")
    yield app
    if app._batcher is not None:
        app._batcher.stop(drain=True)


def test_predict_route(app):
    from PIL import Image

    from mmdx_tpu_torch.config import DISEASES

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (120, 100, 3), dtype=np.uint8)).save(buf, "PNG")
    boundary = b"torchportboundary"
    body = b"\r\n".join([
        b"--" + boundary, b'Content-Disposition: form-data; name="patient_details"',
        b"", b"31 year old male, cough",
        b"--" + boundary,
        b'Content-Disposition: form-data; name="image"; filename="x.png"',
        b"Content-Type: image/png", b"", buf.getvalue(), b"--" + boundary + b"--"])
    status, raw = _call(app, "POST", "/api/predict/", body,
                        "multipart/form-data; boundary=" + boundary.decode())
    assert status.startswith("200"), raw
    payload = json.loads(raw)
    assert set(payload) == {"diseases", "report_text"}
    assert [d["name"] for d in payload["diseases"]] == DISEASES
    assert all(0.0 <= d["probability"] <= 100.0 for d in payload["diseases"])
    assert isinstance(payload["report_text"], str)


def test_static_files_stay_inside_the_frontend_dir(tmp_path, monkeypatch):
    """A sibling directory that shares the frontend directory's name as a
    prefix (``<static_dir>-evil``) is outside it: 404, not its file (the
    JAX app's string-prefix check, mmdx_tpu/serve/wsgi.py:416, lets it
    through)."""
    from mmdx_tpu_torch.serve.wsgi import make_app

    static = tmp_path / "static"
    static.mkdir()
    (static / "index.html").write_text("<html>ok</html>")
    evil = tmp_path / "static-evil"
    evil.mkdir()
    (evil / "secret.txt").write_text("secret")
    monkeypatch.setenv("MMDX_FRONTEND_DIR", str(static))
    app = make_app(device="cpu")
    status, raw = _call(app, "GET", "/")
    assert status.startswith("200") and raw == b"<html>ok</html>"
    for path in ("/../static-evil/secret.txt", "/../static/../static-evil/secret.txt"):
        status, raw = _call(app, "GET", path)
        assert status.startswith("404") and b"secret" not in raw, path


def test_predict_rejects_missing_image(app):
    status, raw = _call(app, "POST", "/api/predict/", b"{}", "application/json")
    assert status.startswith("400")
    assert json.loads(raw) == {"error": "Missing 'image' file."}
