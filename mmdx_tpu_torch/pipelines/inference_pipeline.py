"""Bundle and engine caches for serving, and the reference's ``inference()``.

Port of ``mmdx_tpu/pipelines/inference_pipeline.py`` (``get_model_bundle``,
``get_engine``, ``inference``). The port serves the reference-format
``model_bundle.pt`` (``mmdx_tpu.checkpoints.torch_export.bundle_to_torch``
writes one from any ``.mmdx``); loading ``.mmdx`` directly needs flax's msgpack layout and is not
ported yet.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

from mmdx_tpu_torch.checkpoints.bridge import TorchBundle, load_reference_bundle_pt
from mmdx_tpu_torch.runtime.engine import InferenceEngine

_ENGINES: dict[tuple, InferenceEngine] = {}
_BUNDLE: TorchBundle | None = None
_LOCK = threading.Lock()
_ENGINE_CACHE_MAX = 4  # old engines pin a full weight set on the device


def default_bundle_path() -> Path:
    env = os.getenv("MMDX_BUNDLE_PATH") or os.getenv("CXR_BUNDLE_PATH")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "mmdx_tpu" / "model" / "model_bundle.pt"


def get_model_bundle(path: str | os.PathLike | None = None) -> TorchBundle:
    """Thread-safe lazily cached bundle load (``model_bundle.pt`` only)."""
    global _BUNDLE
    if _BUNDLE is not None and path is None:
        return _BUNDLE
    with _LOCK:
        if _BUNDLE is not None and path is None:
            return _BUNDLE
        bundle_path = Path(path) if path else default_bundle_path()
        if not bundle_path.is_file():
            raise FileNotFoundError(f"Bundle not found: {bundle_path}")
        with bundle_path.open("rb") as fh:
            if fh.read(8) == b"MMDX0001":
                raise NotImplementedError(
                    f"{bundle_path} is an .mmdx bundle: the PyTorch port loads the "
                    "reference model_bundle.pt (python -m "
                    "mmdx_tpu.checkpoints.torch_export converts); an .mmdx loader "
                    "is on the ROADMAP")
        bundle = load_reference_bundle_pt(bundle_path)
        if path is None:
            _BUNDLE = bundle
        return bundle


def clear_model_bundle() -> None:
    global _BUNDLE
    with _LOCK:
        _BUNDLE = None
        _ENGINES.clear()


def get_engine(model_bundle: TorchBundle, mode: str = "parity",
               mesh=None, device=None) -> InferenceEngine:
    """Engine per (bundle object, mode, device), LRU-bounded and lock-guarded;
    ``device`` None is the first CUDA card."""
    key = (id(model_bundle), mode, None if device is None else str(device))
    with _LOCK:
        if key in _ENGINES:
            _ENGINES[key] = _ENGINES.pop(key)
            return _ENGINES[key]
    engine = InferenceEngine(model_bundle, mode=mode, mesh=mesh, device=device)
    with _LOCK:
        existing = _ENGINES.setdefault(key, engine)
        while len(_ENGINES) > _ENGINE_CACHE_MAX:
            _ENGINES.pop(next(iter(_ENGINES)))
        return existing


def inference(model_bundle: TorchBundle, image_pil, patient_details: str,
              device=None, gen_kwargs: dict | None = None) -> dict:
    """The reference-compatible ``inference()``
    (``mmdx_tpu/pipelines/inference_pipeline.py:102-110``): one image (PIL
    image, encoded bytes or uint8 array) and its patient details through the
    parity engine of ``get_engine`` -> {report_text, disease_probs,
    disease_vector, model_version}. ``device`` places the engine (None: the
    first CUDA card)."""
    engine = get_engine(model_bundle, device=device)
    return engine.infer(image_pil, patient_details, gen_kwargs=gen_kwargs)
