"""Bundle and engine caches for serving, the registry load, and the
reference's ``inference()``.

Port of ``mmdx_tpu/pipelines/inference_pipeline.py``
(``load_model_from_registry``, ``default_bundle_path``, ``get_model_bundle``,
``get_engine``, ``inference``). ``get_model_bundle`` serves an ``.mmdx``
bundle (``checkpoints/bundle.py``, either package's) or the reference's
``model_bundle.pt`` (``bundle.bundle_from_torch``), told apart by the 8-byte
magic; a reference registry directory is read by
``bundle.bundle_from_torch_registry_dir`` alone, as in JAX.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

from mmdx_tpu_torch.checkpoints.bridge import TorchBundle
from mmdx_tpu_torch.checkpoints.bundle import MAGIC, bundle_from_torch, load_bundle
from mmdx_tpu_torch.runtime.engine import InferenceEngine

DEFAULT_MODEL_NAME = "fusion_model_T5"  # the reference's registry name

_ENGINES: dict[tuple, InferenceEngine] = {}
_BUNDLE: TorchBundle | None = None
_LOCK = threading.Lock()
_ENGINE_CACHE_MAX = 4  # old engines pin a full weight set on the device


def load_model_from_registry(registry, model_name: str = DEFAULT_MODEL_NAME,
                             version: int | None = None) -> TorchBundle:
    """The registry's bundle (latest version unless ``version``), ready to
    serve (``checkpoints/registry.LocalModelRegistry``)."""
    return registry.get_model(model_name, version).to_torch()


def default_bundle_path() -> Path:
    """``MMDX_BUNDLE_PATH`` (or ``CXR_BUNDLE_PATH``), else the JAX package's
    default, ``mmdx_tpu/model/model_bundle.mmdx``: both packages serve the
    same bundle."""
    env = os.getenv("MMDX_BUNDLE_PATH") or os.getenv("CXR_BUNDLE_PATH")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "mmdx_tpu" / "model" / "model_bundle.mmdx"


def get_model_bundle(path: str | os.PathLike | None = None) -> TorchBundle:
    """Thread-safe lazily cached bundle load: ``.mmdx`` or the reference's
    ``model_bundle.pt``."""
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
            magic = fh.read(8)
        if magic == MAGIC:
            bundle = load_bundle(bundle_path).to_torch()
        else:
            bundle = bundle_from_torch(bundle_path).to_torch()
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
    """Engine per (bundle object, mode, mesh, device), LRU-bounded and
    lock-guarded; ``device`` None is the first CUDA card (the rank's card
    under a ``mesh``)."""
    key = (id(model_bundle), mode, None if mesh is None else id(mesh),
           None if device is None else str(device))
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
              device=None, gen_kwargs: dict | None = None, mesh=None) -> dict:
    """The reference-compatible ``inference()``
    (``mmdx_tpu/pipelines/inference_pipeline.py:102-110``): one image (PIL
    image, encoded bytes or uint8 array) and its patient details through the
    parity engine of ``get_engine`` -> {report_text, disease_probs,
    disease_vector, model_version}. ``device`` places the engine (None: the
    first CUDA card); under a ``mesh`` every rank calls it alike."""
    engine = get_engine(model_bundle, mesh=mesh, device=device)
    return engine.infer(image_pil, patient_details, gen_kwargs=gen_kwargs)
