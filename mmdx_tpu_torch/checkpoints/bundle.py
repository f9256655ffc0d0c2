"""The ``.mmdx`` bundle: the single-file checkpoint the serving layer loads.

Port of ``mmdx_tpu/checkpoints/bundle.py`` without flax. The format
(``:112-181``): ``MAGIC`` (``b"MMDX0001"``), the header's length as ``<Q``,
a JSON header (configs, version, class names and thresholds, the tokenizer
vocabs and unigram scores, metadata), then the variable tree in flax's msgpack
layout (``checkpoints/msgpack_tree.py``). Bundles written by either package
read in the other.

``ModelBundle`` holds the variables as the JAX package's tree of numpy arrays
(``{"params": {...}, "batch_stats": {...}}``); ``to_torch()`` makes the
serving ``TorchBundle`` from it through ``bridge.bundle_from_variables``.
``load_bundle`` needs no model template: the tree is read as written.
``new_random_bundle`` draws its weights with numpy (``bridge.random_state``),
not with flax's initializers, so its numbers are the port's own.

``bundle_from_torch`` and ``bundle_from_torch_registry_dir`` import the
reference's torch formats (``model_bundle.pt``, the registry directory;
``bundle.py:236-318``) through the port's copy of ``torch_import``; they are
the port's one importer of them. The reference ``cfg`` carries widths but no
head counts or depths, so ``DiagnosisConfig.from_reference_json`` gives the
reference's own architecture; a model of other widths sets the imported
bundle's ``config`` before ``to_torch()``. ``checkpoints/torch_export.py``
writes both.
"""
from __future__ import annotations

import datetime
import json
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from mmdx_tpu_torch.checkpoints import msgpack_tree
from mmdx_tpu_torch.checkpoints.bridge import (TorchBundle, Tokenizers,
                                               bundle_from_variables, default_vocabs,
                                               random_state, small_config)
from mmdx_tpu_torch.config import DISEASES, DiagnosisConfig

MAGIC = b"MMDX0001"
BUNDLE_VERSION = 1


@dataclass
class ModelBundle(Tokenizers):
    config: DiagnosisConfig
    variables: dict[str, Any]  # {"params": {...}, "batch_stats": {...}}, numpy
    bert_vocab: dict[str, int]
    t5_vocab: dict[str, int]
    class_names: list[str]
    thresholds: list[float]
    version: int = 1
    metadata: dict[str, Any] | None = None
    t5_scores: dict[int, float] | None = None  # unigram-LM piece log-probs

    def to_torch(self) -> TorchBundle:
        """The serving bundle: the port's model (f32, CPU) filled from the
        variables, with this bundle's vocabs, names, version and metadata."""
        return bundle_from_variables(
            self.variables, self.config, class_names=self.class_names,
            thresholds=self.thresholds, version=self.version,
            metadata=self.metadata, vocabs=(self.bert_vocab, self.t5_vocab,
                                            self.t5_scores))


def _vocab_list(vocab: dict[str, int]) -> list[str]:
    return [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]


def bundle_bytes(bundle: ModelBundle) -> bytes:
    """The file's bytes: magic, header length, JSON header, variables."""
    header = {
        "bundle_version": BUNDLE_VERSION,
        "version": bundle.version,
        "saved_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "config": json.loads(bundle.config.to_json()),
        "reference_config": bundle.config.to_reference_json(),
        "class_names": bundle.class_names,
        "thresholds": bundle.thresholds,
        "bert_vocab": _vocab_list(bundle.bert_vocab),
        "t5_vocab": _vocab_list(bundle.t5_vocab),
        "t5_scores": (
            [bundle.t5_scores.get(i) for i in range(len(bundle.t5_vocab))]
            if bundle.t5_scores else None
        ),
        "metadata": bundle.metadata or {},
    }
    header_bytes = json.dumps(header).encode("utf-8")
    return (MAGIC + struct.pack("<Q", len(header_bytes)) + header_bytes
            + msgpack_tree.dumps(bundle.variables))


def save_bundle(bundle: ModelBundle, path: str | Path,
                timestamped_copy: bool = True) -> Path:
    """Write atomically (a temporary file, then a rename), and with
    ``timestamped_copy`` also ``<stem>_<UTC stamp><suffix>`` beside it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = bundle_bytes(bundle)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(payload)
    tmp.replace(path)
    if timestamped_copy:
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        path.with_name(f"{path.stem}_{stamp}{path.suffix}").write_bytes(payload)
    return path


def load_bundle(src: str | Path | bytes) -> ModelBundle:
    payload = bytes(src) if isinstance(src, (bytes, bytearray)) else Path(src).read_bytes()
    if payload[:8] != MAGIC:
        raise ValueError("not an mmdx bundle (bad magic)")
    (hlen,) = struct.unpack("<Q", payload[8:16])
    header = json.loads(payload[16:16 + hlen].decode("utf-8"))
    variables = msgpack_tree.loads(memoryview(payload)[16 + hlen:])
    raw_scores = header.get("t5_scores")
    return ModelBundle(
        config=DiagnosisConfig.from_json(json.dumps(header["config"])),
        variables=variables,
        bert_vocab={t: i for i, t in enumerate(header["bert_vocab"])},
        t5_vocab={t: i for i, t in enumerate(header["t5_vocab"])},
        t5_scores=({i: float(s) for i, s in enumerate(raw_scores) if s is not None}
                   if raw_scores else None),
        class_names=header["class_names"],
        thresholds=header["thresholds"],
        version=header["version"],
        metadata=header.get("metadata") or {},
    )


def assemble_variables(image_vars: dict, text_vars: dict, fusion_vars: dict) -> dict:
    """Per-module variable trees -> the whole model's variables."""
    return {
        "params": {
            "image_encoder": image_vars["params"],
            "text_encoder": text_vars["params"],
            "fusion": fusion_vars["params"],
        },
        "batch_stats": {"image_encoder": image_vars.get("batch_stats", {})},
    }


def split_variables(variables: dict) -> tuple[dict, dict, dict]:
    """Inverse of assemble_variables."""
    image = {
        "params": variables["params"]["image_encoder"],
        "batch_stats": variables.get("batch_stats", {}).get("image_encoder", {}),
    }
    return image, {"params": variables["params"]["text_encoder"]}, {
        "params": variables["params"]["fusion"]}


def new_random_bundle(seed: int = 0, config: DiagnosisConfig | None = None,
                      small: bool = False) -> ModelBundle:
    """Fresh random weights (``bridge.random_state``) at full width, or at
    the narrow test widths with ``small``."""
    config = config or (small_config() if small else DiagnosisConfig())
    bert, t5, scores = default_vocabs()
    return ModelBundle(
        config=config, variables=random_state(config, seed), bert_vocab=bert,
        t5_vocab=t5, t5_scores=scores, class_names=list(config.class_names),
        thresholds=list(config.thresholds), version=1)


def bundle_from_torch(path_or_blob, t5_num_layers: int | None = None) -> ModelBundle:
    """Import the reference's torch ``model_bundle.pt`` ({cfg, fusion_state,
    image_state, text_state, version}, reference training_pipeline.py:783-791).

    Weights convert exactly; the tokenizers are the shipped vocabs (the hub
    names the file records are not fetched)."""
    from mmdx_tpu_torch.checkpoints import torch_import as ti

    blob = ti.load_torch_state_dict(path_or_blob)
    missing = {"cfg", "fusion_state", "image_state", "text_state"} - set(blob)
    if missing:
        raise ValueError(f"Bundle missing keys: {missing}")
    image_vars = ti.import_image_encoder(blob["image_state"])
    text_vars = ti.import_text_encoder(blob["text_state"])
    fusion_vars = ti.import_fusion(blob["fusion_state"], num_layers=t5_num_layers)
    bert, t5, scores = default_vocabs()
    artifacts = blob["cfg"].get("artifacts") or {}
    return ModelBundle(
        config=DiagnosisConfig.from_reference_json(blob["cfg"]),
        variables=assemble_variables(image_vars, text_vars, fusion_vars),
        bert_vocab=bert, t5_vocab=t5, t5_scores=scores,
        class_names=artifacts.get("class_names", list(DISEASES)),
        thresholds=artifacts.get("thresholds", [0.5] * 13),
        version=int(blob.get("version", 1)),
        metadata={"imported_from": "torch_model_bundle"})


def bundle_from_torch_registry_dir(path: str | Path, version: int | None = None,
                                   t5_num_layers: int | None = None) -> ModelBundle:
    """Import the reference's model-registry directory: {``fusion_model.pt``,
    ``image_encoder.pt``, ``text_encoder.pt``, ``config.json``, optional
    ``t5_assets/``} (reference training_pipeline.py:675-729). Both towers
    are required. ``t5_assets/spiece.model``, where present, gives the T5
    vocab and its unigram scores (``text/spm_reader.py``); otherwise the
    shipped vocab is used."""
    from mmdx_tpu_torch.checkpoints import torch_import as ti

    path = Path(path)
    cfg_dict = json.loads((path / "config.json").read_text(encoding="utf-8"))
    config = DiagnosisConfig.from_reference_json(cfg_dict)
    fusion_vars = ti.import_fusion(ti.load_torch_state_dict(path / "fusion_model.pt"),
                                   num_layers=t5_num_layers)
    img_p, txt_p = path / "image_encoder.pt", path / "text_encoder.pt"
    if not img_p.exists() or not txt_p.exists():
        raise ValueError(
            "registry dir must contain image_encoder.pt and text_encoder.pt "
            "(the serving path needs both towers)")
    image_vars = ti.import_image_encoder(ti.load_torch_state_dict(img_p))
    text_vars = ti.import_text_encoder(ti.load_torch_state_dict(txt_p))
    bert, t5, scores = default_vocabs()
    spiece = path / "t5_assets" / "spiece.model"
    if spiece.exists():
        from mmdx_tpu_torch.text.spm_reader import read_spiece_vocab

        t5, scores = read_spiece_vocab(spiece)
    artifacts = cfg_dict.get("artifacts") or {}
    n_disease = (cfg_dict.get("fusion") or {}).get("n_disease") or 13
    return ModelBundle(
        config=config,
        variables=assemble_variables(image_vars, text_vars, fusion_vars),
        bert_vocab=bert, t5_vocab=t5, t5_scores=scores,
        class_names=artifacts.get("class_names", list(DISEASES)),
        thresholds=artifacts.get("thresholds", [0.5] * n_disease),
        version=int(version or 1),
        metadata={"imported_from": "torch_registry_dir", "dir": str(path)})
