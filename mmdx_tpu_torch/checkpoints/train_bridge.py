"""The weight bridge both ways for training: the JAX variable tree (numpy)
into the trainable towers, and back.

* image: ``models/resnet_train.ImageEncoder`` keeps the tree's names and
  HWIO kernels, and its BatchNorms' ``mean``/``var`` buffers are the
  ``batch_stats``, so the move is a flatten and an unflatten (BatchNorm stays
  unfolded);
* text: the port's ``models/bert.TextEncoder`` (its training route), with
  the q/k/v kernels and biases merged into ``attn_qkv`` one way
  (``bridge._text_state``) and split back the other;
* fusion: the port's ``models/fusion.FusionModel``, whose T5 is the one that
  also runs the decode step (``bridge.fusion_state``, and the renaming back).

Every move copies the numbers without arithmetic, so a round trip gives the
tree back bit for bit and the trainer can hand the tree from phase to phase
as ``training_pipeline.py:293-385`` does. The towers come out f32 on the
CPU with every parameter trainable.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from mmdx_tpu_torch.checkpoints.bridge import _text_state, fusion_state
from mmdx_tpu_torch.config import DiagnosisConfig
from mmdx_tpu_torch.models.bert import TextEncoder
from mmdx_tpu_torch.models.fusion import FusionModel
from mmdx_tpu_torch.models.resnet_train import ImageEncoder

STATS = ("mean", "var")


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    """{"a.b.c": leaf} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()},
        strict=True)
    return module.requires_grad_(True)


# ---------------------------------------------------------------------------
# image tower
# ---------------------------------------------------------------------------
def image_tower(image_vars: dict, config: DiagnosisConfig) -> ImageEncoder:
    """{"params", "batch_stats"} of the image encoder -> the trainable tower."""
    sd = flatten(image_vars["params"])
    sd.update(flatten(image_vars["batch_stats"]))
    return _load(ImageEncoder(config.image), sd)


def image_vars_of(tower: ImageEncoder) -> dict:
    params, stats = {}, {}
    for k, v in tower.state_dict().items():
        (stats if k.rsplit(".", 1)[1] in STATS else params)[k] = _to_numpy(v)
    return {"params": unflatten(params), "batch_stats": unflatten(stats)}


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------
def text_tower(text_vars: dict, config: DiagnosisConfig) -> TextEncoder:
    p = text_vars["params"]
    return _load(TextEncoder(config.text, pooler="pooler" in p["bert"]),
                 _text_state(p, config))


def text_vars_of(tower: TextEncoder) -> dict:
    flat = {}
    for k, v in tower.state_dict().items():
        a = _to_numpy(v)
        k = re.sub(r"^bert\.layers\.(\d+)\.", r"bert.layer\1.", k)
        if k.startswith("bert.") and k.endswith("_embeddings"):
            k += ".embedding"
        if ".attn_qkv." in k:  # kernel [H, 3H] or bias [3H]: q | k | v columns
            h = a.shape[-1] // 3  # H, or the rank's share under tensor parallelism
            for i, name in enumerate(("attn_q", "attn_k", "attn_v")):
                flat[k.replace("attn_qkv", name)] = np.ascontiguousarray(
                    a[..., i * h:(i + 1) * h])
            continue
        flat[k] = a
    return {"params": unflatten(flat)}


# ---------------------------------------------------------------------------
# fusion head (+ T5)
# ---------------------------------------------------------------------------
def fusion_head(fusion_vars: dict, config: DiagnosisConfig) -> FusionModel:
    f = fusion_vars["params"]
    n_enc = sum(1 for k in f["report_model"] if k.startswith("encoder_layer"))
    return _load(FusionModel(config.fusion, config.report, n_enc),
                 fusion_state(f, config))


def fusion_vars_of(model: FusionModel) -> dict:
    flat = {}
    for k, v in model.state_dict().items():
        k = re.sub(r"\.(decoder|encoder)_layers\.(\d+)\.", r".\1_layer\2.", k)
        if k == "report_model.shared":
            k += ".embedding"
        flat[k] = _to_numpy(v)
    return {"params": unflatten(flat)}


# ---------------------------------------------------------------------------
# the whole model, for the joint train step
# ---------------------------------------------------------------------------
def joint_model(variables: dict, config: DiagnosisConfig):
    """The whole JAX variable tree -> ``models/diagnosis.JointTrainModel``
    (f32, CPU, every parameter trainable)."""
    from mmdx_tpu_torch.models.diagnosis import JointTrainModel

    p, stats = variables["params"], variables.get("batch_stats", {})
    n_enc = sum(1 for k in p["fusion"]["report_model"] if k.startswith("encoder_layer"))
    model = JointTrainModel(config, t5_encoder_layers=n_enc,
                            bert_pooler="pooler" in p["text_encoder"]["bert"])
    sd = {}
    image = flatten(p["image_encoder"])
    image.update(flatten(stats["image_encoder"]))
    for prefix, part in (("image_encoder", image),
                         ("text_encoder", _text_state(p["text_encoder"], config)),
                         ("fusion", fusion_state(p["fusion"], config))):
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})
    return _load(model, sd)


def joint_vars_of(model) -> dict:
    """``JointTrainModel`` -> the JAX variable tree (numpy f32): the
    rank's slices under tensor parallelism, as ``sharding.port_shardings``
    lays them out."""
    image = image_vars_of(model.image_encoder)
    return {"params": {"image_encoder": image["params"],
                       "text_encoder": text_vars_of(model.text_encoder)["params"],
                       "fusion": fusion_vars_of(model.fusion)["params"]},
            "batch_stats": {"image_encoder": image["batch_stats"]}}
