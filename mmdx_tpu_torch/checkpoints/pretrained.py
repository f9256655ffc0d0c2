"""Pretrained-weight bootstrap: assemble a training-ready bundle from LOCAL
torchvision / HF checkpoint files.

The reference never trains from scratch — every run starts from pretrained
trunks: ResNet-50 ImageNet1K-V2 (reference ``training_pipeline.py:176-197``),
BERT-base-uncased (``:360``), and a hub-downloaded T5-small (``:545,561-569``)
— with fresh projection / classifier / fusion heads on top.  This module is
the port's equivalent of that starting point, file-gated (zero egress):
point it at checkpoint files you already have on disk, or pass state dicts
in memory, and it grafts their backbone weights into a fresh
``new_random_bundle``. Nothing is downloaded.

Port of ``mmdx_tpu/checkpoints/pretrained.py`` over the port's
``torch_import`` and ``ModelBundle``; the shape check walks the nested dicts
of numpy arrays itself (no ``jax.tree_util``) and names a leaf as
``jax.tree_util.keystr`` does.

    bundle = bundle_from_pretrained(
        resnet="~/ckpts/resnet50-11ad3fa6.pth",     # torchvision IMAGENET1K_V2
        bert="~/ckpts/bert-base-uncased.bin",       # HF BertModel / BertFor*
        t5="~/ckpts/t5-small/model.safetensors",    # HF T5ForConditionalGeneration
    )

Any subset may be given; missing towers stay at their fresh random init.
Heads (image/text proj + classifiers, fusion MLP, disease head, cond_proj)
are ALWAYS fresh — matching the reference, which initializes them anew on
top of the pretrained trunks.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from mmdx_tpu_torch.checkpoints import torch_import as ti
from mmdx_tpu_torch.checkpoints.bundle import ModelBundle, new_random_bundle
from mmdx_tpu_torch.config import DiagnosisConfig


def load_checkpoint(src) -> dict[str, np.ndarray]:
    """Path / bytes / mapping -> flat {key: numpy array} state dict.

    Supports torch pickle files (``.pth``/``.bin``/``.pt``) via torch and
    ``.safetensors`` via safetensors; a Mapping passes through (tests inject
    synthetic dicts this way). HF "ForPreTraining"-style wrappers are handled
    by the per-tower prefix detection in the grafters, not here.
    """
    if isinstance(src, Mapping):
        return ti.to_numpy_tree(src)
    path = Path(os.path.expanduser(str(src)))
    if not path.exists():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return dict(load_file(str(path)))
    sd = ti.load_torch_state_dict(path)
    # some torch checkpoints nest the weights under "state_dict"/"model"
    for nest in ("state_dict", "model"):
        if isinstance(sd, dict) and nest in sd and isinstance(sd[nest], dict):
            sd = sd[nest]
    return ti.to_numpy_tree(sd)


def _detect_prefix(sd: Mapping[str, Any], marker: str,
                   candidates: tuple[str, ...]) -> str:
    """Find the key prefix in front of ``marker`` (e.g. ``bert.`` for a
    BertForPreTraining checkpoint vs ``""`` for a bare BertModel)."""
    for prefix in candidates:
        if any(k.startswith(prefix + marker) for k in sd):
            return prefix
    raise ValueError(
        f"no key matching *{marker} under prefixes {candidates}: "
        f"checkpoint keys look like {sorted(sd)[:4]}..."
    )


def _flat_leaves(tree, path: str = "") -> dict[str, Any]:
    """{"['a']['b']": leaf} over nested dicts, keys in sorted order."""
    if not isinstance(tree, Mapping):
        return {path: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(_flat_leaves(tree[k], f"{path}[{k!r}]"))
    return out


def _check_shapes(dest: dict, src: dict, where: str) -> None:
    """Every imported leaf must match the destination tree's shape — a
    mismatch means the checkpoint does not fit the bundle's config."""
    d = _flat_leaves(dest)
    s = _flat_leaves(src)
    for key, v in s.items():
        if key not in d:
            raise ValueError(f"{where}: imported key {key} not in model tree")
        if tuple(np.shape(d[key])) != tuple(np.shape(v)):
            raise ValueError(
                f"{where}: shape mismatch at {key}: checkpoint "
                f"{tuple(np.shape(v))} vs model {tuple(np.shape(d[key]))} — "
                f"does the checkpoint match the bundle config?"
            )


def _align_to(dest: dict, src: dict) -> dict:
    """Graft: take src values for keys src provides, keep dest values for the
    rest (e.g. a tied-T5 checkpoint has no lm_head; a bare trunk has no
    heads). Extra top-level src keys the model doesn't use are dropped."""
    out = {}
    for k, v in dest.items():
        if k not in src:
            out[k] = v
        elif isinstance(v, dict) and isinstance(src[k], dict):
            out[k] = _align_to(v, src[k])
        else:
            out[k] = np.asarray(src[k], dtype=np.asarray(v).dtype)
    return out


def bundle_from_pretrained(
    resnet=None, bert=None, t5=None, *,
    config: DiagnosisConfig | None = None, seed: int = 0,
) -> ModelBundle:
    """Fresh bundle with pretrained trunks grafted in (see module docstring).

    Args accept a path, raw bytes, or an in-memory state-dict mapping.
    """
    bundle = new_random_bundle(seed=seed, config=config)
    params = bundle.variables["params"]
    stats = bundle.variables.setdefault("batch_stats", {})
    provenance: dict[str, str] = {}

    if resnet is not None:
        sd = load_checkpoint(resnet)
        # torchvision resnet50 is unprefixed (conv1.weight); a reference
        # ImageEncoderCNN export uses backbone.0.weight — accept both
        if any(k.startswith("backbone.0.") for k in sd):
            imported = ti.import_image_encoder(sd)
            imported = {"params": {"backbone": imported["params"]["backbone"]},
                        "batch_stats": imported["batch_stats"]}
        else:
            imported = ti.import_torchvision_resnet50(sd)
            imported = {"params": {"backbone": imported["params"]},
                        "batch_stats": {"backbone": imported["batch_stats"]}}
        _check_shapes(
            {"params": {"backbone": params["image_encoder"]["backbone"]},
             "batch_stats": stats.get("image_encoder", {})},
            imported, "resnet")
        params["image_encoder"]["backbone"] = imported["params"]["backbone"]
        stats["image_encoder"]["backbone"] = imported["batch_stats"]["backbone"]
        provenance["image_backbone"] = "pretrained"

    if bert is not None:
        sd = load_checkpoint(bert)
        prefix = _detect_prefix(
            sd, "embeddings.word_embeddings.weight",
            ("", "bert.", "encoder."))
        imported = ti.import_hf_bert(sd, prefix=prefix)
        imported = _align_to(params["text_encoder"]["bert"], imported)
        _check_shapes(params["text_encoder"]["bert"], imported, "bert")
        params["text_encoder"]["bert"] = imported
        provenance["text_backbone"] = "pretrained"

    if t5 is not None:
        sd = load_checkpoint(t5)
        prefix = _detect_prefix(sd, "shared.weight", ("", "report_model.",
                                                      "transformer."))
        imported = ti.import_hf_t5(sd, prefix=prefix)
        # tied checkpoints carry no lm_head; the tree omits it too when
        # config.report.tie_word_embeddings
        imported = _align_to(params["fusion"]["report_model"], imported)
        _check_shapes(params["fusion"]["report_model"], imported, "t5")
        params["fusion"]["report_model"] = imported
        provenance["report_model"] = "pretrained"

    bundle.metadata = dict(bundle.metadata or {},
                           pretrained=provenance or {"none": "random init"})
    return bundle
