"""Torch state_dict -> JAX pytree converters.

Lets users of the reference bring their trained weights: the reference persists
three state_dicts (``fusion_state``, ``image_state``, ``text_state``) inside
``model_bundle.pt`` (reference ``backend/ml/pipelines/training_pipeline.py:783-791``)
plus per-file ``*.pt`` in the model registry (:675-679).  These converters map
those exact key layouts onto our flax variable trees.

Conversions are pure numpy (no torch needed at call time — callers pass a dict
of numpy arrays; ``load_torch_state_dict`` handles torch deserialization when
torch is available).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def load_torch_state_dict(path_or_blob) -> dict[str, np.ndarray]:
    """Load a torch-saved state_dict / bundle file into numpy arrays."""
    import io as _io

    import torch

    if isinstance(path_or_blob, (bytes, bytearray)):
        obj = torch.load(_io.BytesIO(path_or_blob), map_location="cpu", weights_only=False)
    else:
        obj = torch.load(str(path_or_blob), map_location="cpu", weights_only=False)
    return obj


def to_numpy_tree(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _conv(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO kernel."""
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w: np.ndarray) -> np.ndarray:
    """torch [out, in] linear weight -> flax [in, out] kernel."""
    return np.transpose(w, (1, 0))


def _bn(sd: Mapping[str, np.ndarray], prefix: str):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


# ---------------------------------------------------------------------------
# ImageEncoderCNN  (reference training_pipeline.py:157-311)
#   backbone = nn.Sequential(conv1, bn1, relu, maxpool, layer1..4, avgpool)
#   keys: backbone.0 (conv), backbone.1 (bn), backbone.{4..7}.{block}.*
# ---------------------------------------------------------------------------
RESNET50_STAGES = (3, 4, 6, 3)


def _import_resnet_backbone(
    sd: Mapping[str, np.ndarray], stem_conv: str, stem_bn: str, layer_key
) -> tuple[dict, dict]:
    """Shared ResNet-50 graph walk. ``layer_key(stage) -> key prefix`` adapts
    between the reference encoder's Sequential numbering (``backbone.{4+s}``)
    and raw torchvision's named children (``layer{s+1}``)."""
    backbone_p: dict[str, Any] = {"conv_stem": {"kernel": _conv(sd[f"{stem_conv}.weight"])}}
    backbone_s: dict[str, Any] = {}
    backbone_p["bn_stem"], backbone_s["bn_stem"] = _bn(sd, stem_bn)

    for stage, n_blocks in enumerate(RESNET50_STAGES):
        for block in range(n_blocks):
            name = f"layer{stage + 1}_block{block}"
            t = f"{layer_key(stage)}.{block}"
            bp: dict[str, Any] = {}
            bs: dict[str, Any] = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = {"kernel": _conv(sd[f"{t}.conv{i}.weight"])}
                bp[f"bn{i}"], bs[f"bn{i}"] = _bn(sd, f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {"kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                bp["downsample_bn"], bs["downsample_bn"] = _bn(sd, f"{t}.downsample.1")
            backbone_p[name] = bp
            backbone_s[name] = bs
    return backbone_p, backbone_s


def import_image_encoder(sd: Mapping[str, Any]) -> dict:
    sd = to_numpy_tree(sd)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    # reference encoder wraps the backbone in nn.Sequential: conv1->0, bn1->1,
    # layer{1..4}->{4..7} (training_pipeline.py:165-170)
    params["backbone"], stats["backbone"] = _import_resnet_backbone(
        sd, "backbone.0", "backbone.1", lambda s: f"backbone.{4 + s}")
    params["proj"] = {"kernel": _dense(sd["proj.weight"]), "bias": sd["proj.bias"]}
    if "classifier.weight" in sd:
        params["classifier"] = {
            "kernel": _dense(sd["classifier.weight"]),
            "bias": sd["classifier.bias"],
        }
    return {"params": params, "batch_stats": stats}


def import_torchvision_resnet50(sd: Mapping[str, Any]) -> dict:
    """RAW torchvision ``resnet50`` state_dict (the ImageNet1K-V2 checkpoint
    the reference starts training from, training_pipeline.py:176-197) ->
    backbone-only ``{params, batch_stats}`` subtrees.

    No ``proj``/``classifier`` here: the reference initializes those fresh on
    top of the pretrained trunk (its fc is dropped, ``children[:-1]``
    training_pipeline.py:165-170); callers graft these subtrees into a fresh
    bundle (checkpoints/pretrained.py).
    """
    sd = to_numpy_tree(sd)
    p, s = _import_resnet_backbone(sd, "conv1", "bn1",
                                   lambda st: f"layer{st + 1}")
    return {"params": p, "batch_stats": s}


# ---------------------------------------------------------------------------
# TextEncoderTransformer  (reference training_pipeline.py:348-508)
#   encoder.* = HF BertModel, proj.*, classifier.*
# ---------------------------------------------------------------------------
def import_text_encoder(sd: Mapping[str, Any], num_layers: int | None = None) -> dict:
    sd = to_numpy_tree(sd)
    p: dict[str, Any] = {"bert": import_hf_bert(sd, prefix="encoder.", num_layers=num_layers)}
    p["proj"] = {"kernel": _dense(sd["proj.weight"]), "bias": sd["proj.bias"]}
    if "classifier.weight" in sd:
        p["classifier"] = {
            "kernel": _dense(sd["classifier.weight"]),
            "bias": sd["classifier.bias"],
        }
    return {"params": p}


def _count_layers(sd: Mapping[str, Any], pattern: str) -> int:
    """Number of distinct layer indices matching ``pattern.format(i)``."""
    n = 0
    while any(k.startswith(pattern.format(n)) for k in sd):
        n += 1
    return n


def import_hf_bert(sd: Mapping[str, Any], prefix: str = "",
                   num_layers: int | None = None) -> dict:
    """HF BertModel state_dict -> our models/bert.py param tree.
    ``num_layers=None`` infers the depth from the keys."""
    sd = to_numpy_tree(sd)
    if num_layers is None:
        num_layers = _count_layers(sd, prefix + "encoder.layer.{}.")

    def g(key):
        return sd[prefix + key]

    def ln(key):
        return {"scale": g(f"{key}.weight"), "bias": g(f"{key}.bias")}

    def lin(key):
        return {"kernel": _dense(g(f"{key}.weight")), "bias": g(f"{key}.bias")}

    p: dict[str, Any] = {
        "word_embeddings": {"embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": g("embeddings.token_type_embeddings.weight")},
        "embeddings_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        t = f"encoder.layer.{i}"
        p[f"layer{i}"] = {
            "attn_q": lin(f"{t}.attention.self.query"),
            "attn_k": lin(f"{t}.attention.self.key"),
            "attn_v": lin(f"{t}.attention.self.value"),
            "attn_out": lin(f"{t}.attention.output.dense"),
            "attn_ln": ln(f"{t}.attention.output.LayerNorm"),
            "ffn_in": lin(f"{t}.intermediate.dense"),
            "ffn_out": lin(f"{t}.output.dense"),
            "ffn_ln": ln(f"{t}.output.LayerNorm"),
        }
    if prefix + "pooler.dense.weight" in sd:
        p["pooler"] = lin("pooler.dense")
    return p


# ---------------------------------------------------------------------------
# FusionTransformerModel  (reference training_pipeline.py:516-618)
#   fusion_mlp.0 (linear), fusion_mlp.3 (layernorm), disease_head,
#   cond_proj.0 (linear), report_model.* (HF T5ForConditionalGeneration)
# ---------------------------------------------------------------------------
def import_fusion(sd: Mapping[str, Any], num_layers: int | None = None) -> dict:
    sd = to_numpy_tree(sd)
    p: dict[str, Any] = {
        "fuse_dense": {"kernel": _dense(sd["fusion_mlp.0.weight"]), "bias": sd["fusion_mlp.0.bias"]},
        "fuse_ln": {"scale": sd["fusion_mlp.3.weight"], "bias": sd["fusion_mlp.3.bias"]},
        "disease_head": {
            "kernel": _dense(sd["disease_head.weight"]),
            "bias": sd["disease_head.bias"],
        },
        "cond_proj": {"kernel": _dense(sd["cond_proj.0.weight"]), "bias": sd["cond_proj.0.bias"]},
    }
    if any(k.startswith("report_model.") for k in sd):
        p["report_model"] = import_hf_t5(sd, prefix="report_model.", num_layers=num_layers)
    return {"params": p}


def import_hf_t5(sd: Mapping[str, Any], prefix: str = "",
                 num_layers: int | None = None) -> dict:
    """HF T5ForConditionalGeneration state_dict -> our models/t5.py param tree.
    ``num_layers=None`` infers the depth from the keys."""
    sd = to_numpy_tree(sd)
    if num_layers is None:
        num_layers = _count_layers(sd, prefix + "decoder.block.{}.")
    # encoder depth inferred SEPARATELY: T5 supports num_layers !=
    # num_decoder_layers, and assuming symmetry corrupts asymmetric models
    num_enc_layers = _count_layers(sd, prefix + "encoder.block.{}.")

    def g(key):
        return sd[prefix + key]

    def lin_nb(key):  # T5 linears have no bias
        return {"kernel": _dense(g(f"{key}.weight"))}

    def rms(key):
        return {"scale": g(f"{key}.weight")}

    def attn(t):
        return {
            "q": lin_nb(f"{t}.q"),
            "k": lin_nb(f"{t}.k"),
            "v": lin_nb(f"{t}.v"),
            "o": lin_nb(f"{t}.o"),
        }

    p: dict[str, Any] = {
        "shared": {"embedding": g("shared.weight")},
        "encoder_rel_bias": {
            "embedding": g("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
        },
        "decoder_rel_bias": {
            "embedding": g("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
        },
        "encoder_final_ln": rms("encoder.final_layer_norm"),
        "decoder_final_ln": rms("decoder.final_layer_norm"),
    }
    for i in range(num_enc_layers):
        t = f"encoder.block.{i}.layer"
        p[f"encoder_layer{i}"] = {
            "self_attn": attn(f"{t}.0.SelfAttention"),
            "self_ln": rms(f"{t}.0.layer_norm"),
            "ffn_wi": lin_nb(f"{t}.1.DenseReluDense.wi"),
            "ffn_wo": lin_nb(f"{t}.1.DenseReluDense.wo"),
            "ffn_ln": rms(f"{t}.1.layer_norm"),
        }
    for i in range(num_layers):
        t = f"decoder.block.{i}.layer"
        p[f"decoder_layer{i}"] = {
            "self_attn": attn(f"{t}.0.SelfAttention"),
            "self_ln": rms(f"{t}.0.layer_norm"),
            "cross_attn": attn(f"{t}.1.EncDecAttention"),
            "cross_ln": rms(f"{t}.1.layer_norm"),
            "ffn_wi": lin_nb(f"{t}.2.DenseReluDense.wi"),
            "ffn_wo": lin_nb(f"{t}.2.DenseReluDense.wo"),
            "ffn_ln": rms(f"{t}.2.layer_norm"),
        }
    if prefix + "lm_head.weight" in sd:
        p["lm_head"] = {"kernel": _dense(g("lm_head.weight"))}
    return p
