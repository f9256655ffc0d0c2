"""Variable tree -> torch state_dict exporters (inverse of torch_import).

Port of ``mmdx_tpu/checkpoints/torch_export.py``: the port's ``ModelBundle``
keeps the JAX tree's names and layouts (numpy leaves), so the exporters walk
``bundle.variables`` as the JAX module does and write the same state dicts;
a leaf may also be a torch tensor (``_host``).

Completes the interop loop: a user can train/fine-tune in this framework and
hand the weights BACK to the reference stack. Exports write the reference's
exact artifact formats —

  * the single-file ``model_bundle.pt``:
    {cfg, fusion_state, image_state, text_state, t5_tokenizer_name,
    bert_tokenizer_name, version} (reference
    backend/ml/pipelines/training_pipeline.py:783-791), loadable by the
    reference's ``get_model_bundle_pickle`` (views.py:188-258);
  * the model-registry directory: {fusion_model.pt, image_encoder.pt,
    text_encoder.pt, config.json, t5_assets/spiece.model}
    (training_pipeline.py:675-729), loadable by
    ``load_model_from_hopsworks_model_registry`` (inference_pipeline.py:53-139).

State dicts are strict-load compatible with the reference's torch modules
(ImageEncoderCNN / TextEncoderTransformer / FusionTransformerModel): BN
``num_batches_tracked`` buffers are emitted, and T5 tied-weight aliases
(``encoder.embed_tokens.weight`` / ``decoder.embed_tokens.weight`` /
``lm_head.weight``) are materialized from ``shared`` the way HF state dicts
carry them. Conversions are pure numpy; torch is needed only to serialize.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from mmdx_tpu_torch.checkpoints.torch_import import RESNET50_STAGES


def _host(v) -> np.ndarray:
    """A numpy leaf as it is; a torch tensor as its values on the host."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _conv(k) -> np.ndarray:
    """HWIO kernel -> torch OIHW conv weight."""
    return np.transpose(_host(k), (3, 2, 0, 1))


def _dense(k) -> np.ndarray:
    """[in, out] kernel -> torch [out, in] linear weight."""
    return np.transpose(_host(k), (1, 0))


def _np(v) -> np.ndarray:
    return np.asarray(_host(v), dtype=np.float32)


def _bn(out: dict, prefix: str, params: dict, stats: dict) -> None:
    out[f"{prefix}.weight"] = _np(params["scale"])
    out[f"{prefix}.bias"] = _np(params["bias"])
    out[f"{prefix}.running_mean"] = _np(stats["mean"])
    out[f"{prefix}.running_var"] = _np(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


# ---------------------------------------------------------------------------
# ImageEncoderCNN (inverse of torch_import.import_image_encoder)
# ---------------------------------------------------------------------------
def export_image_encoder(image_vars: dict) -> dict[str, np.ndarray]:
    p, s = image_vars["params"], image_vars["batch_stats"]
    bp, bs = p["backbone"], s["backbone"]
    out: dict[str, np.ndarray] = {"backbone.0.weight": _conv(bp["conv_stem"]["kernel"])}
    _bn(out, "backbone.1", bp["bn_stem"], bs["bn_stem"])
    for stage, n_blocks in enumerate(RESNET50_STAGES):
        seq = 4 + stage
        for block in range(n_blocks):
            name = f"layer{stage + 1}_block{block}"
            t = f"backbone.{seq}.{block}"
            for i in (1, 2, 3):
                out[f"{t}.conv{i}.weight"] = _conv(bp[name][f"conv{i}"]["kernel"])
                _bn(out, f"{t}.bn{i}", bp[name][f"bn{i}"], bs[name][f"bn{i}"])
            if "downsample_conv" in bp[name]:
                out[f"{t}.downsample.0.weight"] = _conv(bp[name]["downsample_conv"]["kernel"])
                _bn(out, f"{t}.downsample.1", bp[name]["downsample_bn"],
                    bs[name]["downsample_bn"])
    out["proj.weight"] = _dense(p["proj"]["kernel"])
    out["proj.bias"] = _np(p["proj"]["bias"])
    if "classifier" in p:
        out["classifier.weight"] = _dense(p["classifier"]["kernel"])
        out["classifier.bias"] = _np(p["classifier"]["bias"])
    return out


# ---------------------------------------------------------------------------
# TextEncoderTransformer (inverse of torch_import.import_text_encoder)
# ---------------------------------------------------------------------------
def export_hf_bert(p: dict, prefix: str = "", num_layers: int | None = None) -> dict:
    out: dict[str, np.ndarray] = {}

    def ln(key: str, tree: dict) -> None:
        out[f"{prefix}{key}.weight"] = _np(tree["scale"])
        out[f"{prefix}{key}.bias"] = _np(tree["bias"])

    def lin(key: str, tree: dict) -> None:
        out[f"{prefix}{key}.weight"] = _dense(tree["kernel"])
        out[f"{prefix}{key}.bias"] = _np(tree["bias"])

    out[f"{prefix}embeddings.word_embeddings.weight"] = _np(
        p["word_embeddings"]["embedding"])
    out[f"{prefix}embeddings.position_embeddings.weight"] = _np(
        p["position_embeddings"]["embedding"])
    out[f"{prefix}embeddings.token_type_embeddings.weight"] = _np(
        p["token_type_embeddings"]["embedding"])
    ln("embeddings.LayerNorm", p["embeddings_ln"])
    if num_layers is None:
        num_layers = sum(1 for k in p if k.startswith("layer"))
    for i in range(num_layers):
        L = p[f"layer{i}"]
        t = f"encoder.layer.{i}"
        lin(f"{t}.attention.self.query", L["attn_q"])
        lin(f"{t}.attention.self.key", L["attn_k"])
        lin(f"{t}.attention.self.value", L["attn_v"])
        lin(f"{t}.attention.output.dense", L["attn_out"])
        ln(f"{t}.attention.output.LayerNorm", L["attn_ln"])
        lin(f"{t}.intermediate.dense", L["ffn_in"])
        lin(f"{t}.output.dense", L["ffn_out"])
        ln(f"{t}.output.LayerNorm", L["ffn_ln"])
    if "pooler" in p:
        lin("pooler.dense", p["pooler"])
    return out


def export_text_encoder(text_vars: dict) -> dict[str, np.ndarray]:
    p = text_vars["params"]
    out = export_hf_bert(p["bert"], prefix="encoder.")
    out["proj.weight"] = _dense(p["proj"]["kernel"])
    out["proj.bias"] = _np(p["proj"]["bias"])
    if "classifier" in p:
        out["classifier.weight"] = _dense(p["classifier"]["kernel"])
        out["classifier.bias"] = _np(p["classifier"]["bias"])
    return out


# ---------------------------------------------------------------------------
# FusionTransformerModel (inverse of torch_import.import_fusion)
# ---------------------------------------------------------------------------
def export_hf_t5(p: dict, prefix: str = "", num_layers: int | None = None) -> dict:
    out: dict[str, np.ndarray] = {}

    def lin_nb(key: str, tree: dict) -> None:
        out[f"{prefix}{key}.weight"] = _dense(tree["kernel"])

    def rms(key: str, tree: dict) -> None:
        out[f"{prefix}{key}.weight"] = _np(tree["scale"])

    def attn(t: str, tree: dict) -> None:
        for m in ("q", "k", "v", "o"):
            lin_nb(f"{t}.{m}", tree[m])

    shared = _np(p["shared"]["embedding"])
    out[f"{prefix}shared.weight"] = shared
    # HF state dicts materialize the tied aliases; the reference's strict
    # load_state_dict expects them (training_pipeline.py:545-569)
    out[f"{prefix}encoder.embed_tokens.weight"] = shared
    out[f"{prefix}decoder.embed_tokens.weight"] = shared
    out[f"{prefix}lm_head.weight"] = (
        _dense(p["lm_head"]["kernel"]) if "lm_head" in p else shared
    )
    out[f"{prefix}decoder.block.0.layer.0.SelfAttention."
        f"relative_attention_bias.weight"] = _np(p["decoder_rel_bias"]["embedding"])
    rms("decoder.final_layer_norm", p["decoder_final_ln"])
    if num_layers is None:
        num_layers = sum(1 for k in p if k.startswith("decoder_layer"))

    # The fusion model only runs the T5 DECODER (the reference fabricates
    # "encoder outputs" via cond_proj, training_pipeline.py:574-578), so our
    # tree may be decoder-only — bundles imported from the reference carry
    # the full stack and export verbatim. When absent, emit inert encoder
    # weights (zeros; ones for norm scales) so the reference's strict
    # load_state_dict succeeds; the reference never executes them.
    # encoder depth counted SEPARATELY from the decoder's: T5 supports
    # num_layers != num_decoder_layers, and a reference checkpoint with an
    # asymmetric stack must round-trip exactly
    num_enc_layers = sum(1 for k in p if k.startswith("encoder_layer"))
    has_encoder = num_enc_layers > 0
    if has_encoder:
        out[f"{prefix}encoder.block.0.layer.0.SelfAttention."
            f"relative_attention_bias.weight"] = _np(
                p["encoder_rel_bias"]["embedding"])
        rms("encoder.final_layer_norm", p["encoder_final_ln"])
        for i in range(num_enc_layers):
            L = p[f"encoder_layer{i}"]
            t = f"encoder.block.{i}.layer"
            attn(f"{t}.0.SelfAttention", L["self_attn"])
            rms(f"{t}.0.layer_norm", L["self_ln"])
            lin_nb(f"{t}.1.DenseReluDense.wi", L["ffn_wi"])
            lin_nb(f"{t}.1.DenseReluDense.wo", L["ffn_wo"])
            rms(f"{t}.1.layer_norm", L["ffn_ln"])
    else:
        dec0 = p["decoder_layer0"]
        d_model, inner = _host(dec0["self_attn"]["q"]["kernel"]).shape
        d_ff = _host(dec0["ffn_wi"]["kernel"]).shape[1]
        out[f"{prefix}encoder.block.0.layer.0.SelfAttention."
            f"relative_attention_bias.weight"] = np.zeros_like(
                _np(p["decoder_rel_bias"]["embedding"]))
        out[f"{prefix}encoder.final_layer_norm.weight"] = np.ones(
            d_model, np.float32)
        for i in range(num_layers):
            t = f"encoder.block.{i}.layer"
            for m, shape in (("q", (inner, d_model)), ("k", (inner, d_model)),
                             ("v", (inner, d_model)), ("o", (d_model, inner))):
                out[f"{prefix}{t}.0.SelfAttention.{m}.weight"] = np.zeros(
                    shape, np.float32)
            out[f"{prefix}{t}.0.layer_norm.weight"] = np.ones(d_model, np.float32)
            out[f"{prefix}{t}.1.DenseReluDense.wi.weight"] = np.zeros(
                (d_ff, d_model), np.float32)
            out[f"{prefix}{t}.1.DenseReluDense.wo.weight"] = np.zeros(
                (d_model, d_ff), np.float32)
            out[f"{prefix}{t}.1.layer_norm.weight"] = np.ones(d_model, np.float32)

    for i in range(num_layers):
        L = p[f"decoder_layer{i}"]
        t = f"decoder.block.{i}.layer"
        attn(f"{t}.0.SelfAttention", L["self_attn"])
        rms(f"{t}.0.layer_norm", L["self_ln"])
        attn(f"{t}.1.EncDecAttention", L["cross_attn"])
        rms(f"{t}.1.layer_norm", L["cross_ln"])
        lin_nb(f"{t}.2.DenseReluDense.wi", L["ffn_wi"])
        lin_nb(f"{t}.2.DenseReluDense.wo", L["ffn_wo"])
        rms(f"{t}.2.layer_norm", L["ffn_ln"])
    return out


def export_fusion(fusion_vars: dict) -> dict[str, np.ndarray]:
    p = fusion_vars["params"]
    out: dict[str, np.ndarray] = {
        "fusion_mlp.0.weight": _dense(p["fuse_dense"]["kernel"]),
        "fusion_mlp.0.bias": _np(p["fuse_dense"]["bias"]),
        "fusion_mlp.3.weight": _np(p["fuse_ln"]["scale"]),
        "fusion_mlp.3.bias": _np(p["fuse_ln"]["bias"]),
        "disease_head.weight": _dense(p["disease_head"]["kernel"]),
        "disease_head.bias": _np(p["disease_head"]["bias"]),
        "cond_proj.0.weight": _dense(p["cond_proj"]["kernel"]),
        "cond_proj.0.bias": _np(p["cond_proj"]["bias"]),
    }
    if "report_model" in p:
        out.update(export_hf_t5(p["report_model"], prefix="report_model."))
    return out


# ---------------------------------------------------------------------------
# Artifact writers
# ---------------------------------------------------------------------------
def _to_torch(sd: dict[str, np.ndarray]) -> dict[str, Any]:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v).copy())
            for k, v in sd.items()}


def _reference_cfg(bundle) -> dict[str, Any]:
    cfg = bundle.config.to_reference_json()
    cfg["artifacts"] = {
        "class_names": list(bundle.class_names),
        "thresholds": [float(t) for t in bundle.thresholds],
    }
    return cfg


def bundle_to_torch(bundle, path: str | Path) -> Path:
    """Write the reference's single-file ``model_bundle.pt`` (atomic)."""
    import os

    import torch

    image_vars, text_vars, fusion_vars = _split(bundle)
    blob = {
        "cfg": _reference_cfg(bundle),
        "fusion_state": _to_torch(export_fusion(fusion_vars)),
        "image_state": _to_torch(export_image_encoder(image_vars)),
        "text_state": _to_torch(export_text_encoder(text_vars)),
        "t5_tokenizer_name": bundle.config.report.hf_model_name,
        "bert_tokenizer_name": bundle.config.text.hf_model_name,
        "version": int(bundle.version),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)  # atomic, like the reference (:793-797)
    return path


def bundle_to_torch_registry_dir(bundle, path: str | Path) -> Path:
    """Write the reference's model-registry directory layout
    (training_pipeline.py:675-729). Includes ``t5_assets/spiece.model`` when
    the bundle carries unigram scores, so re-import round-trips the real
    vocab through text/spm_reader."""
    import json

    import torch

    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    image_vars, text_vars, fusion_vars = _split(bundle)
    torch.save(_to_torch(export_fusion(fusion_vars)), d / "fusion_model.pt")
    torch.save(_to_torch(export_image_encoder(image_vars)), d / "image_encoder.pt")
    torch.save(_to_torch(export_text_encoder(text_vars)), d / "text_encoder.pt")
    (d / "config.json").write_text(
        json.dumps(_reference_cfg(bundle), indent=2), encoding="utf-8"
    )
    if bundle.t5_scores:
        from mmdx_tpu_torch.text.spm_reader import (
            CONTROL, NORMAL, UNKNOWN, write_spiece_model,
        )

        inv = {i: t for t, i in bundle.t5_vocab.items()}
        pieces = [
            (inv[i], float(bundle.t5_scores.get(i, 0.0)))
            for i in sorted(inv)
        ]
        types = [
            UNKNOWN if t == "<unk>"
            else CONTROL if (t.startswith("<") and t.endswith(">"))
            else NORMAL
            for t, _ in pieces
        ]
        (d / "t5_assets").mkdir(exist_ok=True)
        write_spiece_model(pieces, d / "t5_assets" / "spiece.model", types=types)
    return d


def _split(bundle):
    from mmdx_tpu_torch.checkpoints.bundle import split_variables

    return split_variables(bundle.variables)


def main(argv=None):
    """CLI: python -m mmdx_tpu_torch.checkpoints.torch_export BUNDLE.mmdx OUT
    [--registry-dir] — export a bundle to the reference's torch formats."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("bundle", help=".mmdx bundle to export")
    ap.add_argument("out", help="output model_bundle.pt path (or dir with "
                                "--registry-dir)")
    ap.add_argument("--registry-dir", action="store_true",
                    help="write the Hopsworks registry directory layout "
                         "instead of the single-file bundle")
    args = ap.parse_args(argv)

    from mmdx_tpu_torch.checkpoints.bundle import load_bundle

    bundle = load_bundle(args.bundle)
    if args.registry_dir:
        out = bundle_to_torch_registry_dir(bundle, args.out)
    else:
        out = bundle_to_torch(bundle, args.out)
    print(f"exported -> {out}")


if __name__ == "__main__":
    main()
