"""Model / pipeline configuration dataclasses with reference-`config.json` round-trip.

The reference persists hyperparameters in a ``config.json`` written by
``save_model_to_hopsworks_model_registry`` (reference
``backend/ml/pipelines/training_pipeline.py:682-720``) and re-reads it in
``load_model_from_hopsworks_model_registry`` (``inference_pipeline.py:67-92``)
and ``get_model_bundle_pickle`` (``backend/api/views.py:207-213``).  We keep the
same keys so bundles interoperate both ways.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

# 13 CheXpert-style classes, fixed order (reference backend/api/views.py:28-42).
DISEASES = [
    "No Finding",
    "Enlarged Cardiomediastinum",
    "Cardiomegaly",
    "Lung Opacity",
    "Lung Lesion",
    "Edema",
    "Consolidation",
    "Pneumonia",
    "Atelectasis",
    "Pneumothorax",
    "Pleural Effusion",
    "Pleural Other",
    "Fracture",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ImageEncoderConfig:
    """ResNet-50 tower + projection head (reference training_pipeline.py:157-311)."""

    backbone: str = "resnet50"
    d_img: int = 1024
    n_disease: int = 13
    use_warmup_classifier: bool = True
    img_size: int = 224
    resize_size: int = 256
    mean: tuple[float, ...] = IMAGENET_MEAN
    std: tuple[float, ...] = IMAGENET_STD
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    feat_dim: int = 2048  # pooled ResNet-50 feature width
    # Pallas fused bottleneck (ops/pallas_bottleneck) for inference-mode
    # stride-1 blocks up to this width — the HBM-bound early stages (width
    # 64/128 = stages 1-2). 0 disables. Compiled-Pallas is TPU-only, so the
    # engine flips this on in fast mode; training always uses the XLA path.
    use_fused_bottleneck: bool = False
    fused_bottleneck_max_width: int = 128
    # Inference-only BN folding: batchnorm scale/shift folded into the conv
    # weights (f32 fold, cast to compute dtype), removing every BN op from
    # the serving graph. Honest measurement (bench.py + device trace): ~1%
    # end-to-end — XLA already fuses inference BN into the conv epilogues —
    # kept because the BN-free graph is simpler and drops the batch_stats
    # dependence from the serving path.
    use_folded_bn: bool = False


@dataclass(frozen=True)
class TextEncoderConfig:
    """BERT-base tower + masked-mean-pool + projection (reference :348-508)."""

    hf_model_name: str = "bert-base-uncased"
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    d_txt: int = 512
    n_disease: int = 13
    use_warmup_classifier: bool = True
    max_len: int = 96
    pooling: str = "masked_mean"
    pad_token_id: int = 0
    # Pallas blockwise attention (ops/pallas_attention): consulted per traced
    # sequence length — kicks in only at >= flash_min_seq_len, where the
    # blockwise kernel beats materializing [L, L] scores. At the reference's
    # bucketed 32-96 tokens the einsum path wins (scores fit in VMEM and XLA
    # fuses them), so serving enables the flag and the rule keeps short
    # sequences on einsum; long-context configs get flash automatically.
    use_flash_attention: bool = False
    flash_min_seq_len: int = 256
    use_fused_ffn: bool = False  # Pallas fused FFN+residual+LN (ops/pallas_ffn)
    # Pallas fused attention BLOCK (ops/pallas_bert_attn) for the short
    # bucketed serving lengths, where XLA's [B,h,L,L] tensors tile badly;
    # beyond this length the scores stop fitting the packed-[R,R] scheme and
    # the einsum/flash paths take over.
    use_fused_attn_block: bool = False
    fused_attn_max_seq_len: int = 128
    # int8 W8A8 matmuls inside the fused Pallas blocks (per-row dynamic
    # activation scales, per-channel weight scales): 2x the MXU rate on the
    # QKV/out/FFN projections, which are ~97% of the tower's FLOPs. Output
    # differs from bf16 at quantization-noise level (tests/test_int8_text.py)
    # so this is opt-in: the engine enables it in turbo mode only. Takes
    # effect only where use_fused_attn_block / use_fused_ffn apply.
    int8_matmuls: bool = False


@dataclass(frozen=True)
class ReportDecoderConfig:
    """T5-small conditional generator (reference :516-618).

    Matches HF t5-small architecture: 6+6 layers, d_model 512, relative position
    bias, RMSNorm, ReLU FFN, tied embeddings with d_model**-0.5 output scaling.
    """

    hf_model_name: str = "t5-small"
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.1
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    tie_word_embeddings: bool = True
    feed_forward_proj: str = "relu"
    max_report_len: int = 256
    # Pallas beam-decode attention (ops/pallas_beam_attn): reads the flat
    # physical KV cache once per step with the per-head split done in VMEM —
    # the XLA einsum relayouts the whole cache in HBM every step. Compiled-
    # Pallas is TPU-only; the engine flips this on in fast mode.
    use_fused_beam_attn: bool = False
    # Pallas fused cross-attention + FFN decoder half-step
    # (ops/pallas_t5_step): one dispatch per layer instead of ~20 tiny XLA
    # ops (~290 us/step of the round-3 beam budget). TPU-only; engine fast
    # mode enables it.
    use_fused_cross_ffn: bool = False
    # int8 beam KV cache (ancestry layout only): K/V rows are quantized at
    # write time with per-(row, head) scales and dequantized inside the
    # attention read — the beam step's dominant HBM stream (the full cache,
    # re-read per layer per step) halves. Outputs differ from bf16 at the
    # quantization-noise level (guardrail: tests/test_kv_int8.py), so this
    # is opt-in: the engine enables it in turbo mode only.
    kv_cache_int8: bool = False
    # Streaming lm_head (ops/pallas_lm_head): decode_step_beam defers the
    # tied-head matmul so beam search fuses it with candidate selection —
    # logits touch HBM once per step instead of ~4x. Online logsumexp is
    # mathematically (not bitwise) the dense chain's L, so fast/turbo only;
    # takes effect only for tied embeddings and lane-aligned vocabs.
    use_fused_lm_head: bool = False
    # Emit decode-step logits pre-chunked as [N, V/128, 128] (tied embeddings,
    # lane-aligned vocab only): the beam candidate chain consumes logits in
    # that chunk layout, and producing it at the lm-head einsum removes an
    # XLA layout-assignment artifact — the flat [N, V] f32 logits were
    # relayouted {1,0}->{0,1}->{2,1,0} around the reshape, a no-op round trip
    # costing ~98 us/step at serving shape (round-5 HLO dump + trace). Values
    # are the same contraction; only the logsumexp's reduce shape changes
    # (ulp-level), so fast/turbo beam only — parity mode keeps flat logits.
    chunked_step_logits: bool = False
    # Beam decode: attend over the OLD cache (own token composed outside the
    # kernel from softmax partials) so the per-layer cache
    # dynamic-update-slices move off the serial qkv->attention critical path
    # — each exposed ~17 us/step of DMA latency in the round-5 trace while
    # the isolated op costs 0.6 us. Softmax composition is mathematically
    # identical (ulp-level rounding differences), so fast/turbo beam only.
    # Requires use_fused_beam_attn; ignored for the int8 KV cache and nb=1.
    deferred_kv_writes: bool = False
    # Emit chunked decode-step logits in bf16 instead of f32 (the MXU still
    # accumulates the lm-head contraction in f32; only the materialized
    # [N, C, 128] tensor rounds to bf16, halving its write + two reads in
    # the candidate chain). Selection runs on bf16-rounded logits — in-tier
    # noise for fast/turbo whose towers already compute in bf16; parity mode
    # keeps f32.
    step_logits_bf16: bool = False


@dataclass(frozen=True)
class FusionConfig:
    """Late-fusion MLP + disease head + conditioning projection (reference :516-558)."""

    d_img: int = 1024
    d_txt: int = 512
    d_fuse_hidden: int = 1024
    n_disease: int = 13
    n_cond_tokens: int = 4
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default


@dataclass(frozen=True)
class GenerationConfig:
    """Beam-search settings (reference inference_pipeline.py:190)."""

    max_new_tokens: int = 180
    min_new_tokens: int = 150
    num_beams: int = 4
    no_repeat_ngram_size: int = 3
    length_penalty: float = 1.1
    early_stopping: bool = True
    eos_token_id: int = 1
    pad_token_id: int = 0
    decoder_start_token_id: int = 0


@dataclass(frozen=True)
class DiagnosisConfig:
    """Full flagship model config: image + text towers, fusion, report decoder."""

    image: ImageEncoderConfig = field(default_factory=ImageEncoderConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    report: ReportDecoderConfig = field(default_factory=ReportDecoderConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    class_names: tuple[str, ...] = tuple(DISEASES)
    thresholds: tuple[float, ...] = tuple([0.5] * 13)

    # ------------------------------------------------------------------
    # reference config.json round trip
    # ------------------------------------------------------------------
    def to_reference_json(self) -> dict[str, Any]:
        """Serialize into the reference's config.json schema
        (training_pipeline.py:682-720)."""
        return {
            "fusion": {
                "d_img": self.fusion.d_img,
                "d_txt": self.fusion.d_txt,
                "d_fuse_hidden": self.fusion.d_fuse_hidden,
                "n_disease": self.fusion.n_disease,
                "n_cond_tokens": self.fusion.n_cond_tokens,
                "decoder_hidden": self.report.d_model,
            },
            "report_head": {"hf_model_name": self.report.hf_model_name},
            "text_encoder": {
                "hf_model_name": self.text.hf_model_name,
                "d_txt": self.text.d_txt,
                "pooling": self.text.pooling,
                "max_len": self.text.max_len,
            },
            "image_encoder": {
                "backbone": self.image.backbone,
                "d_img": self.image.d_img,
                "img_size": self.image.img_size,
                "normalize": {"mean": list(self.image.mean), "std": list(self.image.std)},
            },
            "artifacts": {
                "class_names": list(self.class_names),
                "thresholds": list(self.thresholds),
            },
            "notes": "Fusion MLP + disease head (BCEWithLogits) + T5 report head (CE).",
        }

    @classmethod
    def from_reference_json(cls, cfg: dict[str, Any]) -> "DiagnosisConfig":
        """Rebuild from a reference config.json dict (with reference fallbacks,
        see views.py:207-213 — note we use the serving-path fallback d_txt=512,
        not the registry path's buggy 1024 fallback at inference_pipeline.py:74)."""
        f = cfg.get("fusion") or {}
        te = cfg.get("text_encoder") or {}
        ie = cfg.get("image_encoder") or {}
        rh = cfg.get("report_head") or {}
        art = cfg.get("artifacts") or {}
        d_img = f.get("d_img", 1024)
        d_txt = f.get("d_txt", 512)
        n_disease = f.get("n_disease", 13)
        norm = ie.get("normalize") or {}
        fusion = FusionConfig(
            d_img=d_img,
            d_txt=d_txt,
            d_fuse_hidden=f.get("d_fuse_hidden", 1024),
            n_disease=n_disease,
            n_cond_tokens=f.get("n_cond_tokens", 4),
        )
        image = ImageEncoderConfig(
            backbone=ie.get("backbone", "resnet50"),
            d_img=d_img,
            n_disease=n_disease,
            img_size=ie.get("img_size", 224),
            mean=tuple(norm.get("mean", IMAGENET_MEAN)),
            std=tuple(norm.get("std", IMAGENET_STD)),
        )
        text = TextEncoderConfig(
            hf_model_name=te.get("hf_model_name", "bert-base-uncased"),
            d_txt=d_txt,
            n_disease=n_disease,
            max_len=te.get("max_len", 96),
            pooling=te.get("pooling", "masked_mean"),
        )
        report = ReportDecoderConfig(
            hf_model_name=rh.get("hf_model_name", "t5-small"),
            d_model=f.get("decoder_hidden", 512) or 512,
        )
        class_names = tuple(art.get("class_names", DISEASES))
        thresholds = tuple(art.get("thresholds", [0.5] * n_disease))
        return cls(
            image=image,
            text=text,
            fusion=fusion,
            report=report,
            class_names=class_names,
            thresholds=thresholds,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, s: str) -> "DiagnosisConfig":
        raw = json.loads(s)

        def _mk(klass, d):
            fields = {f.name for f in dataclasses.fields(klass)}
            kw = {}
            for k, v in d.items():
                if k in fields:
                    kw[k] = tuple(v) if isinstance(v, list) else v
            return klass(**kw)

        return cls(
            image=_mk(ImageEncoderConfig, raw.get("image", {})),
            text=_mk(TextEncoderConfig, raw.get("text", {})),
            fusion=_mk(FusionConfig, raw.get("fusion", {})),
            report=_mk(ReportDecoderConfig, raw.get("report", {})),
            generation=_mk(GenerationConfig, raw.get("generation", {})),
            class_names=tuple(raw.get("class_names", DISEASES)),
            thresholds=tuple(raw.get("thresholds", [0.5] * 13)),
        )
