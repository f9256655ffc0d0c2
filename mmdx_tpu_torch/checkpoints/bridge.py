"""Weight bridge: the JAX package's variable tree -> the port's modules.

Port of the loading side of ``mmdx_tpu/checkpoints/bundle.py`` and its use of
``mmdx_tpu/checkpoints/torch_import.py``, without flax:

* ``variables_to_torch(variables, config)`` takes the JAX variable tree as
  numpy arrays (``{"params": {...}, "batch_stats": {...}}``,
  ``bundle.py:183-203``) and fills a ``DiagnosisModel`` (f32, CPU), loaded
  strictly. On the way it folds each BatchNorm into its conv in f32
  (``pallas_bottleneck.fold_bn``), turns HWIO kernels into OIHW, and merges
  BERT's q/k/v kernels into the [H, 3H] block the attention kernel takes.
* ``load_reference_bundle_pt(path)`` reads the reference-format
  ``model_bundle.pt`` through the port's copy of
  ``checkpoints/torch_import.py`` and runs the same bridge — the port's
  jax-free serving format.
* ``qparams_from_jax(q)`` turns the JAX int8 tower's ``quantize_backbone``
  tree (numpy leaves) into the port's qparams.
* ``random_state(config, seed)`` makes full-width random weights with numpy
  in the same tree layout (no downloads).
* ``default_vocabs()`` reads the shipped tokenizer vocabs
  (``bundle.py:211-233``).

Loading ``.mmdx`` (flax msgpack) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
import numpy as np
import torch

from mmdx_tpu_torch.config import DISEASES, DiagnosisConfig
from mmdx_tpu_torch.models.diagnosis import DiagnosisModel
from mmdx_tpu_torch.models.resnet import RESNET50_STAGES
from mmdx_tpu_torch.models.resnet_int8 import gemm_weight, hwio_view

ASSETS = Path(__file__).resolve().parents[2] / "mmdx_tpu" / "assets"


@dataclass
class TorchBundle:
    """The port's counterpart of ``mmdx_tpu.checkpoints.bundle.ModelBundle``:
    config, the f32 CPU model, tokenizer vocabs, class names, thresholds and
    metadata (``int8_scales``: the turbo tower's calibrated {site: amax})."""

    config: DiagnosisConfig
    model: DiagnosisModel
    bert_vocab: dict[str, int]
    t5_vocab: dict[str, int]
    class_names: list[str]
    thresholds: list[float]
    version: int = 1
    t5_scores: dict[int, float] | None = None
    metadata: dict | None = None

    def tokenizers(self):
        """(BERT WordPiece, T5 unigram) tokenizers over the C++ cores
        (``native/``) where they build, with output identical to the pure
        Python tokenizers, which they fall back to otherwise; each native
        tokenizer says which it runs (``native_available``). As
        ``mmdx_tpu/checkpoints/bundle.py:46-86``."""
        return self._bert_tokenizer(), self._t5_tokenizer()

    def _t5_tokenizer(self):
        """The unigram Viterbi core when the vocab is scored; pure Python
        otherwise (an unscored vocab segments greedily, in Python)."""
        from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer

        if self.t5_scores:
            from mmdx_tpu_torch.text.native_unigram import NativeT5Tokenizer

            lines = [f"{t}\t{self.t5_scores.get(i, 0.0)}"
                     for t, i in sorted(self.t5_vocab.items(), key=lambda kv: kv[1])]
            tok = NativeT5Tokenizer(staged_vocab_file("t5", lines))
            if tok.native_available:
                return tok
        return T5StyleTokenizer(vocab=self.t5_vocab, scores=self.t5_scores)

    def _bert_tokenizer(self):
        """The WordPiece core (it loads its vocab from a file, so the
        in-memory vocab is staged to a content-addressed one)."""
        from mmdx_tpu_torch.text.native_wordpiece import NativeWordPieceTokenizer
        from mmdx_tpu_torch.text.wordpiece import WordPieceTokenizer

        lines = [t for t, _ in sorted(self.bert_vocab.items(), key=lambda kv: kv[1])]
        tok = NativeWordPieceTokenizer(staged_vocab_file("bert", lines))
        if tok.native_available:
            return tok
        return WordPieceTokenizer(vocab=self.bert_vocab)


def staged_vocab_file(kind: str, lines: list[str]) -> Path:
    """An in-memory vocab as a content-addressed file in the temp directory
    (the native tokenizers load from a path); written atomically, so
    processes that stage the same vocab share one file
    (``mmdx_tpu/checkpoints/bundle.py:95``)."""
    import hashlib
    import os
    import tempfile

    blob = ("\n".join(lines) + "\n").encode("utf-8")
    digest = hashlib.sha256(blob).hexdigest()[:16]
    path = Path(tempfile.gettempdir()) / f"mmdx_{kind}_vocab_{digest}.txt"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(blob)
        tmp.replace(path)
    return path


def default_vocabs():
    """(bert_vocab, t5_vocab, t5_scores) from the shipped asset files: BERT
    piece-per-line; T5 scored TSV (spm_export_vocab) or piece-per-line."""
    bert = {t: i for i, t in enumerate(
        (ASSETS / "bert_vocab.txt").read_text(encoding="utf-8").splitlines())}
    t5: dict[str, int] = {}
    scores: dict[int, float] = {}
    for i, line in enumerate((ASSETS / "t5_vocab.txt").read_text(
            encoding="utf-8").splitlines()):
        piece, sep, score = line.partition("\t")
        t5[piece] = i
        if sep:
            scores[i] = float(score)
    return bert, t5, (scores or None)


# ---------------------------------------------------------------------------
# JAX variable tree -> port state dict
# ---------------------------------------------------------------------------
def _fold_conv(kernel, bn: dict, stats: dict, eps: float):
    """HWIO kernel + BN -> (OIHW weight, bias), folded in f32 in the order of
    ``pallas_bottleneck.fold_bn``: ``scale * rsqrt(var + eps)``, the sum in
    f32 and its reciprocal square root rounded to f32 once (XLA's CPU
    ``rsqrt`` is an estimate, so its last bit is not a fixed target)."""
    ve = np.asarray(stats["var"], np.float32) + np.float32(eps)
    r = (1.0 / np.sqrt(ve.astype(np.float64))).astype(np.float32)
    s = np.asarray(bn["scale"], np.float32) * r
    w = np.asarray(kernel, np.float32) * s
    b = np.asarray(bn["bias"], np.float32) - np.asarray(stats["mean"], np.float32) * s
    return np.transpose(w, (3, 2, 0, 1)), b


def _image_state(p: dict, s: dict, cfg) -> dict:
    out = {}
    bp, bs = p["backbone"], s["backbone"]
    eps = cfg.image.bn_eps
    out["backbone.stem.weight"], out["backbone.stem.bias"] = _fold_conv(
        bp["conv_stem"]["kernel"], bp["bn_stem"], bs["bn_stem"], eps)
    i = 0
    for stage, n_blocks in enumerate(RESNET50_STAGES):
        for block in range(n_blocks):
            name = f"layer{stage + 1}_block{block}"
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                             ("downsample_conv", "downsample_bn")):
                if conv not in bp[name]:
                    continue
                key = "downsample" if conv == "downsample_conv" else conv
                w, b = _fold_conv(bp[name][conv]["kernel"], bp[name][bn],
                                  bs[name][bn], eps)
                out[f"backbone.blocks.{i}.{key}.weight"] = w
                out[f"backbone.blocks.{i}.{key}.bias"] = b
            i += 1
    for head in ("proj", "classifier"):
        if head in p:
            out[f"{head}.kernel"] = p[head]["kernel"]
            out[f"{head}.bias"] = p[head]["bias"]
    return out


def _dense(out: dict, key: str, tree: dict) -> None:
    out[f"{key}.kernel"] = tree["kernel"]
    if "bias" in tree:
        out[f"{key}.bias"] = tree["bias"]


def _text_state(p: dict, cfg) -> dict:
    out = {}
    bert = p["bert"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"bert.{name}"] = bert[name]["embedding"]
    out["bert.embeddings_ln.scale"] = bert["embeddings_ln"]["scale"]
    out["bert.embeddings_ln.bias"] = bert["embeddings_ln"]["bias"]
    for i in range(cfg.text.num_layers):
        L, t = bert[f"layer{i}"], f"bert.layers.{i}"
        out[f"{t}.attn_qkv.kernel"] = np.concatenate(
            [np.asarray(L[k]["kernel"]) for k in ("attn_q", "attn_k", "attn_v")], axis=1)
        out[f"{t}.attn_qkv.bias"] = np.concatenate(
            [np.asarray(L[k]["bias"]) for k in ("attn_q", "attn_k", "attn_v")])
        for k in ("attn_out", "ffn_in", "ffn_out"):
            _dense(out, f"{t}.{k}", L[k])
        for k in ("attn_ln", "ffn_ln"):
            out[f"{t}.{k}.scale"] = L[k]["scale"]
            out[f"{t}.{k}.bias"] = L[k]["bias"]
    if "pooler" in bert:
        _dense(out, "bert.pooler", bert["pooler"])
    for head in ("proj", "classifier"):
        if head in p:
            _dense(out, head, p[head])
    return out


def _t5_attn(out: dict, key: str, tree: dict) -> None:
    for m in ("q", "k", "v", "o"):
        out[f"{key}.{m}.kernel"] = tree[m]["kernel"]


def _t5_state(p: dict, tied: bool) -> dict:
    out = {"shared": p["shared"]["embedding"],
           "decoder_rel_bias.embedding": p["decoder_rel_bias"]["embedding"],
           "decoder_final_ln.scale": p["decoder_final_ln"]["scale"]}
    if not tied:  # HF checkpoints also carry lm_head as the tied alias
        out["lm_head.kernel"] = p["lm_head"]["kernel"]
    layers = [(k, "decoder_layers") for k in p if k.startswith("decoder_layer")]
    layers += [(k, "encoder_layers") for k in p if k.startswith("encoder_layer")]
    for name, group in layers:
        L = p[name]
        t = f"{group}.{int(name.rsplit('layer', 1)[1])}"
        for sub in ("self_attn", "cross_attn"):
            if sub in L:
                _t5_attn(out, f"{t}.{sub}", L[sub])
        for ln in ("self_ln", "cross_ln", "ffn_ln"):
            if ln in L:
                out[f"{t}.{ln}.scale"] = L[ln]["scale"]
        out[f"{t}.ffn_wi.kernel"] = L["ffn_wi"]["kernel"]
        out[f"{t}.ffn_wo.kernel"] = L["ffn_wo"]["kernel"]
    if any(g == "encoder_layers" for _, g in layers):
        out["encoder_rel_bias.embedding"] = p["encoder_rel_bias"]["embedding"]
        out["encoder_final_ln.scale"] = p["encoder_final_ln"]["scale"]
    return out


def variables_to_state_dict(variables: dict, config: DiagnosisConfig) -> dict:
    """JAX variable tree (numpy leaves) -> the port's state dict (numpy)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for k, v in _image_state(params["image_encoder"], stats["image_encoder"],
                             config).items():
        sd[f"image_encoder.{k}"] = v
    for k, v in _text_state(params["text_encoder"], config).items():
        sd[f"text_encoder.{k}"] = v
    f = params["fusion"]
    for k in ("fuse_dense", "disease_head", "cond_proj"):
        _dense(sd, f"fusion.{k}", f[k])
    sd["fusion.fuse_ln.scale"] = f["fuse_ln"]["scale"]
    sd["fusion.fuse_ln.bias"] = f["fuse_ln"]["bias"]
    for k, v in _t5_state(f["report_model"], config.report.tie_word_embeddings).items():
        sd[f"fusion.report_model.{k}"] = v
    return sd


def variables_to_torch(variables: dict, config: DiagnosisConfig) -> DiagnosisModel:
    """Fill the port's model (f32, CPU, eval) from a JAX variable tree; every
    parameter must be matched (strict load)."""
    t5 = variables["params"]["fusion"]["report_model"]
    n_enc = sum(1 for k in t5 if k.startswith("encoder_layer"))
    pooler = "pooler" in variables["params"]["text_encoder"]["bert"]
    model = DiagnosisModel(config, t5_encoder_layers=n_enc, bert_pooler=pooler)
    sd = variables_to_state_dict(variables, config)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()},
        strict=True)
    return model.eval()


def bundle_from_variables(variables: dict, config: DiagnosisConfig, *,
                          class_names=None, thresholds=None, version: int = 1,
                          metadata: dict | None = None) -> TorchBundle:
    bert, t5, scores = default_vocabs()
    return TorchBundle(
        config=config, model=variables_to_torch(variables, config),
        bert_vocab=bert, t5_vocab=t5, t5_scores=scores,
        class_names=list(class_names or config.class_names),
        thresholds=list(thresholds or config.thresholds), version=version,
        metadata=dict(metadata or {}))


def load_reference_bundle_pt(path, config: DiagnosisConfig | None = None) -> TorchBundle:
    """The reference's single-file ``model_bundle.pt`` (cfg + three torch
    state dicts) -> TorchBundle.

    The reference ``cfg`` carries widths but no head counts or depths, so
    ``DiagnosisConfig.from_reference_json`` gives the reference's own
    architecture; a model of other widths passes its ``config``."""
    from mmdx_tpu_torch.checkpoints import torch_import as ti

    blob = ti.load_torch_state_dict(path)
    missing = {"cfg", "fusion_state", "image_state", "text_state"} - set(blob)
    if missing:
        raise ValueError(f"Bundle missing keys: {missing}")
    config = config or DiagnosisConfig.from_reference_json(blob["cfg"])
    image = ti.import_image_encoder(blob["image_state"])
    text = ti.import_text_encoder(blob["text_state"])
    fusion = ti.import_fusion(blob["fusion_state"])
    variables = {
        "params": {"image_encoder": image["params"], "text_encoder": text["params"],
                   "fusion": fusion["params"]},
        "batch_stats": {"image_encoder": image["batch_stats"]},
    }
    art = blob["cfg"].get("artifacts") or {}
    return bundle_from_variables(
        variables, config, class_names=art.get("class_names", list(DISEASES)),
        thresholds=art.get("thresholds"), version=int(blob.get("version", 1)),
        metadata={"imported_from": "torch_model_bundle"})


def qparams_from_jax(q: dict) -> dict:
    """The JAX ``resnet_int8.quantize_backbone`` tree, as numpy leaves, ->
    the port's qparams (``models/resnet_int8.quantize_backbone``'s layout):
    the same int8 HWIO weights as a view of their K-major GEMM operand
    ``wk [co, K]`` (laid out once, here), f32 scales and biases as CPU
    tensors, the activation scales as floats; the TPU's space-to-depth
    weights (``w_s2d``) are dropped."""
    def conv(d):
        out = {k: torch.from_numpy(np.array(v)) for k, v in d.items() if k != "w_s2d"}
        out["wk"] = gemm_weight(out["w"])
        out["w"] = hwio_view(out["wk"], out["w"].shape)
        return out

    out = {"scales": {k: float(np.float32(v)) for k, v in q["scales"].items()}}
    for name, tree in q.items():
        if name == "scales":
            continue
        out[name] = conv(tree) if "w" in tree else {k: conv(v) for k, v in tree.items()}
    return out


# ---------------------------------------------------------------------------
# random weights (numpy, seeded) in the JAX tree layout
# ---------------------------------------------------------------------------
def small_config() -> DiagnosisConfig:
    """The full architecture at the narrow widths of
    ``mmdx_tpu.checkpoints.bundle.new_random_bundle(small=True)`` (tests)."""
    from mmdx_tpu_torch.config import (FusionConfig, ImageEncoderConfig,
                                       ReportDecoderConfig, TextEncoderConfig)

    bert, t5, _ = default_vocabs()
    return DiagnosisConfig(
        image=ImageEncoderConfig(d_img=64, img_size=64),
        text=TextEncoderConfig(vocab_size=len(bert), hidden_size=64, num_layers=2,
                               num_heads=4, intermediate_size=128, d_txt=32,
                               max_len=32, max_position_embeddings=64),
        fusion=FusionConfig(d_img=64, d_txt=32, d_fuse_hidden=64),
        report=ReportDecoderConfig(vocab_size=len(t5), d_model=64, d_kv=16, d_ff=128,
                                   num_layers=2, num_decoder_layers=2, num_heads=4),
    )


def random_state(config: DiagnosisConfig, seed: int = 0) -> dict:
    """Random full-architecture variables for ``config`` as numpy f32:
    lecun-normal kernels, zero biases, unit norm scales, BN statistics near
    (0, 1) so the folded convs differ from the raw ones."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def dense(d_in, d_out, bias=True):
        t = {"kernel": normal(d_in, d_out, std=d_in ** -0.5)}
        if bias:
            t["bias"] = np.zeros(d_out, np.float32)
        return t

    def ln(d):
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def conv_bn(k, cin, cout):
        kernel = normal(k, k, cin, cout, std=(k * k * cin) ** -0.5)
        bn = {"scale": 1.0 + normal(cout, std=0.1), "bias": normal(cout, std=0.1)}
        st = {"mean": normal(cout, std=0.1),
              "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
        return {"kernel": kernel}, bn, st

    ic, tc, fc, rc = config.image, config.text, config.fusion, config.report
    bp, bs = {}, {}
    bp["conv_stem"], bp["bn_stem"], bs["bn_stem"] = conv_bn(7, 3, 64)
    cin = 64
    for stage, n_blocks in enumerate(RESNET50_STAGES):
        width = 64 * 2 ** stage
        for block in range(n_blocks):
            name = f"layer{stage + 1}_block{block}"
            p, s = {}, {}
            p["conv1"], p["bn1"], s["bn1"] = conv_bn(1, cin, width)
            p["conv2"], p["bn2"], s["bn2"] = conv_bn(3, width, width)
            p["conv3"], p["bn3"], s["bn3"] = conv_bn(1, width, 4 * width)
            if block == 0:
                p["downsample_conv"], p["downsample_bn"], s["downsample_bn"] = \
                    conv_bn(1, cin, 4 * width)
            bp[name], bs[name] = p, s
            cin = 4 * width
    image = {"backbone": bp, "proj": dense(ic.feat_dim, ic.d_img),
             "classifier": dense(ic.d_img, ic.n_disease)}

    h = tc.hidden_size
    bert = {"word_embeddings": {"embedding": normal(tc.vocab_size, h, std=h ** -0.5)},
            "position_embeddings": {"embedding": normal(tc.max_position_embeddings, h,
                                                        std=h ** -0.5)},
            "token_type_embeddings": {"embedding": normal(tc.type_vocab_size, h,
                                                          std=h ** -0.5)},
            "embeddings_ln": ln(h), "pooler": dense(h, h)}
    for i in range(tc.num_layers):
        bert[f"layer{i}"] = {
            "attn_q": dense(h, h), "attn_k": dense(h, h), "attn_v": dense(h, h),
            "attn_out": dense(h, h), "attn_ln": ln(h),
            "ffn_in": dense(h, tc.intermediate_size),
            "ffn_out": dense(tc.intermediate_size, h), "ffn_ln": ln(h)}
    text = {"bert": bert, "proj": dense(h, tc.d_txt),
            "classifier": dense(tc.d_txt, tc.n_disease)}

    dm, inner = rc.d_model, rc.num_heads * rc.d_kv

    def attn():
        return {"q": dense(dm, inner, False), "k": dense(dm, inner, False),
                "v": dense(dm, inner, False), "o": dense(inner, dm, False)}

    t5 = {"shared": {"embedding": normal(rc.vocab_size, dm, std=dm ** -0.5)},
          "decoder_rel_bias": {"embedding": normal(rc.relative_attention_num_buckets,
                                                   rc.num_heads, std=1.0)},
          "decoder_final_ln": {"scale": np.ones(dm, np.float32)}}
    for i in range(rc.num_decoder_layers):
        t5[f"decoder_layer{i}"] = {
            "self_attn": attn(), "self_ln": {"scale": np.ones(dm, np.float32)},
            "cross_attn": attn(), "cross_ln": {"scale": np.ones(dm, np.float32)},
            "ffn_wi": dense(dm, rc.d_ff, False), "ffn_wo": dense(rc.d_ff, dm, False),
            "ffn_ln": {"scale": np.ones(dm, np.float32)}}
    fusion = {"fuse_dense": dense(fc.d_img + fc.d_txt, fc.d_fuse_hidden),
              "fuse_ln": ln(fc.d_fuse_hidden),
              "disease_head": dense(fc.d_fuse_hidden, fc.n_disease),
              "cond_proj": dense(fc.d_fuse_hidden, dm * fc.n_cond_tokens),
              "report_model": t5}
    return {"params": {"image_encoder": image, "text_encoder": text, "fusion": fusion},
            "batch_stats": {"image_encoder": {"backbone": bs}}}
