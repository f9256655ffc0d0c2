"""The flagship model: image tower + text tower + late fusion + report decoder.

Port of ``mmdx_tpu/models/diagnosis.py`` (``classify`` ``:45`` and
``classify_from_image_feats`` ``:62-81`` as one ``classify`` from the image
embeddings, ``prepare_generation`` /
``decode_step_beam`` ``:83-95``). ``kernels=True`` routes the text tower and
the decode step through the hand-written kernels (fast and turbo mode);
``kernels=False`` runs their plain versions (parity mode). ``int8=True``
runs the text tower's blocks in their W8A8 form (turbo mode).

``JointTrainModel`` is the training forward of the JAX
``MultiModalDiagnosisModel.__call__`` (``:97-114``, ``train=True`` with
``report_labels``): the trainable ResNet-50 with train-mode BatchNorm
(``models/resnet_train.py``), BERT's training route and heads, and the
fusion head with the teacher-forced report, in plain differentiable ops
(no hand-written kernel has a backward), as one module for the joint dp x
tp train step (``parallel/train.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from mmdx_tpu_torch.config import DiagnosisConfig
from mmdx_tpu_torch.models.bert import TextEncoder
from mmdx_tpu_torch.models.fusion import FusionModel
from mmdx_tpu_torch.models.layers import cast_
from mmdx_tpu_torch.models.resnet import ImageEncoder
from mmdx_tpu_torch.models import resnet_train


class DiagnosisModel(nn.Module):
    def __init__(self, config: DiagnosisConfig, t5_encoder_layers: int = 0,
                 bert_pooler: bool = True):
        super().__init__()
        self.config = config
        self.t5_encoder_layers, self.bert_pooler = t5_encoder_layers, bert_pooler
        self.image_encoder = ImageEncoder(config.image)
        self.text_encoder = TextEncoder(config.text, pooler=bert_pooler)
        self.fusion = FusionModel(config.fusion, config.report, t5_encoder_layers)

    def classify(self, z_img, input_ids, attention_mask, token_type_ids=None,
                 kernels: bool = False, int8: bool = False):
        """The image tower's embeddings [B, d_img] (``ImageEncoder.encode``,
        or ``project`` of the int8 tower's features) + token ids ->
        (probs [B, 13] f32, z_img, z_txt)."""
        z_txt = self.text_encoder.encode(input_ids, attention_mask, token_type_ids,
                                         kernels, int8)
        logits = self.fusion.disease_head(self.fusion.fuse(z_img, z_txt))
        return torch.sigmoid(logits.to(torch.float32)), z_img, z_txt

    def prepare_generation(self, z_img, z_txt, max_len: int, beam_width: int,
                           kv_int8: bool = False) -> dict:
        return self.fusion.cond_and_cache(z_img, z_txt, max_len, beam_width, kv_int8)

    def decode_step_beam(self, token_ids, pos: int, cache, anc, static_kv,
                         self_bias, enc_mask, kernels: bool = False, defer: bool = True,
                         lazy_logits: bool = False):
        return self.fusion.report_model.decode_step_beam(
            token_ids, pos, cache, anc, static_kv, self_bias, enc_mask, kernels, defer,
            lazy_logits)

    def with_config(self, config: DiagnosisConfig) -> "DiagnosisModel":
        """A new model (f32, CPU) with these weights, built under ``config``:
        the same widths with other route switches, which each module reads
        when it is built."""
        model = DiagnosisModel(config, self.t5_encoder_layers, self.bert_pooler)
        model.load_state_dict(self.state_dict())
        return model.eval()

    def cast_(self, dtype: torch.dtype) -> "DiagnosisModel":
        """``layers.cast_``: the weights to the compute dtype, in place."""
        return cast_(self, dtype)


class JointTrainModel(nn.Module):
    """Image tower + text tower + fusion (+ teacher-forced report), trainable
    end to end. Its weights move from and to the JAX variable tree through
    ``checkpoints/train_bridge.py`` (``joint_model``, ``joint_vars_of``)."""

    def __init__(self, config: DiagnosisConfig, t5_encoder_layers: int = 0,
                 bert_pooler: bool = True):
        super().__init__()
        self.config = config
        self.image_encoder = resnet_train.ImageEncoder(config.image)
        self.text_encoder = TextEncoder(config.text, pooler=bert_pooler)
        self.fusion = FusionModel(config.fusion, config.report, t5_encoder_layers)

    def forward(self, images, input_ids, attention_mask, token_type_ids=None,
                report_labels=None, drop_text=None, drop_fusion=None) -> dict:
        """Preprocessed NHWC images and token ids -> {"disease_logits",
        "z_fuse", "z_img", "z_txt", "image_logits", "text_logits"[,
        "report_logits" f32 [B, L, V]]}; ``drop_text`` and ``drop_fusion``
        are the towers' dropout (None: off)."""
        img = self.image_encoder(images, train=True)
        txt = self.text_encoder.encode_train(input_ids, attention_mask, token_type_ids,
                                             drop_text)
        out = self.fusion(img["embeddings"], txt["embeddings"],
                          report_labels=report_labels, drop=drop_fusion)
        out["z_img"], out["z_txt"] = img["embeddings"], txt["embeddings"]
        if "logits" in img:
            out["image_logits"] = img["logits"]
        if "logits" in txt:
            out["text_logits"] = txt["logits"]
        return out
