"""The flagship model: image tower + text tower + late fusion + report decoder.

Port of ``mmdx_tpu/models/diagnosis.py`` (``classify`` ``:45`` and
``classify_from_image_feats`` ``:62-81`` as one ``classify`` from the image
embeddings, ``prepare_generation`` /
``decode_step_beam`` ``:83-95``). ``kernels=True`` routes the text tower and
the decode step through the hand-written kernels (fast and turbo mode);
``kernels=False`` runs their plain versions (parity mode). ``int8=True``
runs the text tower's blocks in their W8A8 form (turbo mode).
"""
from __future__ import annotations

import torch
from torch import nn

from mmdx_tpu_torch.config import DiagnosisConfig
from mmdx_tpu_torch.models.bert import TextEncoder
from mmdx_tpu_torch.models.fusion import FusionModel
from mmdx_tpu_torch.models.layers import cast_
from mmdx_tpu_torch.models.resnet import ImageEncoder


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
