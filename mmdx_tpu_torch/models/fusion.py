"""Late-fusion head: concat -> MLP -> {disease logits, T5 conditioning tokens}.

Port of ``mmdx_tpu/models/fusion.py``: ``fuse`` (``:47-53``, exact-erf GELU,
LayerNorm eps 1e-5), ``make_cond_tokens`` (``:55-60``) and ``cond_and_cache``
(``:80-98``), which prepares the decoder's conditioning, cross k/v, empty
beam cache, causal bias and encoder mask for generation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import FusionConfig, ReportDecoderConfig
from mmdx_tpu_torch.models.layers import Dense, LayerNorm
from mmdx_tpu_torch.models.t5 import T5


class FusionModel(nn.Module):
    def __init__(self, cfg: FusionConfig, report_cfg: ReportDecoderConfig,
                 t5_encoder_layers: int = 0):
        super().__init__()
        self.cfg, self.report_cfg = cfg, report_cfg
        self.fuse_dense = Dense(cfg.d_img + cfg.d_txt, cfg.d_fuse_hidden)
        self.fuse_ln = LayerNorm(cfg.d_fuse_hidden, cfg.layer_norm_eps)
        self.disease_head = Dense(cfg.d_fuse_hidden, cfg.n_disease)
        self.cond_proj = Dense(cfg.d_fuse_hidden, report_cfg.d_model * cfg.n_cond_tokens)
        self.report_model = T5(report_cfg, t5_encoder_layers)

    def fuse(self, z_img, z_txt):
        """[B, d_img], [B, d_txt] -> z_fuse [B, d_fuse_hidden]."""
        h = F.gelu(self.fuse_dense(torch.cat([z_img, z_txt], dim=-1)))
        return self.fuse_ln(h)

    def make_cond_tokens(self, z_fuse):
        """-> synthetic encoder outputs [B, K, d_model]."""
        cond = F.gelu(self.cond_proj(z_fuse))
        return cond.reshape(z_fuse.shape[0], self.cfg.n_cond_tokens,
                            self.report_cfg.d_model)

    def cond_and_cache(self, z_img, z_txt, max_len: int, beam_width: int,
                       kv_int8: bool = False) -> dict:
        z_fuse = self.fuse(z_img, z_txt)
        cond = self.make_cond_tokens(z_fuse)
        cache, static_kv = self.report_model.init_cache(cond.shape[0], max_len, cond,
                                                        beam_width, kv_int8)
        return {
            "disease_logits": self.disease_head(z_fuse),
            "cond": cond,
            "cache": cache,
            "static_kv": static_kv,
            "self_bias": self.report_model.decode_self_bias(max_len),
            "enc_mask": torch.ones(cond.shape[:2], dtype=torch.int32,
                                   device=cond.device),
        }
