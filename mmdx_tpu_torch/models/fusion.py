"""Late-fusion head: concat -> MLP -> {disease logits, T5 conditioning tokens}.

Port of ``mmdx_tpu/models/fusion.py``: ``fuse`` (``:47-53``, exact-erf GELU,
LayerNorm eps 1e-5), ``make_cond_tokens`` (``:55-60``) and ``cond_and_cache``
(``:80-98``), which prepares the decoder's conditioning, cross k/v, empty
beam cache, causal bias and encoder mask for generation; and the training
forward (``__call__``, ``:66-82``): dropout on the fused hidden state (from
the caller's ``drop``), the disease logits, and with ``report_labels`` the
teacher-forced report logits of ``T5.decode`` over the shifted labels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import FusionConfig, ReportDecoderConfig
from mmdx_tpu_torch.models.layers import Dense, LayerNorm
from mmdx_tpu_torch.models.t5 import T5, shift_right


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

    @staticmethod
    def _whole(dense, h):
        """``h``, the GELU of a column-parallel ``dense``'s output, put
        together on every model rank; unchanged when ``dense`` is whole."""
        if dense.tp is None:
            return h
        from mmdx_tpu_torch.parallel.sharding import gather_columns

        return gather_columns(h, dense.tp[1])

    def fuse(self, z_img, z_txt, drop=None):
        """[B, d_img], [B, d_txt] -> z_fuse [B, d_fuse_hidden]; ``drop``
        (training) applies dropout before the LayerNorm."""
        h = self._whole(self.fuse_dense,
                        F.gelu(self.fuse_dense(torch.cat([z_img, z_txt], dim=-1))))
        if drop is not None:
            h = drop(h)
        return self.fuse_ln(h)

    def make_cond_tokens(self, z_fuse):
        """-> synthetic encoder outputs [B, K, d_model]."""
        cond = self._whole(self.cond_proj, F.gelu(self.cond_proj(z_fuse)))
        return cond.reshape(z_fuse.shape[0], self.cfg.n_cond_tokens,
                            self.report_cfg.d_model)

    def forward(self, z_img, z_txt, report_labels=None, drop=None) -> dict:
        """-> {"z_fuse", "disease_logits"[, "report_logits" f32 [B, L, V]]}."""
        z_fuse = self.fuse(z_img, z_txt, drop)
        out = {"z_fuse": z_fuse, "disease_logits": self.disease_head(z_fuse)}
        if report_labels is not None:
            cond = self.make_cond_tokens(z_fuse)
            enc_mask = torch.ones(cond.shape[:2], dtype=torch.int32, device=cond.device)
            dec_in = shift_right(report_labels, self.report_cfg.decoder_start_token_id,
                                 self.report_cfg.pad_token_id)
            out["report_logits"] = self.report_model.decode(dec_in, cond, enc_mask)
        return out

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
