"""BERT-base text tower: embeddings, post-LN encoder layers, masked mean pool,
projection.

Port of ``mmdx_tpu/models/bert.py`` (``BertEncoder``, ``TextEncoder``) on the
fused-block route (``BertLayer`` at ``:66-92`` and ``_ffn`` at ``:135-150``):
each layer is the fused attention block followed by the fused FFN block.
With ``kernels=True`` they go through the hand-written kernels
(ops/bert_attn.py, ops/fused_ffn.py), the attention kernel only up to its
128-token limit as in the JAX route; otherwise through their plain
versions. LayerNorm eps 1e-12, exact-erf GELU, additive -1e9 key mask.

``int8=True`` (``int8_matmuls`` in the JAX config, the turbo tier) runs both
blocks in their W8A8 form (K7, K6: per-row activation scales, per-column
weight scales, tanh-GELU) from weights quantized once by
``TextEncoder.quantize_int8_`` from the weights as cast to the model dtype
(the JAX blocks quantize ``w.astype(self.dtype)`` at every call, ``bert.py:81-82,
145-146``: the same numbers). Beyond the 128-token limit the attention block
falls back to the bf16 route and the FFN stays W8A8, as in the JAX route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import TextEncoderConfig
from mmdx_tpu_torch.models.layers import Dense, LayerNorm, param
from mmdx_tpu_torch.ops import bert_attn, fused_ffn
from mmdx_tpu_torch.ops.pooling import masked_mean_pool

NEG_INF = -1e9


class BertLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.attn_qkv = Dense(h, 3 * h)  # merged q|k|v columns
        self.attn_out = Dense(h, h)
        self.attn_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.ffn_in = Dense(h, cfg.intermediate_size)
        self.ffn_out = Dense(cfg.intermediate_size, h)
        self.ffn_ln = LayerNorm(h, cfg.layer_norm_eps)

    def quantize_int8_(self) -> None:
        """Per-column int8 forms of the four projection weights (W8A8)."""
        self.int8 = {k: fused_ffn.quant_weight_cols(getattr(self, k).kernel)
                     for k in ("attn_qkv", "attn_out", "ffn_in", "ffn_out")}

    def forward(self, x, kmask, seq_len: int, kernels: bool, int8: bool = False):
        """x [B*L, H]; kmask [B*L] f32 additive -> [B*L, H]."""
        eps, heads = self.cfg.layer_norm_eps, self.cfg.num_heads
        fits = seq_len <= bert_attn.MAX_SEQ_LEN
        if int8 and fits:
            q = self.int8
            x = bert_attn.fused_attention_block_int8(
                x, kmask, *q["attn_qkv"], self.attn_qkv.bias, *q["attn_out"],
                self.attn_out.bias, self.attn_ln.scale, self.attn_ln.bias,
                seq_len=seq_len, num_heads=heads, eps=eps)
        else:
            attn = (bert_attn.fused_attention_block if kernels and fits
                    else bert_attn.fused_attention_block_plain)
            x = attn(x, kmask, self.attn_qkv.kernel, self.attn_qkv.bias,
                     self.attn_out.kernel, self.attn_out.bias, self.attn_ln.scale,
                     self.attn_ln.bias, seq_len=seq_len, num_heads=heads, eps=eps)
        if int8:
            q = self.int8
            return fused_ffn.fused_ffn_ln_int8(
                x, *q["ffn_in"], self.ffn_in.bias, *q["ffn_out"], self.ffn_out.bias,
                self.ffn_ln.scale, self.ffn_ln.bias, eps=eps)
        ffn = fused_ffn.fused_ffn_ln if kernels else fused_ffn.fused_ffn_ln_plain
        return ffn(x, self.ffn_in.kernel, self.ffn_in.bias, self.ffn_out.kernel,
                   self.ffn_out.bias, self.ffn_ln.scale, self.ffn_ln.bias, eps=eps)


class BertEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, pooler: bool = True):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.word_embeddings = param(cfg.vocab_size, h)
        self.position_embeddings = param(cfg.max_position_embeddings, h)
        self.token_type_embeddings = param(cfg.type_vocab_size, h)
        self.embeddings_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        # HF pooler weights ride along in checkpoints; the pooled path never
        # uses them
        self.pooler = Dense(h, h) if pooler else None

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                kernels: bool = False, int8: bool = False):
        """ids/mask [B, L] -> last hidden state [B, L, H]."""
        b, l = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(l, device=input_ids.device)
        emb = F.embedding(input_ids, self.word_embeddings)
        emb = emb + F.embedding(pos, self.position_embeddings)[None]
        emb = emb + F.embedding(token_type_ids, self.token_type_embeddings)
        x = self.embeddings_ln(emb).reshape(b * l, -1)
        kmask = ((1.0 - attention_mask.to(torch.float32)) * NEG_INF).reshape(b * l)
        for layer in self.layers:
            x = layer(x, kmask, l, kernels, int8)
        return x.reshape(b, l, -1)


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, pooler: bool = True):
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg, pooler)
        self.proj = Dense(cfg.hidden_size, cfg.d_txt)
        self.classifier = (Dense(cfg.d_txt, cfg.n_disease)
                           if cfg.use_warmup_classifier else None)

    def quantize_int8_(self) -> "TextEncoder":
        """Quantize every layer's projections for ``int8=True`` (once, from
        the weights in their current dtype and device)."""
        for layer in self.bert.layers:
            layer.quantize_int8_()
        return self

    def encode(self, input_ids, attention_mask, token_type_ids=None,
               kernels: bool = False, int8: bool = False):
        """-> embeddings [B, d_txt]."""
        hidden = self.bert(input_ids, attention_mask, token_type_ids, kernels, int8)
        return self.proj(masked_mean_pool(hidden, attention_mask))
