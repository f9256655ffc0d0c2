"""BERT-base text tower: embeddings, post-LN encoder layers, masked mean pool,
projection.

Port of ``mmdx_tpu/models/bert.py`` (``BertEncoder``, ``TextEncoder``). Each
layer's attention is routed by the sequence length L, as ``BertLayer``
routes it (``:66-120``):

* ``L <= 128`` (``fused_attn_max_seq_len``, also the kernel's limit): the
  fused attention block (ops/bert_attn.py, K1; K7 in its W8A8 form);
* ``L >= flash_min_seq_len`` (256) with ``use_flash_attention`` on (the
  engine turns it on in fast and turbo mode, as the JAX engine does): the
  q/k/v projections, blockwise attention (ops/flash_attention.py, row 9),
  the out-projection, residual and LayerNorm;
* otherwise: the same projections around ``attention_einsum``, the plain
  ops of the JAX package's XLA path (f32 scores over sqrt(d), the bias, an
  f32 softmax, probabilities in the model dtype, an f32 context).

The FFN is the fused FFN block (ops/fused_ffn.py, K2; K6 in W8A8) at every
L, as ``_ffn`` (``:135-150``). With ``kernels=True`` the block, flash and FFN
routes go through the hand-written kernels; otherwise through their plain
versions. LayerNorm eps 1e-12, exact-erf GELU, additive -1e9 key mask.

``int8=True`` (``int8_matmuls`` in the JAX config, the turbo tier) runs the
fused blocks in their W8A8 form (K7, K6: per-row activation scales,
per-column weight scales, tanh-GELU) from weights quantized once by
``TextEncoder.quantize_int8_`` from the weights as cast to the model dtype
(the JAX blocks quantize ``w.astype(self.dtype)`` at every call, ``bert.py:81-82,
145-146``: the same numbers). Beyond the fused block's length the attention
runs the bf16 projections and the FFN stays W8A8, as in the JAX route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import TextEncoderConfig
from mmdx_tpu_torch.models.layers import Dense, LayerNorm, param
from mmdx_tpu_torch.ops import bert_attn, flash_attention, fused_ffn
from mmdx_tpu_torch.ops.pooling import masked_mean_pool

NEG_INF = -1e9
F32 = torch.float32


def attention_einsum(q, k, v, bias) -> torch.Tensor:
    """The JAX package's XLA attention (``bert.py:113-120``): q/k/v [B, heads,
    L, d] in the model dtype, bias [B, 1, 1, L] f32 -> f32 context [B, heads,
    L, d]. Plain ops, as XLA computes this path outside any Pallas kernel."""
    d = q.shape[-1]
    s = (q.to(F32) @ k.to(F32).transpose(-1, -2)) / torch.tensor(
        float(d), dtype=F32, device=q.device).sqrt()
    p = torch.softmax(s + bias, dim=-1).to(q.dtype)
    return p.to(F32) @ v.to(F32)


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
        """Per-column int8 forms of the four projection weights (W8A8), laid
        out K-major ([out, in]) once, as the int8 GEMM reads them."""
        self.int8 = {k: fused_ffn.quant_weight_cols(getattr(self, k).kernel)
                     for k in ("attn_qkv", "attn_out", "ffn_in", "ffn_out")}

    def attention_route(self, seq_len: int) -> str:
        """"block" (the fused attention block), "flash" or "einsum"."""
        cfg = self.cfg
        if seq_len <= min(cfg.fused_attn_max_seq_len, bert_attn.MAX_SEQ_LEN):
            return "block"
        if cfg.use_flash_attention and seq_len >= cfg.flash_min_seq_len:
            return "flash"
        return "einsum"

    def _attention_unfused(self, x, kmask, seq_len: int, ctx_fn):
        """The projections, ``ctx_fn(q, k, v, bias)`` over [B, heads, L, d]
        views of the merged q|k|v rows, the out-projection, residual and
        LayerNorm, in the model dtype as flax's Dense and LayerNorm."""
        h, heads = self.cfg.hidden_size, self.cfg.num_heads
        b = x.shape[0] // seq_len
        qkv = self.attn_qkv(x)

        def split(t):  # [B*L, H] -> [B, heads, L, d], a view
            return t.reshape(b, seq_len, heads, h // heads).permute(0, 2, 1, 3)

        q, k, v = (split(t) for t in qkv.split(h, dim=1))
        ctx = ctx_fn(q, k, v, kmask.reshape(b, 1, 1, seq_len))
        ctx = ctx.permute(0, 2, 1, 3).reshape(b * seq_len, h).to(x.dtype)
        return self.attn_ln(x + self.attn_out(ctx))

    def forward(self, x, kmask, seq_len: int, kernels: bool, int8: bool = False):
        """x [B*L, H]; kmask [B*L] f32 additive -> [B*L, H]."""
        eps, heads = self.cfg.layer_norm_eps, self.cfg.num_heads
        route = self.attention_route(seq_len)
        if route == "block" and int8:
            q = self.int8
            x = bert_attn.fused_attention_block_int8(
                x, kmask, *q["attn_qkv"], self.attn_qkv.bias, *q["attn_out"],
                self.attn_out.bias, self.attn_ln.scale, self.attn_ln.bias,
                seq_len=seq_len, num_heads=heads, eps=eps)
        elif route == "block":
            attn = (bert_attn.fused_attention_block if kernels
                    else bert_attn.fused_attention_block_plain)
            x = attn(x, kmask, self.attn_qkv.kernel, self.attn_qkv.bias,
                     self.attn_out.kernel, self.attn_out.bias, self.attn_ln.scale,
                     self.attn_ln.bias, seq_len=seq_len, num_heads=heads, eps=eps)
        elif route == "flash":
            flash = (flash_attention.flash_attention if kernels
                     else flash_attention.flash_attention_plain)
            scale = 1.0 / float(self.cfg.hidden_size // heads) ** 0.5
            x = self._attention_unfused(
                x, kmask, seq_len, lambda q, k, v, bias: flash(q, k, v, bias, scale))
        else:
            x = self._attention_unfused(x, kmask, seq_len, attention_einsum)
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

    def classify(self, z):
        """Embeddings -> the warm-up classifier's probabilities [B, n_disease]
        f32: sigmoid of the f32 logits, as the JAX engine's single-modality
        path (``runtime/engine.py:527-558``)."""
        if self.classifier is None:
            raise ValueError("this tower has no warm-up classifier "
                             "(use_warmup_classifier is off)")
        return torch.sigmoid(self.classifier(z).to(torch.float32))
