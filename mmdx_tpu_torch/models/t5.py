"""T5-small report decoder: the KV-cached beam decode step.

Port of the decode-step path of ``mmdx_tpu/models/t5.py``:
``relative_position_bucket`` / ``compute_position_bias`` (``:32-75``),
``RMSNorm`` (``:76``), ``T5Attention.step_beam`` (``:201-343``),
``T5DecoderLayer.step_beam`` (``:452-469``), ``T5.init_cache`` (``:584-633``),
``decode_self_bias`` (``:635-648``), ``decode_step_beam`` (``:679-741``) and
``_lm_logits_step``. The T5 encoder is not on the serving path (the decoder
is conditioned on synthetic tokens from the fusion head); its weights, when a
checkpoint has them, are carried but never run.

Beam decoding uses the ancestry cache: per layer one physical buffer
``[B, nb*Lmax, 2*h*d]``, position-major (row ``t*nb + j`` is slot j's token
t, k|v packed in the minor dim), never reordered; an additive ancestry mask
``[B, nb, nb*Lmax]`` resolves each beam's history. Cache rows are written in
place at ``pos``. Two routes:

* ``kernels=False`` (parity): write the step's k|v, then attend over the
  whole cache with the own column live (the JAX XLA path);
* ``kernels=True`` (fast): deferred writes — the beam-attention kernel
  (ops/beam_attn.py) reads the OLD cache with the own column masked, the
  step's own token is composed from the softmax partials here, and the
  cache write follows the read; the cross-attention + FFN half-step runs
  through ops/t5_step.py.

No segmented cache growth or 8-row alignment padding: those were TPU layout
fixes. Step logits stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import ReportDecoderConfig
from mmdx_tpu_torch.models.layers import Dense, param
from mmdx_tpu_torch.ops import beam_attn, t5_step

NEG_INF = -1e9
F32 = torch.float32


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int = 32, max_distance: int = 128):
    """HF T5 bucketing of (key_pos - query_pos)."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scale = torch.log(torch.tensor(max_distance / max_exact, dtype=F32))
    val_if_large = max_exact + (
        torch.log(n.to(F32) / max_exact + 1e-9) / scale * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_embedding: torch.Tensor, q_len: int, k_len: int,
                          bidirectional: bool, num_buckets: int, max_distance: int):
    """[1, heads, q_len, k_len] additive attention bias."""
    dev = rel_embedding.device
    ctx = torch.arange(q_len, device=dev)[:, None]
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                       max_distance)
    return rel_embedding[buckets].permute(2, 0, 1)[None]


class RMSNorm(nn.Module):
    """T5LayerNorm. Its scale stays f32 when the model is cast (keep_f32)."""

    keep_f32 = True

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param(d)

    def forward(self, x):
        return t5_step.rms_norm(x, self.scale, self.eps)


class RelativeBias(nn.Module):
    """Relative-attention bias table [num_buckets, heads], kept f32."""

    keep_f32 = True

    def __init__(self, num_buckets: int, heads: int):
        super().__init__()
        self.embedding = param(num_buckets, heads)


class T5Attention(nn.Module):
    def __init__(self, cfg: ReportDecoderConfig):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = Dense(cfg.d_model, inner, bias=False)
        self.k = Dense(cfg.d_model, inner, bias=False)
        self.v = Dense(cfg.d_model, inner, bias=False)
        self.o = Dense(inner, cfg.d_model, bias=False)

    def step_beam(self, y, cache_kv, pos: int, mask, bias_k, deferred: bool):
        """One-token self-attention over the physical cache.

        y [N, D]; cache_kv [B, nb*Lc, 2*h*d] (row pos*nb + j written here, in
        place); mask [B, nb, nb*Lc]; bias_k [h, nb*Lc] -> [N, D]."""
        b, nb, kk = mask.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv
        hd = h * d
        q = self.q(y).reshape(b, nb, hd)
        k_new = self.k(y).reshape(b, nb, hd)
        v_new = self.v(y).reshape(b, nb, hd)
        rows = slice(pos * nb, (pos + 1) * nb)
        if deferred:
            acc, m, l = beam_attn.beam_decode_attention_partial(q, cache_kv, mask,
                                                                bias_k)
            qh, kh, vh = (t.reshape(b, nb, h, d).to(F32) for t in (q, k_new, v_new))
            s_own = (qh * kh).sum(-1) + bias_k[:, pos * nb][None, None, :]
            m2 = torch.maximum(m, s_own)
            ea = torch.exp(m - m2)  # exactly 0 when the cache was fully masked
            eb = torch.exp(s_own - m2)
            num = acc.reshape(b, nb, h, d) * ea[..., None] + eb[..., None] * vh
            den = l * ea + eb
            ctx = (num / den[..., None]).reshape(b, nb, hd).to(y.dtype)
            # the write follows the read: only the next step consumes it
            cache_kv[:, rows] = torch.cat([k_new, v_new], dim=-1)
            return self.o(ctx.reshape(b * nb, hd))
        cache_kv[:, rows] = torch.cat([k_new, v_new], dim=-1)
        kh = cache_kv[..., :hd].reshape(b, kk, h, d)
        vh = cache_kv[..., hd:].reshape(b, kk, h, d)
        scores = torch.einsum("bihd,bkhd->bhik", q.reshape(b, nb, h, d).to(F32),
                              kh.to(F32))
        scores = scores + bias_k[None, :, None, :] + mask[:, None, :, :]
        probs = torch.softmax(scores, dim=-1).to(y.dtype)
        ctx = torch.einsum("bhik,bkhd->bihd", probs.to(F32), vh.to(F32)).to(y.dtype)
        return self.o(ctx.reshape(b * nb, hd))


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: ReportDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.self_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.self_attn = T5Attention(cfg)
        self.cross_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.cross_attn = T5Attention(cfg)
        self.ffn_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ffn_wi = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.ffn_wo = Dense(cfg.d_ff, cfg.d_model, bias=False)

    def step_beam(self, hidden, cache_kv, static_kv, pos: int, mask, bias_k,
                  enc_bias, kernels: bool):
        """hidden [N, D] -> [N, D]; cache_kv updated in place."""
        y = self.self_ln(hidden)
        hidden = hidden + self.self_attn.step_beam(y, cache_kv, pos, mask, bias_k,
                                                   deferred=kernels)
        block = t5_step.cross_ffn_block if kernels else t5_step.cross_ffn_block_plain
        return block(hidden, self.cross_ln.scale, self.cross_attn.q.kernel,
                     self.cross_attn.o.kernel, static_kv["ck2"], static_kv["cv2"],
                     enc_bias, self.ffn_ln.scale, self.ffn_wi.kernel,
                     self.ffn_wo.kernel, heads=self.cfg.num_heads,
                     eps=self.cfg.layer_norm_eps)


class T5EncoderLayer(nn.Module):
    """Encoder-layer weights (carried from checkpoints, not run)."""

    def __init__(self, cfg: ReportDecoderConfig):
        super().__init__()
        self.self_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.self_attn = T5Attention(cfg)
        self.ffn_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ffn_wi = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.ffn_wo = Dense(cfg.d_ff, cfg.d_model, bias=False)


class T5(nn.Module):
    def __init__(self, cfg: ReportDecoderConfig, encoder_layers: int = 0):
        super().__init__()
        self.cfg = cfg
        self.shared = param(cfg.vocab_size, cfg.d_model)
        self.decoder_rel_bias = RelativeBias(cfg.relative_attention_num_buckets,
                                             cfg.num_heads)
        self.decoder_layers = nn.ModuleList(
            T5DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))
        self.decoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else Dense(cfg.d_model, cfg.vocab_size, bias=False))
        self.encoder_layers = nn.ModuleList(
            T5EncoderLayer(cfg) for _ in range(encoder_layers))
        if encoder_layers:
            self.encoder_rel_bias = RelativeBias(cfg.relative_attention_num_buckets,
                                                 cfg.num_heads)
            self.encoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self._lm_f32 = None

    def init_cache(self, batch: int, max_len: int, cond, beam_width: int):
        """-> (cache: per layer [batch/nb, nb*max_len, 2*h*d] zeros,
        static_kv: per layer {"ck2", "cv2"} [batch, K, h*d] cross k/v)."""
        cfg = self.cfg
        shape = (batch // beam_width, beam_width * max_len, 2 * cfg.num_heads * cfg.d_kv)
        cache = [torch.zeros(shape, dtype=cond.dtype, device=cond.device)
                 for _ in self.decoder_layers]
        static_kv = [{"ck2": layer.cross_attn.k(cond).contiguous(),
                      "cv2": layer.cross_attn.v(cond).contiguous()}
                     for layer in self.decoder_layers]
        return cache, static_kv

    def decode_self_bias(self, max_len: int):
        """Causal relative bias [1, heads, max_len, max_len] f32."""
        cfg = self.cfg
        bias = compute_position_bias(
            self.decoder_rel_bias.embedding.to(F32), max_len, max_len,
            bidirectional=False, num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)
        causal = torch.tril(torch.ones(max_len, max_len, device=bias.device))
        return bias + (1.0 - causal)[None, None] * NEG_INF

    def _lm_weight_f32(self):
        """The tied embedding as f32 for f32 step logits (cached copy when the
        model runs in bf16: the products are then those of bf16 operands)."""
        if self.shared.dtype == F32:
            return self.shared
        if self._lm_f32 is None or self._lm_f32.device != self.shared.device:
            self._lm_f32 = self.shared.to(F32)
        return self._lm_f32

    def lm_logits_step(self, hidden):
        """[N, D] -> f32 logits [N, V]."""
        cfg = self.cfg
        if cfg.tie_word_embeddings:
            h = hidden * (cfg.d_model ** -0.5)
            return h.to(F32) @ self._lm_weight_f32().t()
        return self.lm_head(hidden).to(F32)

    def decode_step_beam(self, token_ids, pos: int, cache, anc, static_kv,
                         self_bias_full, encoder_mask, kernels: bool = False):
        """token_ids [N] at position ``pos`` -> f32 logits [N, V]; ``cache``
        (per-layer physical buffers) is updated in place. ``anc [B, nb, Lmax]``
        maps each beam's history position to the physical slot that wrote it."""
        b, nb, _ = anc.shape
        cap = cache[0].shape[1] // nb
        dev = anc.device
        hidden = F.embedding(token_ids.reshape(-1), self.shared)
        bias_row = self_bias_full[0, :, pos, :cap]  # [h, cap]
        enc_bias = (1.0 - encoder_mask.to(F32)) * NEG_INF  # [N, K]
        # own column: live in the cache read (parity) or dead, composed from
        # the partials (deferred, kernels=True)
        own = (torch.full((nb,), -1, dtype=anc.dtype, device=dev) if kernels
               else torch.arange(nb, dtype=anc.dtype, device=dev))
        col = torch.arange(cap, device=dev)
        anc_eff = torch.where(col[None, None, :] == pos, own[None, :, None],
                              anc[:, :, :cap])
        live = anc_eff[..., None] == torch.arange(nb, dtype=anc.dtype, device=dev)
        mask = torch.where(live.reshape(b, nb, cap * nb), 0.0, NEG_INF).to(F32)
        bias_k = bias_row.repeat_interleave(nb, dim=-1).contiguous()  # [h, cap*nb]
        for layer, layer_cache, layer_static in zip(self.decoder_layers, cache,
                                                    static_kv):
            hidden = layer.step_beam(hidden, layer_cache, layer_static, pos, mask,
                                     bias_k, enc_bias, kernels)
        return self.lm_logits_step(self.decoder_final_ln(hidden))
