"""T5-small report decoder: the KV-cached decode step (beam and greedy).

Port of the decode-step path of ``mmdx_tpu/models/t5.py``:
``relative_position_bucket`` / ``compute_position_bias`` (``:32-75``),
``RMSNorm`` (``:76``), ``T5Attention.step_beam`` (``:201-343``, with the
int8 cache's quantize-on-write ``:240-259``),
``T5DecoderLayer.step_beam`` (``:452-469``), ``T5.init_cache`` (``:584-633``),
``decode_self_bias`` (``:635-648``), ``decode_step_beam`` (``:679-741``) and
``_lm_logits_step``. The T5 encoder is not on the serving path (the decoder
is conditioned on synthetic tokens from the fusion head); its weights, when a
checkpoint has them, are carried but never run.

Beam decoding uses the ancestry cache: per layer one physical buffer
``[B, nb*Lmax, 2*h*d]``, position-major (row ``t*nb + j`` is slot j's token
t, k|v packed in the minor dim), never reordered; an additive ancestry mask
``[B, nb, nb*Lmax]`` resolves each beam's history. Cache rows are written in
place at ``pos``. Routes:

* ``kernels=False`` (parity): write the step's k|v, then attend over the
  whole cache with the own column live (the JAX XLA path);
* ``kernels=True`` (fast), deferred writes (beam, bf16 cache, the default):
  the partials kernel (ops/beam_attn.py) reads the OLD cache with the own
  column masked, the step's own token is composed from the softmax partials
  here, and the cache write follows the read;
* ``kernels=True`` otherwise (greedy, ``MMDX_DEFER_KV=0``, the int8 cache):
  write, then the normalised read kernel over the written cache, bf16 or
  int8 (``kv_int8``: rows quantized on write with per-(row, head) scales).

In fast mode the cross-attention + FFN half-step runs through ops/t5_step.py.
With ``lazy_logits`` the step returns ``LazyLogits`` and the selection runs
the tied head through ops/lm_head.py.

Greedy runs over the same flat cache at nb = 1 with an all-zero ancestry
(the JAX engine's ``flat_greedy`` layout, token-identical to its heads-major
one, ``tests/test_kv_int8.py:200-219``). The heads-major ``decode_step`` /
``T5Attention.step`` / ``attend`` cache was a TPU layout choice and is not
ported. No segmented cache growth or 8-row alignment padding: those were TPU
layout fixes. Step logits stay f32.

Training runs the teacher-forced ``T5.decode`` (``t5.py:557-582``): the
whole-sequence decoder with the causal relative position bias, cross
attention over the conditioning tokens, and the tied lm head over the full
vocabulary, in plain differentiable ops (``T5Attention.forward``,
``T5DecoderLayer.forward``), on the same parameters as the decode step.
``shift_right`` is ``t5.py:747``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdx_tpu_torch.config import ReportDecoderConfig
from mmdx_tpu_torch.models.layers import Dense, matmul_f32, param
from mmdx_tpu_torch.ops import beam_attn, t5_step
from mmdx_tpu_torch.ops.lm_head import LazyLogits

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


def shift_right(labels: torch.Tensor, decoder_start_token_id: int = 0,
                pad_id: int = 0) -> torch.Tensor:
    """HF _shift_right: prepend the start token, drop the last, -100 -> pad."""
    start = torch.full((labels.shape[0], 1), decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


class T5Attention(nn.Module):
    def __init__(self, cfg: ReportDecoderConfig):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = Dense(cfg.d_model, inner, bias=False, unit=cfg.d_kv)
        self.k = Dense(cfg.d_model, inner, bias=False, unit=cfg.d_kv)
        self.v = Dense(cfg.d_model, inner, bias=False, unit=cfg.d_kv)
        self.o = Dense(inner, cfg.d_model, bias=False, unit=cfg.d_kv)

    @property
    def heads(self) -> int:
        """The heads this rank holds: all of them, or its share once
        ``parallel.sharding.shard_model_`` has split the attention."""
        return self.o.kernel.shape[0] // self.cfg.d_kv

    @property
    def head_slice(self) -> slice:
        """This rank's rows of a whole-heads bias."""
        first = self.o.tp[1].rank * self.heads if self.o.tp else 0
        return slice(first, first + self.heads)

    def forward(self, hidden, kv_hidden, bias):
        """Whole-sequence attention (``T5Attention.__call__``): hidden [B, Lq,
        D], kv_hidden [B, Lk, D], bias [*, h, Lq, Lk] additive f32; f32
        scores (no scaling), f32 softmax, probabilities and context in the
        model dtype. Sharded, the rank's heads and their rows of ``bias``."""
        h, d = self.heads, self.cfg.d_kv
        b, lq, _ = hidden.shape
        if bias.shape[-3] != 1 and self.o.tp:
            from mmdx_tpu_torch.parallel.sharding import copy_to_model

            # the whole-heads bias is replicated: its gradient sums every
            # rank's heads
            bias = copy_to_model(bias, self.o.tp[1])[..., self.head_slice, :, :]

        def split(t):
            return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

        q, k, v = split(self.q(hidden)), split(self.k(kv_hidden)), split(self.v(kv_hidden))
        scores = matmul_f32(q, k.transpose(-1, -2)) + bias
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        ctx = matmul_f32(probs, v).to(q.dtype)
        return self.o(ctx.transpose(1, 2).reshape(b, lq, h * d))

    def step_beam(self, y, cache: dict, pos: int, mask, bias_k, kernels: bool,
                  deferred: bool):
        """One-token self-attention over the physical cache.

        y [N, D]; cache {"kv": [B, nb*Lc, 2*h*d]} bf16, or int8 with
        {"kvs": [B, 2h, nb*Lc]} f32 scales (row pos*nb + j written here, in
        place); mask [B, nb, nb*Lc]; bias_k [h, nb*Lc] -> [N, D]."""
        b, nb, _ = mask.shape
        h, d = self.heads, self.cfg.d_kv
        hd = h * d
        bias_k = bias_k[self.head_slice]
        q = self.q(y).reshape(b, nb, hd)
        k_new = self.k(y).reshape(b, nb, hd)
        v_new = self.v(y).reshape(b, nb, hd)
        rows = slice(pos * nb, (pos + 1) * nb)
        cache_kv = cache["kv"]
        if "kvs" in cache:  # int8 cache: quantize on write, then the int8 read
            cache_kv[:, rows], cache["kvs"][:, :, rows] = beam_attn.quantize_kv_rows(
                k_new, v_new, h)
            read = (beam_attn.beam_decode_attention_int8 if kernels
                    else beam_attn.beam_decode_attention_int8_plain)
            ctx = read(q, cache_kv, cache["kvs"], mask, bias_k)
            return self.o(ctx.reshape(b * nb, hd))
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
        read = (beam_attn.beam_decode_attention if kernels
                else beam_attn.beam_decode_attention_plain)
        return self.o(read(q, cache_kv, mask, bias_k).reshape(b * nb, hd))


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

    def forward(self, hidden, self_bias, enc_hidden, enc_bias):
        """Teacher-forced layer (``T5DecoderLayer.__call__``): [B, L, D] ->
        [B, L, D]."""
        y = self.self_ln(hidden)
        hidden = hidden + self.self_attn(y, y, self_bias)
        y = self.cross_ln(hidden)
        hidden = hidden + self.cross_attn(y, enc_hidden, enc_bias)
        y = self.ffn_ln(hidden)
        return hidden + self.ffn_wo(F.relu(self.ffn_wi(y)))

    def step_beam(self, hidden, cache, static_kv, pos: int, mask, bias_k,
                  enc_bias, kernels: bool, deferred: bool):
        """hidden [N, D] -> [N, D]; the cache updated in place."""
        y = self.self_ln(hidden)
        hidden = hidden + self.self_attn.step_beam(y, cache, pos, mask, bias_k,
                                                   kernels, deferred)
        args = (hidden, self.cross_ln.scale, self.cross_attn.q.kernel,
                self.cross_attn.o.kernel, static_kv["ck2"], static_kv["cv2"],
                enc_bias, self.ffn_ln.scale, self.ffn_wi.kernel, self.ffn_wo.kernel)
        if self.cross_attn.o.tp or self.ffn_wo.tp:  # sharded: parity mode only
            return t5_step.cross_ffn_block_plain(
                *args, heads=self.cross_attn.heads, eps=self.cfg.layer_norm_eps,
                attn_group=self.cross_attn.o.group, ffn_group=self.ffn_wo.group)
        block = t5_step.cross_ffn_block if kernels else t5_step.cross_ffn_block_plain
        return block(*args, heads=self.cfg.num_heads, eps=self.cfg.layer_norm_eps)


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

    def init_cache(self, batch: int, max_len: int, cond, beam_width: int,
                   kv_int8: bool = False):
        """-> (cache: per layer {"kv": [batch/nb, nb*max_len, 2*h*d] zeros},
        in cond's dtype, or int8 with {"kvs": [batch/nb, 2h, nb*max_len]} f32
        scales when ``kv_int8`` (``t5.py:609-617``); static_kv: per layer
        {"ck2", "cv2"} [batch, K, h*d] cross k/v)."""
        cfg = self.cfg
        heads = self.decoder_layers[0].self_attn.heads if len(self.decoder_layers) \
            else cfg.num_heads  # the rank's heads
        shape = (batch // beam_width, beam_width * max_len, 2 * heads * cfg.d_kv)
        dev = cond.device
        if kv_int8:
            cache = [{"kv": torch.zeros(shape, dtype=torch.int8, device=dev),
                      "kvs": torch.zeros((shape[0], 2 * heads, shape[1]),
                                         dtype=F32, device=dev)}
                     for _ in self.decoder_layers]
        else:
            cache = [{"kv": torch.zeros(shape, dtype=cond.dtype, device=dev)}
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

    def decode(self, decoder_input_ids, encoder_hidden, encoder_mask):
        """Teacher-forced decode -> f32 logits [B, L, vocab] (``T5.decode``):
        causal self-attention over the whole length with the relative bias,
        cross-attention over ``encoder_hidden`` [B, K, D] under
        ``encoder_mask`` [B, K]."""
        cfg = self.cfg
        hidden = F.embedding(decoder_input_ids, self.shared)
        self_bias = self.decode_self_bias(decoder_input_ids.shape[1])
        enc_bias = (1.0 - encoder_mask[:, None, None, :].to(F32)) * NEG_INF
        for layer in self.decoder_layers:
            hidden = layer(hidden, self_bias, encoder_hidden, enc_bias)
        hidden = self.decoder_final_ln(hidden)
        if cfg.tie_word_embeddings:
            return matmul_f32(hidden * (cfg.d_model ** -0.5), self.shared.t())
        return self.lm_head(hidden).to(F32)

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
                         self_bias_full, encoder_mask, kernels: bool = False,
                         defer: bool = True, lazy_logits: bool = False):
        """token_ids [N] at position ``pos`` -> f32 logits [N, V], or a
        ``LazyLogits`` when ``lazy_logits`` (tied embeddings only); ``cache``
        (per-layer physical buffers) is updated in place. ``anc [B, nb, Lmax]``
        maps each beam's history position to the physical slot that wrote it
        (greedy: nb = 1, all zeros).

        With ``kernels`` the reads run the hand-written kernels: the deferred
        partials when ``defer``, nb >= 2 and the cache is bf16
        (``t5.py:710-712``), else the normalised read, bf16 or int8."""
        b, nb, _ = anc.shape
        cap = cache[0]["kv"].shape[1] // nb
        dev = anc.device
        deferred = kernels and defer and nb >= 2 and "kvs" not in cache[0]
        hidden = F.embedding(token_ids.reshape(-1), self.shared)
        bias_row = self_bias_full[0, :, pos, :cap]  # [h, cap]
        enc_bias = (1.0 - encoder_mask.to(F32)) * NEG_INF  # [N, K]
        # own column: live in the cache read, or dead and composed from the
        # partials (deferred)
        own = (torch.full((nb,), -1, dtype=anc.dtype, device=dev) if deferred
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
                                     bias_k, enc_bias, kernels, deferred)
        hidden = self.decoder_final_ln(hidden)
        if lazy_logits and self.cfg.tie_word_embeddings:
            # the selection runs the head itself (ops/lm_head.py)
            return LazyLogits(hidden * (self.cfg.d_model ** -0.5), self.shared)
        return self.lm_logits_step(hidden)
