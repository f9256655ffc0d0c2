"""HF-parity beam search over the ancestry (never reordered) KV cache.

Port of ``mmdx_tpu/decode/beam_search.py``: ``beam_search`` (``:355``) with
``cache_mode="ancestry"``, the streamed-lm-head route of the candidate top-k
(``fused_candidate_topk``, ``:165-195``), ``beam_expand`` (``:626``) and
``make_generation_kwargs`` (``:631``). The rules are the tensorized beam
search of transformers >= 4.50:

* min-new-tokens eos masking and no-repeat-ngram bans on the log-probs;
* 2*num_beams candidates per step; only the top num_beams may finalize;
* a candidate finalizes when it emits eos or reaches max length, scored
  ``sum_logprobs / num_generated**length_penalty``;
* a fixed-capacity hypothesis buffer (fill a free slot, else replace the
  worst if better);
* the sticky early-stop heuristic on the best running beam;
* HF's output fill value (``pad_token_id or eos_token_id``).

The loop runs on the host, one step per iteration, with a host sync per step
for the stopping rule. The TPU workarounds of the JAX version are not ported:
candidates come from ``torch.topk`` over f32 log-probs (ties ordered by
index, ``topk``), rows move with ``gather``, the cache is one full-length
buffer.

``step_fn(tokens [N], pos, anc [B, nb, Lmax]) -> f32 logits [N, V]`` (or
``LazyLogits``, with the fused lm head) runs one decoder step and writes its
cache rows in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from mmdx_tpu_torch.config import GenerationConfig
from mmdx_tpu_torch.decode.ngram import banned_ngram_mask
from mmdx_tpu_torch.ops import lm_head

NEG = -1e9
F32 = torch.float32


def topk(x, k: int):
    """Top-k of each row of ``x`` [R, W], sorted, equal values in ascending
    index order (``lax.top_k``'s and ``topk_small``'s rule, which
    ``torch.topk`` does not promise). Exact: when the k+1 largest values are
    all distinct, the top k and their order are unique; otherwise a stable
    sort of the rows orders them."""
    vals, idx = torch.topk(x, min(k + 1, x.shape[1]), dim=1)
    if bool((vals[:, 1:] == vals[:, :-1]).any()):
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def candidate_topk(logits, beam_scores, banned, mask_eos: bool, eos_token_id: int,
                   k: int, b: int, nb: int):
    """Top-k of ``log_softmax(logits) + beam_scores`` over each sample's
    nb*V candidates, with the eos column masked while below min length and
    the banned n-gram followers masked. The f32 op order is the JAX chain's:
    ``((masked - max) - logsumexp) + beam_score``.
    Returns (scores [B, k], flat index [B, k] into nb*V).

    ``LazyLogits`` over a chunk-aligned vocabulary take the streamed route
    (``lazy_candidate_topk``); others are materialized."""
    if lm_head.fused_route(logits):
        return lazy_candidate_topk(logits, beam_scores, banned, mask_eos,
                                   eos_token_id, k, b, nb)
    if isinstance(logits, lm_head.LazyLogits):
        logits = logits.materialize()
    n, v = logits.shape
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    a = logits
    if mask_eos:
        a = a.clone()
        a[:, eos_token_id] = float("-inf")
    if banned is not None:
        a = a.masked_fill(banned, float("-inf"))
    adjusted = ((a - m) - lse) + beam_scores.reshape(n, 1)
    return topk(adjusted.reshape(b, nb * v), k)


def lazy_candidate_topk(logits, beam_scores, banned, mask_eos: bool, eos_token_id: int,
                        k: int, b: int, nb: int):
    """``candidate_topk`` through the streamed lm head (port of
    ``fused_candidate_topk:165-195``): ``lm_head_stats`` gives the logits, m
    and L over the raw logits and the masked chunk max; the chunk scores
    ``((cmax - m) - L) + s`` pick the top k chunks of each sample, and the
    same chain redone on those chunks' masked logits gives the top k. Any
    top-k candidate lies in a chunk whose max is at least its score, so the
    selection is the dense route's."""
    n, v = logits.shape
    c, ch = v // lm_head.CHUNK, lm_head.CHUNK
    mask = (torch.zeros((n, v), dtype=torch.bool, device=beam_scores.device)
            if banned is None else banned.clone(memory_format=torch.contiguous_format))
    if mask_eos:
        mask[:, eos_token_id] = True
    logits_p, m, lse, cmax_p = lm_head.lm_head_stats(logits.hidden, logits.emb, mask)
    s_row = beam_scores.reshape(n)
    cmax = ((cmax_p - m[:, None]) - lse[:, None]) + s_row[:, None]
    cidx = topk(cmax.reshape(b, nb * c), k)[1].sort(dim=1).values
    rows = torch.arange(b, device=cidx.device)[:, None] * nb + cidx // c  # [B, k]
    lin = rows * c + cidx % c
    gl = logits_p.reshape(n * c, ch)[lin]  # [B, k, 128]
    adj = gl.masked_fill(mask.reshape(n * c, ch)[lin], float("-inf"))
    adj = ((adj - m[rows][..., None]) - lse[rows][..., None]) + s_row[rows][..., None]
    vals, gi = topk(adj.reshape(b, k * ch), k)
    sel = cidx.gather(1, gi // ch)
    return vals, (sel // c) * v + (sel % c) * ch + gi % ch


def gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x[b, src[b, i], :]: x [B, nb, L], src [B, k] -> [B, k, L]."""
    return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[-1]))


def _insert_hyp(fin_seqs, fin_scores, fin_lens, n_fin, seq, score, length, do_insert):
    """Insert one hypothesis per batch row into the fixed-capacity buffer
    (HF's merge: fill a free slot, else replace the worst when better)."""
    nb = fin_scores.shape[-1]
    worst = fin_scores.argmin(dim=-1)
    full = n_fin >= nb
    better = score > fin_scores.gather(1, worst[:, None])[:, 0]
    slot = torch.where(full, worst, n_fin.clamp(max=nb - 1))
    do = do_insert & (~full | better)
    onehot = (torch.arange(nb, device=slot.device) == slot[:, None]) & do[:, None]
    fin_scores = torch.where(onehot, score[:, None], fin_scores)
    fin_lens = torch.where(onehot, length[:, None], fin_lens)
    fin_seqs = torch.where(onehot[..., None], seq[:, None, :], fin_seqs)
    n_fin = n_fin + (do & ~full).to(n_fin.dtype)
    return fin_seqs, fin_scores, fin_lens, n_fin


def beam_search(step_fn: Callable, *, batch: int, vocab_size: int, device,
                num_beams: int = 4, max_new_tokens: int = 180,
                min_new_tokens: int = 150, no_repeat_ngram_size: int = 3,
                length_penalty: float = 1.1, early_stopping: bool | str = True,
                eos_token_id: int = 1, pad_token_id: int = 0,
                decoder_start_token_id: int = 0):
    """-> (sequences [B, 1+max_new_tokens] int64, scores [B] f32): the start
    token, the generated tokens (eos included if emitted), then the fill
    value."""
    b, nb, v = batch, num_beams, vocab_size
    lmax = 1 + max_new_tokens
    min_len = 1 + min_new_tokens
    n = b * nb
    es_true = early_stopping is True
    fill = pad_token_id if pad_token_id else eos_token_id  # HF quirk
    i64 = torch.int64

    def full(shape, value, dtype=i64):
        return torch.full(shape, value, dtype=dtype, device=device)

    seqs = full((b, nb, lmax), fill)
    seqs[:, :, 0] = decoder_start_token_id
    beam_scores = full((b, nb), 0.0, F32)
    beam_scores[:, 1:] = NEG
    anc = full((b, nb, lmax), 0)
    fin_seqs = full((b, nb, lmax), fill)
    fin_scores = full((b, nb), NEG, F32)
    fin_lens = full((b, nb), 1)
    n_fin = full((b,), 0)
    heuristic_ok = full((b,), True, torch.bool)
    beam_idx = torch.arange(nb, device=device)
    pos_lane = torch.arange(lmax, device=device)
    ranks = torch.arange(1, nb + 1, device=device)

    cur = 1
    while cur < lmax:
        batch_full = n_fin >= nb
        if not bool(heuristic_ok.any()) or (es_true and bool(batch_full.all())):
            break
        frozen = (batch_full & es_true) | ~heuristic_ok
        logits = step_fn(seqs[:, :, cur - 1].reshape(n), cur - 1, anc)
        banned = (banned_ngram_mask(seqs.reshape(n, lmax), cur, v, no_repeat_ngram_size)
                  if no_repeat_ngram_size else None)
        top_scores, top_idx = candidate_topk(logits, beam_scores, banned,
                                             cur < min_len, eos_token_id, 2 * nb, b, nb)
        src_beam = top_idx // v
        token = top_idx % v
        hits = (token == eos_token_id) | (cur + 1 >= lmax)

        # continuing beams: the top nb non-finishing candidates in rank order
        rank = torch.cumsum((~hits).to(i64), dim=1)
        pick = (rank[:, :, None] == ranks) & (~hits)[..., None]
        sel = pick.to(torch.int8).argmax(dim=1)  # [B, nb]
        new_scores = top_scores.gather(1, sel)
        new_tokens = token.gather(1, sel)
        new_src = src_beam.gather(1, sel)

        # finished hypotheses: finishing candidates among the top nb ranks
        if bool((hits[:, :nb] & ~frozen[:, None]).any()):
            pen = torch.tensor(float(cur), dtype=F32, device=device) ** length_penalty
            length = full((b,), cur + 1)
            for j in range(nb):
                hyp = gather_rows(seqs, src_beam[:, j:j + 1])[:, 0]
                hyp = torch.where(pos_lane == cur, token[:, j:j + 1], hyp)
                fin_seqs, fin_scores, fin_lens, n_fin = _insert_hyp(
                    fin_seqs, fin_scores, fin_lens, n_fin, hyp,
                    top_scores[:, j] / pen, length, hits[:, j] & ~frozen)

        # advance the running beams (frozen samples keep theirs)
        new_src_eff = torch.where(frozen[:, None], beam_idx, new_src)
        step_tok = torch.where(frozen[:, None], fill, new_tokens)
        seqs = torch.where(pos_lane == cur, step_tok[..., None],
                           gather_rows(seqs, new_src_eff))
        beam_scores = torch.where(frozen[:, None], beam_scores, new_scores)
        # position cur-1's k|v was written this step by slot new_src
        anc = torch.where(pos_lane == cur - 1, new_src_eff[..., None],
                          gather_rows(anc, new_src_eff))

        # sticky early-stop heuristic (HF _check_early_stop_heuristic)
        hyp_len = (float(lmax - 1) if early_stopping == "never" and length_penalty > 0
                   else float(cur))
        best_running = beam_scores[:, 0] / (
            torch.tensor(hyp_len, dtype=F32, device=device) ** length_penalty)
        worst_fin = torch.where(n_fin >= nb, fin_scores.amin(dim=1),
                                torch.tensor(NEG, dtype=F32, device=device))
        heuristic_ok = heuristic_ok & ((n_fin < nb) | (best_running > worst_fin))
        cur += 1

    best = fin_scores.argmax(dim=1)
    rows = torch.arange(b, device=device)
    best_seq, best_len = fin_seqs[rows, best], fin_lens[rows, best]
    out = torch.where(pos_lane[None, :] >= best_len[:, None], fill, best_seq)
    return out, fin_scores[rows, best]


def beam_expand(x: torch.Tensor, num_beams: int) -> torch.Tensor:
    """[B, ...] -> [B*nb, ...], each sample repeated for its beams."""
    return x.repeat_interleave(num_beams, dim=0)


def make_generation_kwargs(cfg: GenerationConfig) -> dict:
    return dict(
        num_beams=cfg.num_beams,
        max_new_tokens=cfg.max_new_tokens,
        min_new_tokens=cfg.min_new_tokens,
        no_repeat_ngram_size=cfg.no_repeat_ngram_size,
        length_penalty=cfg.length_penalty,
        early_stopping=cfg.early_stopping,
        eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id,
        decoder_start_token_id=cfg.decoder_start_token_id,
    )
