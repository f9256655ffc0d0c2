"""Greedy report decoding (HF ``greedy_search`` semantics).

Port of ``mmdx_tpu/decode/greedy.py:greedy_decode`` (``:47-240``): eos is
masked while the report is shorter than ``min_new_tokens``, the no-repeat
n-gram followers are banned, a finished row pads, and the loop stops when
every row has finished or at ``max_new_tokens``. The loop runs on the host,
one step per iteration, with one host sync per step for the stopping rule.
The segmented cache growth of the JAX loop was a TPU layout fix and is not
ported; its producer-chunked logits are not either.

Two selection routes, as in the JAX body:

* f32 logits [B, V]: the masked dense ``argmax`` (``:153-164``);
* ``LazyLogits`` over a chunk-aligned vocabulary (``MMDX_FUSED_LM_HEAD=1``):
  ``ops/lm_head.lm_head_greedy`` gives the masked chunk max and earliest
  in-chunk argmax; the token is ``argmax(cmax) * 128 + carg[chunk]``, the
  dense argmax with its earliest-index tie order (``:86-102``).

``step_fn(tokens [B], pos) -> logits [B, V] | LazyLogits`` runs one decoder
step and writes its cache rows in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from mmdx_tpu_torch.decode.ngram import banned_ngram_mask
from mmdx_tpu_torch.ops import lm_head


def greedy_decode(step_fn: Callable, *, batch: int, vocab_size: int, device,
                  max_new_tokens: int = 180, min_new_tokens: int = 150,
                  no_repeat_ngram_size: int = 3, eos_token_id: int = 1,
                  pad_token_id: int = 0, decoder_start_token_id: int = 0):
    """-> sequences [B, 1+max_new_tokens] int64: the start token, the
    generated tokens (eos included if emitted), then pad."""
    b, v = batch, vocab_size
    lmax = 1 + max_new_tokens
    min_len = 1 + min_new_tokens
    seqs = torch.full((b, lmax), pad_token_id, dtype=torch.int64, device=device)
    seqs[:, 0] = decoder_start_token_id
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    cur = 1
    while cur < lmax and not bool(finished.all()):
        logits = step_fn(seqs[:, cur - 1], cur - 1)
        banned = (banned_ngram_mask(seqs, cur, v, no_repeat_ngram_size)
                  if no_repeat_ngram_size else None)
        banned = (torch.zeros((b, v), dtype=torch.bool, device=device) if banned is None
                  else banned.contiguous())
        if cur < min_len:
            banned[:, eos_token_id] = True
        if lm_head.fused_route(logits):
            cmax, carg = lm_head.lm_head_greedy(logits.hidden, logits.emb, banned)
            best = cmax.argmax(dim=-1)
            tok = best * lm_head.CHUNK + carg.gather(1, best[:, None])[:, 0].long()
        else:
            if isinstance(logits, lm_head.LazyLogits):
                logits = logits.materialize()
            tok = logits.to(torch.float32).masked_fill(banned, float("-inf")).argmax(dim=-1)
        tok = torch.where(finished, pad_token_id, tok)
        seqs[:, cur] = tok
        finished = finished | (tok == eos_token_id)
        cur += 1
    return seqs
