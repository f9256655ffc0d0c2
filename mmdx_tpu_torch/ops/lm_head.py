"""Streamed tied lm head with the decode step's selection statistics.

Port of ``mmdx_tpu/ops/pallas_lm_head.py``: ``CHUNK``, ``LazyLogits``,
``lm_head_greedy`` (``:135``) and ``lm_head_stats`` (``:181``). With the fused
lm head on (``MMDX_FUSED_LM_HEAD=1``) the decode step returns
``LazyLogits(hidden * d_model**-0.5, shared)`` in place of its f32 logits,
and the selection runs the product itself:

* greedy (``decode/greedy.py``): ``lm_head_greedy`` gives the masked max of
  each 128-column chunk and the earliest offset attaining it; the token is
  ``argmax(cmax) * 128 + carg[that chunk]``, the dense argmax with its
  earliest-index tie order, and no [N, V] logits exist;
* beam (``decode/beam_search.candidate_topk``): ``lm_head_stats`` gives the
  logits, their row max m and L = log sum exp(x - m) over the RAW logits,
  and the chunk max over the MASKED logits, so the candidate top-k reads a
  few chunks instead of re-reading the [N, V] f32 logits.

Kernel (CUDA C++, ``csrc/lm_head.cu``): one block per vocab chunk holds its
128 emb rows in shared memory and walks the rows of ``hidden`` through the
tensor cores, so emb is read once per call; the stats write per-chunk
partials that a second launch merges into m and L (blocks run in no order,
unlike the TPU kernel's sequential vocab grid). What bounds it on the H100:
the 32.9 MB emb read at the T5 vocabulary, ~10 us.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mmdx_tpu_torch import _build

CHUNK = 128
F32 = torch.float32


class LazyLogits(NamedTuple):
    """The deferred tied lm head: logits = hidden @ emb.T in f32, the
    d_model**-0.5 head scale already in ``hidden``."""

    hidden: torch.Tensor  # [N, D]
    emb: torch.Tensor  # [V, D]

    @property
    def shape(self):
        return (self.hidden.shape[0], self.emb.shape[0])

    def materialize(self) -> torch.Tensor:
        return self.hidden.to(F32) @ self.emb.to(F32).t()


def fused_route(logits) -> bool:
    """Whether the selection can take the streamed route: a LazyLogits over
    a chunk-aligned vocabulary of at least two chunks (``pallas_lm_head``'s
    callers gate the same way); otherwise they materialize."""
    v = logits.shape[1]
    return isinstance(logits, LazyLogits) and v % CHUNK == 0 and v >= 2 * CHUNK


def _chunk_argmax(masked):
    """[N, V] -> (chunk max [N, C], earliest offset attaining it [N, C])."""
    n, v = masked.shape
    m3 = masked.reshape(n, v // CHUNK, CHUNK)
    cmax = m3.amax(-1)
    off = torch.arange(CHUNK, device=masked.device)
    carg = torch.where(m3 == cmax[..., None], off, CHUNK).amin(-1)
    return cmax, carg.clamp(max=CHUNK - 1).to(torch.int32)


def lm_head_greedy_plain(hidden, emb, mask):
    """Plain PyTorch version: the f32 product of the working-dtype operands
    (as ``T5.lm_logits_step``), masked to -inf where ``mask``, per-chunk max
    and earliest argmax."""
    logits = LazyLogits(hidden, emb).materialize()
    return _chunk_argmax(logits.masked_fill(mask, float("-inf")))


def lm_head_stats_plain(hidden, emb, mask):
    """Plain PyTorch version: logits, the raw row max m, L = log sum
    exp(logits - m) (the dense beam chain's arithmetic), masked chunk max."""
    logits = LazyLogits(hidden, emb).materialize()
    m = logits.amax(-1)
    lse = torch.log(torch.exp(logits - m[:, None]).sum(-1))
    cmax, _ = _chunk_argmax(logits.masked_fill(mask, float("-inf")))
    return logits, m, lse, cmax


def _check(hidden, emb, mask):
    n, d = hidden.shape
    v = emb.shape[0]
    if v % CHUNK or d % 16:
        raise ValueError(f"lm_head: needs V % {CHUNK} == 0 and D % 16 == 0, got {v}, {d}")
    _build.require(hidden, "hidden", torch.bfloat16, (n, d))
    _build.require(emb, "emb", torch.bfloat16, (v, d))
    _build.require(mask, "mask", torch.bool, (n, v))
    return n, v, d


def lm_head_greedy(hidden, emb, mask):
    """hidden [N, D]; emb [V, D]; mask bool [N, V] (True = banned)
    -> (cmax [N, V/128] f32, carg [N, V/128] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16) or raise."""
    if hidden.device.type == "cpu":
        return lm_head_greedy_plain(hidden, emb, mask)
    n, v, d = _check(hidden, emb, mask)
    cmax = torch.empty((n, v // CHUNK), dtype=F32, device=hidden.device)
    carg = torch.empty((n, v // CHUNK), dtype=torch.int32, device=hidden.device)
    _build.check(_build.lib().mmdx_lm_head_greedy(
        hidden.data_ptr(), emb.data_ptr(), mask.data_ptr(), cmax.data_ptr(),
        carg.data_ptr(), n, v, d, _build.stream(hidden)), "lm_head_greedy")
    lm_head_greedy.launches += 1
    return cmax, carg


lm_head_greedy.launches = 0


def lm_head_stats(hidden, emb, mask):
    """As ``lm_head_greedy`` -> (logits [N, V] f32, m [N] f32, L [N] f32,
    cmax [N, V/128] f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16) or raise."""
    if hidden.device.type == "cpu":
        return lm_head_stats_plain(hidden, emb, mask)
    n, v, d = _check(hidden, emb, mask)

    def empty(*shape):
        return torch.empty(shape, dtype=F32, device=hidden.device)

    logits, cmax, pmax, psum = empty(n, v), empty(n, v // CHUNK), \
        empty(n, v // CHUNK), empty(n, v // CHUNK)
    m, lse = empty(n), empty(n)
    _build.check(_build.lib().mmdx_lm_head_stats(
        hidden.data_ptr(), emb.data_ptr(), mask.data_ptr(), logits.data_ptr(),
        cmax.data_ptr(), pmax.data_ptr(), psum.data_ptr(), m.data_ptr(), lse.data_ptr(),
        n, v, d, _build.stream(hidden)), "lm_head_stats")
    lm_head_stats.launches += 1
    return logits, m, lse, cmax


lm_head_stats.launches = 0
