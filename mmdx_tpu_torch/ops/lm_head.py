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

Kernel (CUDA C++, ``csrc/lm_head.cu``): one CTA per vocab chunk streams its
128 emb rows through a TMA ring into ``wgmma`` against one or two 64-row
tiles of ``hidden`` and takes the statistics from the accumulator registers;
the stats merge their per-chunk partials into m and L in the same launch
(the last CTAs to finish, one row a warp, in a fixed order). What bounds
it on the H100: bytes, the 32.9 MB emb read at the T5 vocabulary, ~10 us.
The plan (consumer warpgroups, row groups, stages) is
``lm_head_plan``, computed here so the CPU tests see what the card runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops.gemm import H100_SMS, cdiv

CHUNK = 128
F32 = torch.float32
BK = 64                   # K step: one 128-byte swizzle row of bf16
WG_ROWS = 64              # rows of hidden per consumer warpgroup (wgmma's m64)
STAGE_BUDGET = 96 * 1024  # shared memory for a CTA's ring: two CTAs to an SM
SM_SMEM = 233472          # shared memory of one SM (228 KB)
CTA_RESERVED = 1024       # shared memory the runtime keeps per CTA
MAP_BYTES = 128           # sizeof(CUtensorMap)


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


# ---------------------------------------------------------------------------
# the plan, and the kernel's walk over it
# ---------------------------------------------------------------------------
class LmHeadPlan(NamedTuple):
    warpgroups: int   # consumer warpgroups, 64 rows of hidden each
    row_groups: int   # passes over a chunk's emb rows, 64 * warpgroups rows each
    stages: int       # the ring's depth
    ctas_per_sm: int
    waves: int        # of the V / 128 chunk CTAs over the SMs


def stage_bytes(warpgroups: int) -> int:
    """One ring stage: a [128, 64] emb box and a [64 * warpgroups, 64]
    hidden box (the mask tile of a row group, [64 * warpgroups, 128] bytes,
    fits in it)."""
    return (CHUNK + WG_ROWS * warpgroups) * BK * 2


def smem_bytes(warpgroups: int, stages: int) -> int:
    """A CTA's dynamic shared memory (``csrc/lm_head.cu:smem_bytes``): the
    ring, 1 KB of alignment slack, two mbarriers a stage."""
    return stages * stage_bytes(warpgroups) + 1024 + 2 * stages * 8


def lm_head_plan(n: int, v: int, d: int, sms: int = H100_SMS) -> LmHeadPlan:
    """The kernel's plan for ``hidden [n, d] @ emb [v, d]^T`` on ``sms`` SMs.

    One consumer warpgroup up to 64 rows, else two, which share each emb
    stage (emb read once up to 128 rows; past that the CTA walks row groups
    of 128 and reads its chunk again); the ring fills ``STAGE_BUDGET`` (4
    stages of 24 KB, or 3 of 32 KB), so two CTAs fit an SM. Raises unless
    v is a multiple of 128 and d of 64."""
    if n <= 0 or v <= 0 or v % CHUNK or d <= 0 or d % BK:
        raise ValueError(f"lm_head_plan: unsupported shape n={n} v={v} d={d} "
                         f"(v must be a multiple of {CHUNK}, d of {BK})")
    wgs = 1 if n <= WG_ROWS else 2
    stages = STAGE_BUDGET // stage_bytes(wgs)
    ctas = min(2, SM_SMEM // (smem_bytes(wgs, stages) + CTA_RESERVED))
    return LmHeadPlan(wgs, cdiv(n, WG_ROWS * wgs), stages, ctas,
                      cdiv(v // CHUNK, ctas * sms))


def lm_head_walk(n: int, v: int, plan: LmHeadPlan):
    """The kernel's walk: (chunk, row group, warpgroup, first row, rows that
    are real) for every accumulator tile it computes; rows past n are
    TMA's zeros and are not stored."""
    rg = WG_ROWS * plan.warpgroups
    for chunk in range(v // CHUNK):
        for g in range(plan.row_groups):
            for w in range(plan.warpgroups):
                row0 = g * rg + w * WG_ROWS
                yield chunk, g, w, row0, max(0, min(WG_ROWS, n - row0))


def workspace_words(n: int, v: int) -> int:
    """The stats' workspace in 4-byte words (``mmdx_lm_head_stats``): the
    per-chunk partials pmax and psum [n, C], then a 64-bit counter."""
    return 2 * n * (v // CHUNK) + 2


def merge_rows_of(ticket: int, chunks: int, n: int, warps: int) -> list[int]:
    """The rows the CTA holding merge ticket ``ticket`` merges (none but
    for the last R of a launch): R = min(C, max(8, ceil(n / warps)))
    mergers, merger k taking rows k, k + R, ... (``csrc/lm_head.cu``)."""
    r = min(chunks, max(8, cdiv(n, warps)))
    k = ticket % chunks - (chunks - r)
    return list(range(k, n, r)) if k >= 0 else []


_WORKSPACE: dict = {}


def workspace(device, n: int, v: int) -> torch.Tensor:
    """The stats' workspace for (device, n, v), zeroed once and kept: its
    counter only grows, launch after launch. Launches that share one must
    not run concurrently (one decode stream)."""
    key = (device, n, v)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = torch.zeros(workspace_words(n, v), dtype=torch.int32,
                                           device=device)
    return ws


@functools.lru_cache(maxsize=64)
def _emb_map(ptr: int, v: int, d: int):
    buf = (ctypes.c_ubyte * MAP_BYTES)()
    _build.check(_build.lib().mmdx_lm_head_emb_map(ptr, v, d, ctypes.addressof(buf)),
                 "lm_head_emb_map")
    return buf


def emb_map(emb) -> int:
    """The host address of the TMA descriptor of ``emb [V, D]``, encoded at
    its first use and kept (a descriptor holds only the address, the shape
    and the box)."""
    v, d = emb.shape
    return ctypes.addressof(_emb_map(emb.data_ptr(), v, d))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _check(hidden, emb, mask):
    n, d = hidden.shape
    v = emb.shape[0]
    plan = lm_head_plan(n, v, d)
    _build.require(hidden, "hidden", torch.bfloat16, (n, d))
    _build.require(emb, "emb", torch.bfloat16, (v, d))
    _build.require(mask, "mask", torch.bool, (n, v))
    return n, v, d, plan


def lm_head_greedy(hidden, emb, mask):
    """hidden [N, D]; emb [V, D]; mask bool [N, V] (True = banned)
    -> (cmax [N, V/128] f32, carg [N, V/128] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16) or raise."""
    if hidden.device.type == "cpu":
        return lm_head_greedy_plain(hidden, emb, mask)
    n, v, d, plan = _check(hidden, emb, mask)
    cmax = torch.empty((n, v // CHUNK), dtype=F32, device=hidden.device)
    carg = torch.empty((n, v // CHUNK), dtype=torch.int32, device=hidden.device)
    _build.check(_build.lib().mmdx_lm_head_greedy(
        hidden.data_ptr(), emb_map(emb), mask.data_ptr(), cmax.data_ptr(), carg.data_ptr(),
        n, v, d, plan.warpgroups, plan.stages, _build.stream(hidden)), "lm_head_greedy")
    lm_head_greedy.launches += 1
    return cmax, carg


lm_head_greedy.launches = 0


def lm_head_stats(hidden, emb, mask):
    """As ``lm_head_greedy`` -> (logits [N, V] f32, m [N] f32, L [N] f32,
    cmax [N, V/128] f32), in one launch.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16) or raise."""
    if hidden.device.type == "cpu":
        return lm_head_stats_plain(hidden, emb, mask)
    n, v, d, plan = _check(hidden, emb, mask)
    dev = hidden.device
    logits = torch.empty((n, v), dtype=F32, device=dev)
    cmax = torch.empty((n, v // CHUNK), dtype=F32, device=dev)
    m, lse = torch.empty(n, dtype=F32, device=dev), torch.empty(n, dtype=F32, device=dev)
    _build.check(_build.lib().mmdx_lm_head_stats(
        hidden.data_ptr(), emb_map(emb), mask.data_ptr(), logits.data_ptr(), cmax.data_ptr(),
        m.data_ptr(), lse.data_ptr(), workspace(dev, n, v).data_ptr(), n, v, d,
        plan.warpgroups, plan.stages, _build.stream(hidden)), "lm_head_stats")
    lm_head_stats.launches += 1
    return logits, m, lse, cmax


lm_head_stats.launches = 0
