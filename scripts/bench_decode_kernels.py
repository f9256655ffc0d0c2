#!/usr/bin/env python
"""Device time per call of the beam step's kernels and of the shared bf16
GEMM, for any checkout of the PyTorch port, on one CUDA card.

    python3 scripts/bench_decode_kernels.py [PORT_ROOT] [--ranks]

PORT_ROOT (default: this repository) is the directory whose
``mmdx_tpu_torch`` is imported, so one call can time an older checkout
(for example a ``git archive`` of the parent commit) and this one in turns.
Each line is one kernel at one shape: the device time per call from a CUDA
graph of 20 calls (``chip_smoke.graph_ms``, the median of 10 replays),
which leaves out the wrapper's host time:

  K4 ``t5_step.cross_ffn_block`` at T5-small widths, N = 4, 16, 20, 32, 64
  and 128 rows; K3 ``beam_attn.beam_decode_attention_partial`` at beam-4
  (nb 4, K = 724) for B = 4, 8 and 32; rows 5 and 7 (the normalised bf16
  and int8 reads) at greedy B=4 and B=64 (nb 1, K = 181) and at beam B=8;
  K2 ``fused_ffn.fused_ffn_ln`` (two launches of ``csrc/gemm.cu``'s GEMM)
  at BERT-base widths for the classify (M = 3072) and long-text (M = 16384)
  rows, CUDA graphs of 10 calls.

With ``--ranks`` (a checkout with ``beam_attn.cluster_ranks``), rows 5 and
6 are also timed at every cluster size, 1, 2, 4 and 8 blocks, pinned by
replacing ``cluster_ranks`` for the call, beside the size it picks.
Inputs are made from seed 0 on the host, as in chip_smoke.py.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from mmdx_tpu_torch.ops import beam_attn, fused_ffn, t5_step

    tag = root.name if root != HERE else "this tree"
    smoke.log(f"card: {smoke.card_line()}; mmdx_tpu_torch from {root} ({tag})")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(smoke.SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def report(label, fn, calls=20):
        try:
            fn()
        except RuntimeError as e:  # a cluster size whose chunk exceeds shared memory
            smoke.log(f"[{tag}] {label}: does not launch ({e})")
            return
        torch.cuda.synchronize()
        smoke.log(f"[{tag}] {label}: device {smoke.graph_ms(fn, calls) * 1e3:.2f} us per call")

    dm, kc, dff, heads = 512, 4, 2048, 8
    for n in (4, 16, 20, 32, 64, 128):
        enc_bias = torch.zeros(n, kc)
        enc_bias[::3, -1] = -1e9
        a = (randn(n, dm), 1.0 + randn(dm, scale=0.1, dtype=torch.float32),
             randn(dm, dm, scale=dm ** -0.5), randn(dm, dm, scale=dm ** -0.5),
             randn(n, kc, dm), randn(n, kc, dm), enc_bias.to(dev),
             1.0 + randn(dm, scale=0.1, dtype=torch.float32),
             randn(dm, dff, scale=dm ** -0.5), randn(dff, dm, scale=dff ** -0.5))
        report(f"K4 N={n}", lambda a=a: t5_step.cross_ffn_block(*a, heads=heads))

    sweep = "--ranks" in sys.argv and hasattr(beam_attn, "cluster_ranks")
    hd = heads * 64

    def pinned(ranks, fn, *args):
        """fn(*args) on clusters of ``ranks`` blocks."""
        def call():
            picked, beam_attn.cluster_ranks = beam_attn.cluster_ranks, lambda *_: ranks
            try:
                return fn(*args)
            finally:
                beam_attn.cluster_ranks = picked
        return call

    def cache(b, nb, lmax):
        kk = nb * lmax
        q = randn(b, nb, hd, scale=0.5)
        kv32 = torch.randn(b, kk, 2 * hd, generator=g) * 0.5
        bias = torch.randn(heads, lmax, generator=g).repeat_interleave(nb, dim=1).to(dev)
        live = torch.randint(0, nb, (b, nb, lmax), generator=g)[..., None] == torch.arange(nb)
        mask = torch.where(live.reshape(b, nb, kk), 0.0, -1e9).to(dev)
        return q, kv32, mask, bias

    for b in (4, 8, 32):
        q, kv32, mask, bias = cache(b, 4, 181)
        kv = kv32.to(dev, bf)
        fn = beam_attn.beam_decode_attention_partial
        report(f"K3 B={b} nb=4 K=724", lambda: fn(q, kv, mask, bias))
        if sweep:
            pick = beam_attn.cluster_ranks(b * heads, 724, beam_attn.PARTIAL_FILL)
            for r in (1, 2, 4, 8):
                report(f"K3 B={b} nb=4 K=724 ranks={r}{' (picked)' if r == pick else ''}",
                       pinned(r, fn, q, kv, mask, bias))
    for b, nb, lmax in ((4, 1, 181), (64, 1, 181), (8, 4, 181)):
        q, kv32, mask, bias = cache(b, nb, lmax)
        kv = kv32.to(dev, bf)
        kv8, kvs = beam_attn.quantize_kv_rows(kv32[..., :hd].to(dev), kv32[..., hd:].to(dev),
                                              heads)
        kk = nb * lmax
        report(f"row 5 B={b} nb={nb} K={kk}",
               lambda: beam_attn.beam_decode_attention(q, kv, mask, bias))
        report(f"row 7 B={b} nb={nb} K={kk}",
               lambda: beam_attn.beam_decode_attention_int8(q, kv8, kvs, mask, bias))
        if sweep:
            pick = beam_attn.cluster_ranks(b * heads, kk)
            for r in (1, 2, 4, 8):
                report(f"row 5 B={b} nb={nb} K={kk} ranks={r}{' (picked)' if r == pick else ''}",
                       pinned(r, beam_attn.beam_decode_attention, q, kv, mask, bias))

    h, f = 768, 3072
    for m in (3072, 16384):
        a = (randn(m, h), randn(h, f, scale=h ** -0.5), randn(f, scale=0.02),
             randn(f, h, scale=f ** -0.5), randn(h, scale=0.02), 1.0 + randn(h, scale=0.1),
             randn(h, scale=0.1))
        report(f"K2 M={m}", lambda a=a: fused_ffn.fused_ffn_ln(*a, eps=1e-12), calls=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
