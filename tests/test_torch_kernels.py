"""The port's kernel modules against their Pallas functions.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors) is
held to the Pallas function run in TPU interpret mode, at f32 and tiny
shapes, on the same numpy-seeded inputs, with the JAX package's own Pallas
test tolerances (2e-5: tests/test_pallas_attention.py,
tests/test_pallas_t5_step.py:47; 1e-5: tests/test_pallas_beam_attn.py:45).
Each CUDA kernel is held to its plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import beam_attn, bert_attn, fused_ffn, t5_step


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got_torch, ref_jax, tol):
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(ref_jax),
                               rtol=tol, atol=tol)


def _bert_inputs(rng, b, seq, h):
    x = _np(rng, b * seq, h)
    kmask = np.zeros(b * seq, np.float32)
    kmask.reshape(b, seq)[1, seq // 2:] = -1e9  # one padded sequence
    return (x, kmask, _np(rng, h, 3 * h, scale=0.1), _np(rng, 3 * h, scale=0.02),
            _np(rng, h, h, scale=0.1), _np(rng, h, scale=0.02),
            1.0 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1))


@pytest.mark.parametrize("seq", [8, 16])
def test_bert_attn_plain_matches_pallas(seq):
    from mmdx_tpu.ops.pallas_bert_attn import fused_attention_block

    args = _bert_inputs(np.random.default_rng(seq), 3, seq, 64)
    jargs, targs = zip(*(_both(a) for a in args))
    with pltpu.force_tpu_interpret_mode():
        ref = fused_attention_block(*jargs, seq_len=seq, num_heads=4)
    got = bert_attn.fused_attention_block(*targs, seq_len=seq, num_heads=4)
    _close(got, ref, 2e-5)


def test_fused_ffn_plain_matches_pallas():
    from mmdx_tpu.ops.pallas_ffn import fused_ffn_ln

    rng = np.random.default_rng(1)
    h, f = 64, 128
    args = (_np(rng, 40, h), _np(rng, h, f, scale=0.1), _np(rng, f, scale=0.1),
            _np(rng, f, h, scale=0.1), _np(rng, h, scale=0.1),
            1.0 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1))
    jargs, targs = zip(*(_both(a) for a in args))
    with pltpu.force_tpu_interpret_mode():
        ref = fused_ffn_ln(*jargs, block_rows=32)
    got = fused_ffn.fused_ffn_ln(*targs)
    _close(got, ref, 2e-5)


def _beam_inputs(rng, pos, b=3, nb=4, h=4, d=16, lmax=7):
    """Decode-step inputs at ``pos``: causal bias + random ancestry mask with
    the own column dead (deferred writes), as models/t5 builds them."""
    kk = nb * lmax
    q, kv = _np(rng, b, nb, h * d), _np(rng, b, kk, 2 * h * d)
    t = np.arange(lmax)
    bias = np.repeat(_np(rng, h, lmax) + np.where(t <= pos, 0.0, -1e9), nb, axis=1)
    anc = rng.integers(0, nb, (b, nb, lmax))
    anc[:, :, pos] = -1
    live = anc[..., None] == np.arange(nb)
    mask = np.where(live.reshape(b, nb, kk), 0.0, -1e9).astype(np.float32)
    return q, kv, mask, bias.astype(np.float32)


@pytest.mark.parametrize("pos", [0, 3, 6])
def test_beam_attn_plain_matches_pallas(pos):
    """pos=0: every cache column is masked (-1e9, never -inf)."""
    from mmdx_tpu.ops.pallas_beam_attn import beam_decode_attention_partial

    args = _beam_inputs(np.random.default_rng(pos), pos)
    jargs, targs = zip(*(_both(a) for a in args))
    with pltpu.force_tpu_interpret_mode():
        ref = beam_decode_attention_partial(*jargs)
    got = beam_attn.beam_decode_attention_partial(*targs)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _close(g, r, 1e-5)


@pytest.mark.parametrize("pos", [0, 4])
def test_beam_attn_partials_compose_to_full_attention(pos):
    """Partials over the old cache + the own token composed as in
    models/t5.py == softmax attention over the cache with the own column
    written and live (at pos=0: exactly the own value)."""
    rng = np.random.default_rng(10 + pos)
    q, kv, mask, bias = (torch.from_numpy(a) for a in _beam_inputs(rng, pos))
    b, nb, hd = q.shape
    h, d = bias.shape[0], hd // bias.shape[0]
    k_new, v_new = (torch.from_numpy(_np(rng, b, nb, hd)) for _ in range(2))
    acc, m, l = beam_attn.beam_decode_attention_partial(q, kv, mask, bias)
    qh, kh, vh = (t.reshape(b, nb, h, d) for t in (q, k_new, v_new))
    s_own = (qh * kh).sum(-1) + bias[:, pos * nb][None, None, :]
    m2 = torch.maximum(m, s_own)
    ea, eb = torch.exp(m - m2), torch.exp(s_own - m2)
    ctx = (acc.reshape(b, nb, h, d) * ea[..., None] + eb[..., None] * vh) / (
        l * ea + eb)[..., None]

    full_kv = kv.clone()
    full_kv[:, pos * nb:(pos + 1) * nb] = torch.cat([k_new, v_new], -1)
    live_mask = mask.clone()
    live_mask.reshape(b, nb, -1, nb)[:, :, pos, :] = torch.where(
        torch.eye(nb, dtype=torch.bool), 0.0, -1e9)
    kk = kv.shape[1]
    s = torch.einsum("bihd,bkhd->bhik", qh, full_kv[..., :hd].reshape(b, kk, h, d))
    p = torch.softmax(s + bias[None, :, None, :] + live_mask[:, None], dim=-1)
    ref = torch.einsum("bhik,bkhd->bihd", p, full_kv[..., hd:].reshape(b, kk, h, d))
    np.testing.assert_allclose(ctx.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    if pos == 0:
        np.testing.assert_allclose(ctx.numpy(), vh.numpy(), rtol=1e-6, atol=1e-6)


def _t5_inputs(rng, n=8, kk=4, dm=32, dff=64):
    enc_bias = np.zeros((n, kk), np.float32)
    enc_bias[::3, -1] = -1e9
    return (_np(rng, n, dm), 1.0 + _np(rng, dm, scale=0.1), _np(rng, dm, dm, scale=0.2),
            _np(rng, dm, dm, scale=0.2), _np(rng, n, kk, dm), _np(rng, n, kk, dm),
            enc_bias, 1.0 + _np(rng, dm, scale=0.1), _np(rng, dm, dff, scale=0.2),
            _np(rng, dff, dm, scale=0.2))


def test_t5_cross_ffn_plain_matches_pallas():
    from mmdx_tpu.ops.pallas_t5_step import cross_ffn_block

    args = _t5_inputs(np.random.default_rng(2))
    jargs, targs = zip(*(_both(a) for a in args))
    with pltpu.force_tpu_interpret_mode():
        ref = cross_ffn_block(*jargs, heads=4)
    got = t5_step.cross_ffn_block(*targs, heads=4)
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("name", ["bert_attn", "fused_ffn", "beam_attn", "t5_step"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(name):
    """CPU tensors run the plain version and count no launch; a tensor on any
    other non-CUDA device goes to the kernel path, which refuses it (no
    silent fallback to the plain version)."""
    rng = np.random.default_rng(4)
    fn, args, kw = {
        "bert_attn": (bert_attn.fused_attention_block, _bert_inputs(rng, 2, 8, 64),
                      dict(seq_len=8, num_heads=4)),
        "fused_ffn": (fused_ffn.fused_ffn_ln,
                      (_np(rng, 8, 64), _np(rng, 64, 128), _np(rng, 128), _np(rng, 128, 64),
                       _np(rng, 64), _np(rng, 64), _np(rng, 64)), {}),
        "beam_attn": (beam_attn.beam_decode_attention_partial,
                      _beam_inputs(rng, 2, d=64), {}),
        "t5_step": (t5_step.cross_ffn_block, _t5_inputs(rng, dm=64, dff=128),
                    dict(heads=4)),
    }[name]
    before = fn.launches
    fn(*(torch.from_numpy(a) for a in args), **kw)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fn(*(torch.from_numpy(a).to("meta") for a in args), **kw)
    assert fn.launches == before
