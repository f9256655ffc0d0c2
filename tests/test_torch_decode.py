"""The port's decode-layer kernels and routes against the JAX package, on the
CPU at small sizes (the kernel wrappers run their plain versions on CPU
tensors; the Pallas functions run in interpret mode):

* ``ops/beam_attn.beam_decode_attention`` (row 5) and
  ``beam_decode_attention_int8`` (row 7) against the Pallas reads at nb = 1
  and nb = 4, f32 to 1e-5 and bf16 to 3e-2 (tests/test_pallas_beam_attn.py:45),
  the int8 read on the same quantized cache; the int8 cache's
  quantize-on-write bit-equal to ``models/t5.py:244-259``; the cluster
  kernel's split over keys and merge of the softmax statistics, emulated,
  against the same Pallas reads;
* ``ops/lm_head.lm_head_greedy`` (row 10) and ``lm_head_stats`` (row 11)
  against the Pallas kernels, with the bars of tests/test_lm_head.py, ties
  and a fully masked chunk; the lazy candidate top-k against the dense one;
* ``T5.decode_step_beam`` over the int8 cache, the non-deferred kernel read
  and the flat greedy layout against the JAX decode steps.

Inputs are made from seeds with numpy and handed to both sides.
"""
import dataclasses
import faulthandler
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.decode.beam_search import candidate_topk
from mmdx_tpu_torch.ops import beam_attn, lm_head

# bf16 reads: a few bf16 ulps of the probabilities and ctx (the Pallas
# package's own bf16 bar, tests/test_pallas_beam_attn.py:45)
TOL = {"f32": 1e-5, "bf16": 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _cache_inputs(rng, b, nb, lmax, h, d, pos):
    """q, k|v cache, ancestry mask with the own column live, causal bias."""
    kk, hd = nb * lmax, h * d
    q = rng.standard_normal((b, nb, hd)).astype(np.float32)
    kv = rng.standard_normal((b, kk, 2 * hd)).astype(np.float32)
    t = np.arange(lmax)
    anc = rng.integers(0, nb, (b, nb, lmax))
    anc = np.where(t[None, None, :] == pos, np.arange(nb)[None, :, None], anc)
    live = anc[..., None] == np.arange(nb)
    mask = np.where(live.reshape(b, nb, kk), 0.0, -1e9).astype(np.float32)
    bias = (rng.standard_normal((h, lmax)) + np.where(t <= pos, 0.0, -1e9))
    return q, kv, mask, np.repeat(bias, nb, axis=1).astype(np.float32)


def _to(a, dt):
    return jnp.asarray(a).astype(dt[0]), _t(a).to(dt[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nb", [1, 4])
def test_beam_attn_plain_matches_pallas(nb, dtype):
    from mmdx_tpu.ops.pallas_beam_attn import beam_decode_attention

    rng = np.random.default_rng(nb)
    q, kv, mask, bias = _cache_inputs(rng, 4, nb, 12, 2, 64, pos=7)
    (jq, tq), (jkv, tkv) = _to(q, DTYPES[dtype]), _to(kv, DTYPES[dtype])
    ref = beam_decode_attention(jq, jkv, jnp.asarray(mask), jnp.asarray(bias),
                                interpret=True)
    got = beam_attn.beam_decode_attention(tq, tkv, _t(mask), _t(bias))
    assert got.dtype == tq.dtype and got.shape == (4, nb, 128)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _jax_quantize(k_new, v_new, h):
    """``T5Attention.step_beam``'s quantize-on-write (``t5.py:244-259``),
    op by op."""
    b, nb, hd = k_new.shape
    d = hd // h
    kr = jnp.asarray(k_new).reshape(b, nb, h, d).astype(jnp.float32)
    vr = jnp.asarray(v_new).reshape(b, nb, h, d).astype(jnp.float32)
    sk = jnp.maximum(jnp.max(jnp.abs(kr), axis=-1), 1e-12) / 127.0
    sv = jnp.maximum(jnp.max(jnp.abs(vr), axis=-1), 1e-12) / 127.0
    ki = jnp.clip(jnp.round(kr / sk[..., None]), -127, 127)
    vi = jnp.clip(jnp.round(vr / sv[..., None]), -127, 127)
    rows = jnp.concatenate([ki.reshape(b, nb, hd), vi.reshape(b, nb, hd)],
                           axis=-1).astype(jnp.int8)
    return rows, jnp.concatenate([sk.transpose(0, 2, 1), sv.transpose(0, 2, 1)], axis=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_rows_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(11)
    k_new, v_new = (rng.standard_normal((3, 4, 128)).astype(np.float32) for _ in range(2))
    v_new[0, 1] = 0.0  # an all-zero row takes the 1e-12 floor
    (jk, tk), (jv, tv) = _to(k_new, DTYPES[dtype]), _to(v_new, DTYPES[dtype])
    rows, scales = beam_attn.quantize_kv_rows(tk, tv, heads=2)
    ref_rows, ref_scales = _jax_quantize(jk, jv, 2)
    assert rows.dtype == torch.int8 and scales.shape == (3, 4, 4)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nb", [1, 4])
def test_beam_attn_int8_plain_matches_pallas(nb, dtype):
    """The int8 read on one quantized cache: both sides get the same int8
    rows and scales, quantized by the port."""
    from mmdx_tpu.ops.pallas_beam_attn import beam_decode_attention_int8

    rng = np.random.default_rng(10 + nb)
    q, kv, mask, bias = _cache_inputs(rng, 4, nb, 12, 2, 64, pos=11)
    hd = q.shape[-1]
    # every cache row quantized as one write: rows [B, K, 2hd], kvs [B, 2h, K]
    rows, kvs = beam_attn.quantize_kv_rows(_t(kv[..., :hd]), _t(kv[..., hd:]), heads=2)
    jq, tq = _to(q, DTYPES[dtype])
    ref = beam_decode_attention_int8(jq, jnp.asarray(rows.numpy()), jnp.asarray(kvs.numpy()),
                                     jnp.asarray(mask), jnp.asarray(bias), interpret=True)
    got = beam_attn.beam_decode_attention_int8(tq, rows, kvs, _t(mask), _t(bias))
    assert got.dtype == tq.dtype and got.shape == (4, nb, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog ends the process at 180 s if its main thread is blocked in
    native code, where the alarm cannot run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _cluster_read(q, kv, mask, bias, ranks: int, kvs=None):
    """The cluster kernel's arithmetic (csrc/beam_attn.cu beam_attn_kernel)
    in torch f32, for ``ranks`` blocks each owning ceil(K / ranks)
    contiguous keys (none for some when K < ranks): f32 scores (times the K
    scales), each rank's max (-3e38 when empty) merged into the max m, each
    rank's sum of exp(s - m) added in rank order, p = e / sum (times the V
    scales) rounded to q.dtype, each rank's f32 partial p . v added in rank
    order, ctx in q.dtype."""
    b, nb, hd = q.shape
    kk, h = kv.shape[1], bias.shape[0]
    d = hd // h
    kh = kv[..., :hd].reshape(b, kk, h, d).float()
    vh = kv[..., hd:].reshape(b, kk, h, d).float()
    s = torch.einsum("bihd,bkhd->bhik", q.reshape(b, nb, h, d).float(), kh)
    if kvs is not None:
        s = s * kvs[:, :h, None, :]
    s = s + bias[None, :, None, :] + mask[:, None, :, :]
    chunk = -(-kk // ranks)
    spans = [(min(kk, r * chunk), min(kk, (r + 1) * chunk)) for r in range(ranks)]
    m = torch.full(s.shape[:-1], -3e38)
    for lo, hi in spans:
        if hi > lo:
            m = torch.maximum(m, s[..., lo:hi].amax(-1))
    e = torch.exp(s - m[..., None])
    total = torch.zeros(s.shape[:-1])
    for lo, hi in spans:
        total = total + e[..., lo:hi].sum(-1)
    p = e / total[..., None]
    if kvs is not None:
        p = p * kvs[:, h:, None, :]
    p = p.to(q.dtype).float()
    ctx = torch.zeros(b, h, nb, d)
    for lo, hi in spans:
        ctx = ctx + torch.einsum("bhik,bkhd->bhid", p[..., lo:hi], vh[:, lo:hi])
    return ctx.permute(0, 2, 1, 3).reshape(b, nb, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("kk", [5, 181, 724])
def test_cluster_read_arithmetic_matches_pallas(kk, nb, cache, dtype, time_guard):
    """The cluster kernel's 3-phase merge, emulated for clusters of 1, 3 and
    8 blocks (K = 5 < 8 leaves ranks empty; 181 and 724 are not multiples
    of 3 or 8), against the Pallas beam_decode_attention and
    beam_decode_attention_int8 in interpret mode, at the bars of
    test_beam_attn_plain_matches_pallas and
    test_beam_attn_int8_plain_matches_pallas. The first sample's mask kills
    every column (the all-masked first step), where m must stay finite."""
    from mmdx_tpu.ops.pallas_beam_attn import (beam_decode_attention,
                                               beam_decode_attention_int8)

    b, h, d = 2, 2, 64
    hd = h * d
    rng = np.random.default_rng(kk + nb)
    q = rng.standard_normal((b, nb, hd)).astype(np.float32)
    kv = rng.standard_normal((b, kk, 2 * hd)).astype(np.float32)
    mask = np.where(rng.random((b, nb, kk)) < 0.7, 0.0, -1e9).astype(np.float32)
    mask[0] = -1e9
    bias = rng.standard_normal((h, kk)).astype(np.float32)
    jq, tq = _to(q, DTYPES[dtype])
    if cache == "int8":
        rows, kvs = beam_attn.quantize_kv_rows(_t(kv[..., :hd]), _t(kv[..., hd:]), heads=h)
        ref = beam_decode_attention_int8(jq, jnp.asarray(rows.numpy()), jnp.asarray(kvs.numpy()),
                                         jnp.asarray(mask), jnp.asarray(bias), interpret=True)
        tkv = rows
    else:
        jkv, tkv = _to(kv, DTYPES[dtype])
        kvs = None
        ref = beam_decode_attention(jq, jkv, jnp.asarray(mask), jnp.asarray(bias),
                                    interpret=True)
    ref = np.asarray(ref, np.float32)
    for ranks in (1, 3, 8):
        got = _cluster_read(tq, tkv, _t(mask), _t(bias), ranks, kvs)
        assert got.dtype == tq.dtype and got.shape == (b, nb, hd)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"{ranks} ranks")


# ---------------------------------------------------------------------------
# rows 10 and 11: the streamed lm head
# ---------------------------------------------------------------------------
def _lm_inputs(kind: str, seed: int, n: int = 12, d: int = 32, v: int = 512):
    """hidden, emb (f32) and a ban mask. "ties": small integers, so every
    logit is exact on both sides and equal logits tie exactly (emb rows
    repeated within and across chunks); one row's second chunk fully banned."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        hidden = rng.integers(-2, 3, (n, d)).astype(np.float32)
        emb = rng.integers(-1, 2, (v, d)).astype(np.float32)
        emb[300:310] = emb[5]
        emb[131] = emb[129]
    else:
        hidden = rng.standard_normal((n, d)).astype(np.float32)
        emb = rng.standard_normal((v, d)).astype(np.float32)
    mask = rng.random((n, v)) < 0.2
    mask[2, lm_head.CHUNK:2 * lm_head.CHUNK] = True
    return hidden, emb, mask


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_lm_head_greedy_matches_pallas(kind):
    """cmax to 1e-5, carg and the selected token exact (the dense argmax's
    earliest-index order), a fully masked chunk included."""
    from mmdx_tpu.ops.pallas_lm_head import lm_head_greedy

    hidden, emb, mask = _lm_inputs(kind, 3)
    with pltpu.force_tpu_interpret_mode():
        ref_cmax, ref_carg = lm_head_greedy(hidden, emb, mask)
    cmax, carg = lm_head.lm_head_greedy(_t(hidden), _t(emb), _t(mask))
    assert cmax.shape == carg.shape == (12, 4) and carg.dtype == torch.int32
    np.testing.assert_allclose(cmax.numpy(), np.asarray(ref_cmax), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(carg.numpy(), np.asarray(ref_carg))
    assert np.isneginf(cmax[2, 1]) and carg[2, 1] == 0
    best = cmax.argmax(-1)
    tok = best * lm_head.CHUNK + carg.gather(1, best[:, None])[:, 0]
    dense = np.where(mask, -np.inf, hidden.astype(np.float64) @ emb.T.astype(np.float64))
    np.testing.assert_array_equal(tok.numpy(), dense.argmax(-1))


def test_lm_head_stats_matches_pallas():
    """The bars of tests/test_lm_head.py:20-65: logits and cmax to 1e-5, m
    to 1e-6 rel, L to 1e-5 rel + 1e-6."""
    from mmdx_tpu.ops.pallas_lm_head import lm_head_stats

    hidden, emb, mask = _lm_inputs("normal", 4, n=16, v=384)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in lm_head_stats(hidden, emb, mask)]
    got = [a.numpy() for a in lm_head.lm_head_stats(_t(hidden), _t(emb), _t(mask))]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_eos", [False, True])
def test_lazy_candidate_topk_matches_dense(mask_eos):
    """Indices equal, values to 1e-5 (tests/test_lm_head.py:69-87)."""
    rng = np.random.default_rng(2)
    b, nb, d, v = 3, 4, 32, 256
    hidden = _t(rng.standard_normal((b * nb, d)).astype(np.float32))
    emb = _t(rng.standard_normal((v, d)).astype(np.float32))
    scores = _t(rng.standard_normal((b, nb)).astype(np.float32))
    banned = _t(rng.random((b * nb, v)) < 0.1)
    lazy = lm_head.LazyLogits(hidden, emb)
    kw = dict(banned=banned, mask_eos=mask_eos, eos_token_id=1, k=2 * nb, b=b, nb=nb)
    ref_vals, ref_idx = candidate_topk(lazy.materialize(), scores, **kw)
    vals, idx = candidate_topk(lazy, scores, **kw)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    np.testing.assert_allclose(vals.numpy(), ref_vals.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the T5 decode step's new routes against the JAX decode steps (f32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    cfg = bridge.small_config()
    variables = bridge.random_state(cfg, 0)
    return cfg, variables, bridge.variables_to_torch(variables, cfg)


def _steps(small, nb, steps, report_over=None, beam_width="nb", port_kw=None,
           kv_int8=False, seed=2):
    """Run ``steps`` decode steps on both sides from one numpy seed: the JAX
    ``decode_step_beam`` (``beam_width="nb"``) or heads-major ``decode_step``
    (``beam_width=None``), the port's ``decode_step_beam`` with ``port_kw``.
    -> [(port logits, JAX logits)] per step, and both final caches."""
    from mmdx_tpu.models.diagnosis import MultiModalDiagnosisModel

    cfg, variables, model = small
    jcfg = dataclasses.replace(cfg, report=dataclasses.replace(cfg.report,
                                                               **(report_over or {})))
    jm = MultiModalDiagnosisModel(config=jcfg)
    b, lmax = 2, 6
    rng = np.random.default_rng(seed)
    zi = rng.standard_normal((b * nb, cfg.fusion.d_img)).astype(np.float32)
    zt = rng.standard_normal((b * nb, cfg.fusion.d_txt)).astype(np.float32)
    anc = (rng.integers(0, nb, (b, nb, lmax)) if nb > 1 else np.zeros((b, 1, lmax))).astype(np.int32)
    jprep = jm.apply(variables, jnp.asarray(zi), jnp.asarray(zt), lmax,
                     nb if beam_width == "nb" else None,
                     method=MultiModalDiagnosisModel.prepare_generation)
    tprep = model.prepare_generation(_t(zi), _t(zt), lmax, nb, kv_int8=kv_int8)
    jcache, out = jprep["cache"], []
    for pos in range(steps):
        tokens = rng.integers(0, cfg.report.vocab_size, (b * nb,))
        args = (jnp.asarray(tokens[:, None], jnp.int32), pos, jcache)
        if beam_width == "nb":
            args += (jnp.asarray(anc),)
        ref, jcache = jm.apply(
            variables, *args, jprep["static_kv"], jprep["self_bias"], jprep["enc_mask"],
            method=(MultiModalDiagnosisModel.decode_step_beam if beam_width == "nb"
                    else MultiModalDiagnosisModel.decode_step))
        got = model.decode_step_beam(
            _t(tokens), pos, tprep["cache"], _t(anc).long(), tprep["static_kv"],
            tprep["self_bias"], tprep["enc_mask"], **(port_kw or {}))
        out.append((got, np.asarray(ref)))
    return out, tprep["cache"], jcache


def test_nondeferred_kernel_read_matches_jax(small):
    """Beam-4 with the kernels on and deferred writes off: the cache write
    then the normalised read (row 5) against the JAX XLA path, 1e-5."""
    out, cache, jcache = _steps(small, 4, 3, port_kw=dict(kernels=True, defer=False))
    for got, ref in out:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    for tc, jc in zip(cache, jcache):
        np.testing.assert_allclose(tc["kv"].numpy(), np.asarray(jc["kv"]), rtol=1e-5,
                                   atol=1e-5)


def test_flat_greedy_step_matches_heads_major_jax(small):
    """Greedy over the flat cache at nb = 1 (all-zero ancestry, row 5 read)
    against the JAX heads-major ``decode_step``, 1e-5; the lazy head's
    logits are the dense ones."""
    out, _, _ = _steps(small, 1, 4, beam_width=None, port_kw=dict(kernels=True))
    for got, ref in out:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    lazy, _, _ = _steps(small, 1, 4, beam_width=None,
                        port_kw=dict(kernels=True, lazy_logits=True))
    for (got, _), (dense, _) in zip(lazy, out):
        assert isinstance(got, lm_head.LazyLogits)
        torch.testing.assert_close(got.materialize(), dense, rtol=0, atol=0)


@pytest.mark.parametrize("nb", [1, 4])
def test_int8_kv_step_matches_jax(small, nb):
    """The int8 cache (quantize-on-write + row 7's read) against JAX's
    ``decode_step_beam`` with ``kv_cache_int8`` (its XLA read), f32, over
    four steps. Both sides quantize the k|v rows of their own projections,
    whose f32 sums run in other orders, so a rare element (about 1 in 1e5)
    can land one int8 step apart: the rows agree within one step, the scales
    to 1e-6 rel. With no such flip the logits agree to 1e-5 (f32 sum order;
    ~3e-7 on these seeds); a flip moves the step's logits by about one step
    of a key, s * |q| (~1e-3 here), so then to 1e-2. Guardrail: within rel
    0.03 of the bf16-layout step on the same inputs (tests/test_kv_int8.py:
    241-242)."""
    out, cache, jcache = _steps(small, nb, 4, report_over=dict(kv_cache_int8=True),
                                port_kw=dict(kernels=True), kv_int8=True)
    flips = 0
    for tc, jc in zip(cache, jcache):
        d = np.abs(tc["kv"].numpy().astype(np.int32) - np.asarray(jc["kv"], np.int32))
        assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
        flips += np.count_nonzero(d)
        np.testing.assert_allclose(tc["kvs"].numpy(), np.asarray(jc["kvs"]), rtol=1e-6)
    tol = 1e-5 if flips == 0 else 1e-2
    for got, ref in out:
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    exact, _, _ = _steps(small, nb, 4, port_kw=dict(kernels=True, defer=False))
    for (q8, _), (ex, _) in zip(out, exact):
        rel = float(torch.linalg.norm(q8 - ex) / torch.linalg.norm(ex))
        assert rel < 0.03, rel


def test_topk_orders_ties_by_index():
    """Equal values come out in ascending index order, as ``lax.top_k``
    orders them (the JAX beam search's ``topk_small``)."""
    from mmdx_tpu_torch.decode.beam_search import topk

    x = np.array([[0.5, 2.0, 1.0, 2.0, -np.inf, 2.0, 1.0, 0.5],
                  [3.0, 1.0, 2.0, 0.0, -1.0, 4.0, 5.0, 6.0]], np.float32)
    for k in (1, 3, 5, 8):
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), k)
        vals, idx = topk(_t(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
