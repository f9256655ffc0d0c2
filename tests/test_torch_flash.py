"""The port's long-text route against the JAX package, on the CPU.

* row 9 (``ops/flash_attention.py``): the plain version against the Pallas
  ``flash_attention`` in interpret mode, with ragged lengths (the wrapper's
  padded keys), a padding bias (one sequence fully masked, where the padding
  shows), and a causal bias: 1e-5 in f32, 3e-2 in bf16; the tensor-core
  body's arithmetic (exact bf16 products, p split into two bf16 halves)
  emulated and held to 2e-5, and the rule that picks that body;
* the BERT layer's routing by length (fused block, einsum, flash), and the
  text tower on the flash and einsum routes against the JAX ``TextEncoder``
  at narrow widths;
* the engine's long-text configuration (``max_len`` 512): its buckets and
  which attention each bucket runs.

Inputs are made from seeds with numpy and handed to both sides. The JAX side
runs under ``jax.jit``: eager ops dispatched while an interpret-mode Pallas
call is still running its host callbacks can deadlock. Each test is held to
120 s by an alarm, and a watchdog ends a worker blocked past 180 s, so that
a hang fails one test.
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
from mmdx_tpu_torch.config import TextEncoderConfig
from mmdx_tpu_torch.models import bert
from mmdx_tpu_torch.ops import bert_attn, flash_attention as fa


@pytest.fixture(autouse=True)
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog thread ends the process at 180 s if its main thread is blocked
    in native code, where the alarm cannot run (the test then fails as a
    crashed worker)."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# row 9: flash attention
# ---------------------------------------------------------------------------
def _flash_inputs(rng, b, h, lq, lk, d, bias_kind):
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    if bias_kind == "padding":  # [B, 1, 1, Lk]: the last quarter masked, sequence 1 fully
        mask = np.ones((b, 1, 1, lk), np.float32)
        mask[:, :, :, -lk // 4:] = 0
        mask[1] = 0
    else:  # causal [1, 1, Lq, Lk]
        mask = np.tril(np.ones((lq, lk), np.float32))[None, None]
    return q, k, v, ((1.0 - mask) * -1e9).astype(np.float32)


@pytest.mark.parametrize("lq,lk,bias_kind,dtype", [
    (96, 160, "padding", "f32"),   # keys padded 160 -> 256 by the wrapper
    (100, 72, "padding", "f32"),   # ragged query rows, one key block
    (64, 64, "causal", "f32"),
    (130, 130, "causal", "f32"),   # two query blocks, keys padded to 256
    (96, 160, "padding", "bf16"),
    (64, 64, "causal", "bf16"),
])
def test_flash_plain_matches_pallas(lq, lk, bias_kind, dtype):
    from mmdx_tpu.ops.pallas_attention import flash_attention

    rng = np.random.default_rng(lq + lk)
    d = 16
    q, k, v, bias = _flash_inputs(rng, 2, 3, lq, lk, d, bias_kind)
    scale = 1.0 / np.sqrt(d)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 3e-2))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a: flash_attention(*a, scale=scale))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias))
    got = fa.flash_attention(*(_t(a).to(tdt) for a in (q, k, v)), _t(bias), scale)
    assert got.dtype == tdt and got.shape == (2, 3, lq, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_padded_key_len_follows_the_pallas_wrapper():
    assert [fa.padded_key_len(n) for n in (64, 100, 128, 160, 176, 256, 344, 512)] == \
        [64, 100, 128, 256, 256, 256, 384, 512]


def test_flash_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(4)
    args = _flash_inputs(rng, 2, 2, 16, 16, fa.HEAD_DIM, "padding")
    before = fa.flash_attention.launches
    fa.flash_attention(*(_t(a) for a in args), 0.125)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fa.flash_attention(*(_t(a).to("meta") for a in args), 0.125)
    assert fa.flash_attention.launches == before


def _tensor_core_emulation(q, k, v, bias, scale, split=True, tile=64):
    """The tensor-core body's arithmetic (csrc/flash_attn.cu
    flash_attn_tc_kernel) in torch f32: q, k, v hold bf16 values, so q . k
    sums exact products in f32, times the power-of-two scale (exact); the
    online softmax over 64-key tiles in f32 from m = -1e9, with the
    wrapper's padded keys at -1e9 and keys past the padded length excluded;
    p . v with p split into bf16 hi + lo (``split``) or rounded once to bf16;
    acc / l in f32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    lk_pad = fa.padded_key_len(lk)
    bias = torch.broadcast_to(bias, (b, h, lq, lk))
    acc = torch.zeros(b, h, lq, d)
    m = torch.full((b, h, lq, 1), -1e9)
    l = torch.zeros(b, h, lq, 1)
    bf = torch.bfloat16
    for k0 in range(0, lk_pad, tile):
        kt = torch.zeros(b, h, tile, d)
        vt = torch.zeros(b, h, tile, d)
        n = max(0, min(lk, k0 + tile) - k0)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = (q @ kt.transpose(-1, -2)) * scale
        s[..., :n] += bias[..., k0:k0 + n]
        cols = torch.arange(k0, k0 + tile)
        s[..., cols >= lk] = -1e9
        s[..., cols >= lk_pad] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.to(bf).float()
        acc = acc * corr + hi @ vt
        if split:
            acc = acc + (p - hi).to(bf).float() @ vt
        else:
            acc = acc + (p.to(bf).float() - hi) @ vt  # zero: hi is p rounded once
    return acc / l


@pytest.mark.parametrize("seq", [64, 200, 344])
def test_tensor_core_arithmetic_matches_pallas(seq):
    """The tensor-core body's emulated arithmetic against the Pallas
    flash_attention (interpret mode, f32 inputs holding the same bf16
    values) at BERT's head width and scale 1/8: ragged key lengths (200, 344:
    the wrapper's padded keys) and one sequence with every key masked. Split
    p within 2e-5; p rounded once to bf16 at least 10x further off, which
    is why the kernel splits it."""
    from mmdx_tpu.ops.pallas_attention import flash_attention

    rng = np.random.default_rng(seq)
    d = fa.HEAD_DIM
    q, k, v, bias = _flash_inputs(rng, 2, 2, seq, seq, d, "padding")
    q, k, v = (_t(a).to(torch.bfloat16).float() for a in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    assert fa.tensor_core_body(torch.bfloat16, scale)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda *a: flash_attention(*a, scale=scale))(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(bias)))
    split = _tensor_core_emulation(q, k, v, _t(bias), scale).numpy()
    once = _tensor_core_emulation(q, k, v, _t(bias), scale, split=False).numpy()
    err_split, err_once = np.abs(split - ref).max(), np.abs(once - ref).max()
    assert err_split <= 2e-5, err_split
    assert err_once >= 10 * err_split, (err_once, err_split)


@pytest.mark.parametrize("dtype,scale,tensor_cores", [
    (torch.bfloat16, 0.125, True),        # BERT-base: 1/sqrt(64)
    (torch.bfloat16, 1.0, True),          # T5: no scale
    (torch.bfloat16, 2.0 ** -20, True),
    (torch.bfloat16, 48 ** -0.5, False),  # a head width of 48
    (torch.bfloat16, -0.125, False),
    (torch.bfloat16, 0.0, False),
    (torch.float32, 0.125, False),        # the parity engine's f32 operands
    (torch.float16, 0.125, False),
])
def test_tensor_core_body_rule(dtype, scale, tensor_cores):
    """The wrapper's rule: the tensor-core body only for bf16 operands with
    a positive power-of-two scale."""
    assert fa.tensor_core_body(dtype, scale) is tensor_cores


# ---------------------------------------------------------------------------
# routing by length, and the text tower on each route
# ---------------------------------------------------------------------------
def test_attention_route_picks_the_intended_function(monkeypatch):
    """Each L reaches one attention function: the fused block up to 128,
    the einsum route up to flash_min_seq_len, then flash (when on)."""
    cfg = TextEncoderConfig(vocab_size=64, hidden_size=64, num_layers=1, num_heads=1,
                            intermediate_size=64, max_len=512,
                            use_flash_attention=True)
    layer = bert.BertLayer(cfg).eval()
    for p in layer.parameters():
        p.data.normal_(0, 0.05, generator=torch.Generator().manual_seed(0))
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(bert_attn, "fused_attention_block",
                        spy("block", bert_attn.fused_attention_block))
    monkeypatch.setattr(fa, "flash_attention", spy("flash", fa.flash_attention))
    monkeypatch.setattr(bert, "attention_einsum", spy("einsum", bert.attention_einsum))
    want = {64: "block", 128: "block", 129: "einsum", 176: "einsum", 255: "einsum",
            256: "flash", 344: "flash", 512: "flash"}
    for seq, route in want.items():
        calls.clear()
        x = torch.randn(seq, 64, generator=torch.Generator().manual_seed(seq))
        with torch.inference_mode():
            out = layer(x, torch.zeros(seq), seq, kernels=True)
        assert layer.attention_route(seq) == route and calls == [route], (seq, calls)
        assert out.shape == x.shape and torch.isfinite(out).all()
    layer.cfg = dataclasses.replace(cfg, use_flash_attention=False)
    assert [layer.attention_route(n) for n in (128, 256, 512)] == ["block", "einsum", "einsum"]


def _jax_and_port_towers(cfg):
    """JAX TextEncoder variables from seeded numpy weights, and the port's
    TextEncoder (f32) loaded with them."""
    from mmdx_tpu_torch.models.bert import TextEncoder

    small = bridge.small_config()
    full = dataclasses.replace(small, text=cfg)
    params = bridge.random_state(full, 0)["params"]["text_encoder"]
    port = TextEncoder(cfg)
    state = bridge._text_state(params, type("C", (), {"text": cfg}))
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in state.items()}, strict=True)
    return params, port.eval()


def _text_inputs(cfg, b, seq, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < rng.integers(seq // 2, seq + 1, (b, 1))).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("route,seq,limits", [
    ("flash", 288, {}),                                    # BERT's own limits
    ("einsum", 32, {"fused_attn_max_seq_len": 16, "flash_min_seq_len": 48}),
    ("flash", 64, {"fused_attn_max_seq_len": 16, "flash_min_seq_len": 48}),
])
def test_text_tower_route_matches_jax(route, seq, limits):
    """The port's text tower (kernels=True, so the plain versions on the CPU)
    against the JAX TextEncoder with the fused attention block and flash
    attention on, which routes the same L the same way; f32, 2e-5."""
    from mmdx_tpu.config import TextEncoderConfig as JaxTextConfig
    from mmdx_tpu.models.bert import TextEncoder as JaxTextEncoder

    cfg = TextEncoderConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                            intermediate_size=64, d_txt=16, max_len=seq,
                            max_position_embeddings=max(seq, 64),
                            use_flash_attention=True, **limits)
    params, port = _jax_and_port_towers(cfg)
    assert port.bert.layers[0].attention_route(seq) == route
    ids, mask = _text_inputs(cfg, 2, seq, seq)
    jcfg = JaxTextConfig(**{**dataclasses.asdict(cfg), "use_fused_attn_block": True})
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(JaxTextEncoder(config=jcfg).apply)(
            {"params": jax.tree.map(jnp.asarray, params)}, ids, mask)["embeddings"]
    with torch.inference_mode():
        got = port.encode(_t(ids).long(), _t(mask).long(), kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the engine's long-text configuration
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def long_text_engines():
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    small = bridge.small_config()
    cfg = dataclasses.replace(small, text=dataclasses.replace(
        small.text, max_len=512, max_position_embeddings=512))
    tb = bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg)
    return (InferenceEngine(tb, mode="fast", device="cpu"),
            InferenceEngine(tb, mode="parity", device="cpu"))


def _text_of(n_words: int) -> str:
    words = ["cough", "fever", "dyspnea", "effusion", "opacity", "chest", "pain"]  # 1 piece each
    return " ".join(words[i % len(words)] for i in range(n_words))


def test_engine_long_text_buckets(long_text_engines, monkeypatch):
    """max_len 512 buckets texts at 176 / 256 / 344 / 512; the fast engine
    runs flash in every layer from 256 tokens on and the einsum route at 176
    (no fused block), and agrees with the parity engine (einsum at 512)
    within the fast-vs-parity bar, 0.1."""
    from mmdx_tpu_torch.runtime.engine import bucket_ladder

    fast, parity = long_text_engines
    assert bucket_ladder(512) == (176, 256, 344)
    assert fast.model.text_encoder.cfg.use_flash_attention
    assert not parity.model.text_encoder.cfg.use_flash_attention
    calls = {"flash": 0, "block": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention", count("flash", fa.flash_attention))
    monkeypatch.setattr(bert_attn, "fused_attention_block",
                        count("block", bert_attn.fused_attention_block))
    img = np.random.default_rng(1).integers(0, 256, (80, 80, 3), dtype=np.uint8)
    layers = fast.bundle.config.text.num_layers
    for n_words, bucket in ((20, 176), (200, 256), (300, 344), (450, 512)):
        texts = [_text_of(n_words), "no complaints"]
        assert fast.prep_texts(texts)["input_ids"].shape[1] == bucket
        calls.update(flash=0, block=0)
        probs, _, _ = fast.classify_batch([img, img], texts)
        assert calls == {"flash": layers if bucket >= 256 else 0, "block": 0}, (bucket, calls)
        assert probs.shape == (2, 13) and np.isfinite(probs).all()
        if bucket == 512:
            ref, _, _ = parity.classify_batch([img, img], texts)
            assert np.abs(probs - ref).max() < 0.1


def test_route_config_fields_cross_to_a_jax_bundle_and_back():
    """max_len 512, the flash and fused-block fields survive the config's
    JSON both ways (the bundle metadata the two packages share)."""
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu_torch.config import DiagnosisConfig

    small = bridge.small_config()
    cfg = dataclasses.replace(
        small, text=dataclasses.replace(small.text, max_len=512, max_position_embeddings=512,
                                        use_flash_attention=True, flash_min_seq_len=192),
        image=dataclasses.replace(small.image, use_fused_bottleneck=True,
                                  fused_bottleneck_max_width=64))
    jcfg = JaxConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert DiagnosisConfig.from_json(jcfg.to_json()) == cfg
