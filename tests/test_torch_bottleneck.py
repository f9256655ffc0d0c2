"""The port's fused bottlenecks against the JAX package, on the CPU.

* row 13 (``ops/int8_bottleneck.py``): the plain version against the Pallas
  ``fused_bottleneck_int8`` in interpret mode, s8 outputs identical, at the
  parametrisations of ``tests/test_pallas_int8_bottleneck.py`` (the tests
  convert NHWC to the Pallas width-padded layout and back); the folded
  requant vectors against ``fold_block_epilogues``; the int8 tower with
  stages 1-2 fused against the JAX fused tower (eager) at 64x64, and
  against the port's unfused tower inside the JAX guardrail;
* row 12 (``ops/bottleneck.py``): the plain version against the Pallas
  ``fused_bottleneck`` (f32 2e-4, bf16 3e-2), with and without the
  projection; ``fold_bn``; the fused image tower against the JAX fused
  tower at 32x32;
* the engine: ``MMDX_INT8_FUSED_BLOCKS`` in turbo mode, and no engine mode
  running the bf16 fused blocks.

JAX results that several cases share are computed once per module. The
JAX side runs under ``jax.jit``, or eagerly with each Pallas call waited
for (the int8 tower, whose eager glue is the bit-exact reference): eager
ops dispatched while an interpret-mode Pallas call is still running its
host callbacks can deadlock. Each test is held to 120 s by an alarm, and a
watchdog ends a worker blocked past 180 s, so that a hang fails one test.
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
from mmdx_tpu_torch.models import resnet_int8 as ri
from mmdx_tpu_torch.models.layers import cast_
from mmdx_tpu_torch.models.resnet import ImageEncoder
from mmdx_tpu_torch.ops import bottleneck as bn
from mmdx_tpu_torch.ops import int8_bottleneck as ib


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
# row 13: the int8 fused bottleneck
# ---------------------------------------------------------------------------
def _int8_args(rng, c, m):
    """tests/test_pallas_int8_bottleneck.py:_rand_args, as numpy."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    return dict(
        w1=i8(c, m), k1=(rng.random(m) * 0.01 + 1e-3).astype(np.float32),
        b1=(rng.standard_normal(m) * 2).astype(np.float32),
        w2flat=i8(9 * m, m), k2=(rng.random(m) * 0.002 + 1e-4).astype(np.float32),
        b2=(rng.standard_normal(m) * 2).astype(np.float32),
        w3=i8(m, c), k3=(rng.random(c) * 0.01 + 1e-3).astype(np.float32),
        b3=(rng.standard_normal(c) * 2).astype(np.float32), kx=np.float32(0.7))


@pytest.mark.parametrize("b,h,w,c,m,g", [
    (2, 6, 5, 128, 64, 1),    # odd width, one image per program
    (4, 4, 4, 128, 64, 2),    # two images per program
])
def test_int8_bottleneck_plain_matches_pallas(b, h, w, c, m, g):
    from mmdx_tpu.ops.pallas_int8_bottleneck import fused_bottleneck_int8, pad_wp, unpad_wp

    rng = np.random.default_rng(0)
    wp = 32
    x = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    args = _int8_args(rng, c, m)
    ref = np.asarray(jax.jit(lambda x, a: unpad_wp(fused_bottleneck_int8(
        pad_wp(x, wp), **a, height=h, width=w, wp=wp, g=g, interpret=True), h, w, wp))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in args.items()}))
    got = ib.fused_bottleneck_int8(_t(x), **{k: (float(v) if k == "kx" else _t(v))
                                             for k, v in args.items()})
    assert got.dtype == torch.int8 and got.shape == (b, h, w, c)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_bottleneck_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(1)
    x = _t(rng.integers(-127, 128, (1, 3, 3, 8)).astype(np.int8))
    args = {k: (float(v) if k == "kx" else _t(v)) for k, v in _int8_args(rng, 8, 4).items()}
    before = ib.fused_bottleneck_int8.launches
    ib.fused_bottleneck_int8(x, **args)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ib.fused_bottleneck_int8(x.to("meta"), **{
            k: v if k == "kx" else v.to("meta") for k, v in args.items()})
    assert ib.fused_bottleneck_int8.launches == before


@pytest.fixture(scope="module")
def int8_tower():
    """Small-config weights (numpy, seeded), 64x64 normalized inputs, the
    JAX calibration and qparams, the f32 folded oracle, and the JAX tower
    with MMDX_INT8_FUSED_BLOCKS=1,2 run eagerly (its Pallas blocks in
    interpret mode): computed once for the module."""
    from mmdx_tpu.models import resnet_int8 as jri

    cfg = bridge.small_config()
    variables = bridge.random_state(cfg, 0)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
    x = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    scales = jri.calibrate_backbone(variables, x)
    q_jax = jax.tree.map(np.asarray, jax.jit(
        lambda v: jri.quantize_backbone(v, scales, img_size=64))(variables))
    from mmdx_tpu.ops import pallas_int8_bottleneck as jib

    kernel = jib.fused_bottleneck_int8
    mp = pytest.MonkeyPatch()
    mp.setenv("MMDX_INT8_FUSED_BLOCKS", "1,2")
    mp.setattr(jib, "fused_bottleneck_int8",
               lambda *a, **kw: jax.block_until_ready(kernel(*a, **kw)))
    try:
        fused_jax = np.asarray(jri.int8_backbone_apply(q_jax, x))
    finally:
        mp.undo()
    folded = ri.folded_backbone(
        bridge.bundle_from_variables(variables, cfg).model.image_encoder.backbone)
    ref_f32 = ri.folded_forward(folded, _t(x))[0].numpy()
    return dict(x=x, q_jax=q_jax, fused_jax=fused_jax, ref_f32=ref_f32, scales=scales)


def test_fold_block_epilogues_matches_jax(int8_tower):
    from mmdx_tpu.ops.pallas_int8_bottleneck import fold_block_epilogues as jax_fold

    q_jax = int8_tower["q_jax"]
    q = bridge.qparams_from_jax(q_jax)
    sc, sj = q["scales"], q_jax["scales"]
    for name, prev in (("layer1_block1", "layer1_block0"), ("layer2_block2", "layer2_block1")):
        site = [f"{prev}.out"] + [f"{name}.{k}" for k in ("a1", "a2", "out")]
        got = ib.fold_block_epilogues(q[name], *(sc[s] for s in site))
        ref = jax_fold(q_jax[name], *(sj[s] for s in site))
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            g = got[k] if k != "kx" else np.float32(got[k])
            np.testing.assert_array_equal(np.asarray(g), np.asarray(v), err_msg=k)
        # the weights are views of the K-major GEMM operands, which the
        # kernel reads in place: no copy
        for k, conv in (("w1", "conv1"), ("w2flat", "conv2"), ("w3", "conv3")):
            wk = q[name][conv]["wk"]
            assert got[k].data_ptr() == wk.data_ptr(), k
            assert got[k].stride() == (1, wk.stride(0)), k


def test_fused_block_operands_made_once(int8_tower, monkeypatch):
    """The fused int8 tower folds each block's requant chain at its first
    call and keeps it: a second call folds nothing; new scales fold again."""
    q = bridge.qparams_from_jax(int8_tower["q_jax"])
    x = _t(int8_tower["x"])[:1]
    folds = []
    original = ri.fold_block_epilogues
    monkeypatch.setattr(ri, "fold_block_epilogues",
                        lambda *a: folds.append(a[1:]) or original(*a))
    first = ri.int8_backbone_apply(q, x, fuse_stages=(1, 2))
    assert len(folds) == 5
    ops = ri.fused_block_operands(q["layer1_block1"], *folds[0])
    again = ri.int8_backbone_apply(q, x, fuse_stages=(1, 2))
    assert len(folds) == 5 and torch.equal(first, again)
    assert ri.fused_block_operands(q["layer1_block1"], *folds[0]) is ops
    q2 = dict(q, scales={k: v * 2 for k, v in q["scales"].items()})
    ri.int8_backbone_apply(q2, x, fuse_stages=(1, 2))
    assert len(folds) == 10


def test_int8_fused_tower_matches_jax(int8_tower):
    """Stages 1-2 fused: against the JAX fused tower on the same int8
    weights (rel-L2 1e-3, the bar of the unfused towers), and against the
    port's unfused tower inside the JAX guardrail (0.05 of the f32 maximum,
    tests/test_pallas_int8_bottleneck.py:131-137)."""
    q = bridge.qparams_from_jax(int8_tower["q_jax"])
    x = _t(int8_tower["x"])
    fused = ri.int8_backbone_apply(q, x, fuse_stages=(1, 2)).numpy()
    base = ri.int8_backbone_apply(q, x).numpy()
    ref, ref_f32 = int8_tower["fused_jax"], int8_tower["ref_f32"]
    assert fused.shape == ref.shape == (2, 2048)
    assert np.linalg.norm(fused - ref) / np.linalg.norm(ref) < 1e-3
    denom = np.abs(ref_f32).max()
    assert np.abs(fused - ref_f32).max() / denom < 0.10
    assert np.abs(fused - base).max() / denom < 0.05


# ---------------------------------------------------------------------------
# row 12: the bf16 / f32 fused bottleneck
# ---------------------------------------------------------------------------
def _bf_args(rng, cin, m, cout, proj):
    """tests/test_pallas_bottleneck.py's inputs, as numpy."""
    def r(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    args = dict(w1=r(cin, m), b1=r(m), w2=r(3, 3, m, m), b2=r(m), w3=r(m, cout), b3=r(cout))
    if proj:
        args.update(wp=r(cin, cout), bp=r(cout))
    return args


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bottleneck_plain_matches_pallas(proj, dtype):
    from mmdx_tpu.ops.pallas_bottleneck import fused_bottleneck

    rng = np.random.default_rng(0)
    b, h, w, cin, m = 2, 10, 10, 32, 16
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    args = _bf_args(rng, cin, m, cin, proj)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 2e-4) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 3e-2))
    weights = {"w1", "w2", "w3", "wp"}
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x, a: fused_bottleneck(x, **a))(jnp.asarray(x, jdt), {
            k: jnp.asarray(v, jdt if k in weights else jnp.float32) for k, v in args.items()})
    got = bn.fused_bottleneck(_t(x).to(tdt), **{
        k: _t(v).to(tdt if k in weights else torch.float32) for k, v in args.items()})
    assert got.dtype == tdt and got.shape == (b, h, w, cin)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_bottleneck_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((1, 4, 4, 16)).astype(np.float32))
    args = {k: _t(v) for k, v in _bf_args(rng, 16, 8, 16, False).items()}
    before = bn.fused_bottleneck.launches
    bn.fused_bottleneck(x, **args)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        bn.fused_bottleneck(x.to("meta"), **{k: v.to("meta") for k, v in args.items()})
    assert bn.fused_bottleneck.launches == before


def test_fold_bn_matches_jax():
    from mmdx_tpu.ops.pallas_bottleneck import fold_bn as jax_fold_bn

    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    scale = (rng.standard_normal(8) * 0.5 + 1.0).astype(np.float32)
    bias, mean = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    var = (rng.random(8) + 0.5).astype(np.float32)
    ref = jax_fold_bn(*(jnp.asarray(a) for a in (k, scale, bias, mean, var)), 1e-5)
    got = bn.fold_bn(*(_t(a) for a in (k, scale, bias, mean, var)), 1e-5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_fused_image_tower_matches_jax():
    """The image encoder with use_fused_bottleneck (stage 1 blocks 0-2, stage
    2 blocks 1-3 through the fused block) against the JAX fused encoder at
    32x32 on the same variables, and against the port's unfused path; f32,
    2e-4 (tests/test_pallas_bottleneck.py)."""
    from mmdx_tpu.config import ImageEncoderConfig as JaxImageConfig
    from mmdx_tpu.models.resnet import ImageEncoder as JaxImageEncoder

    small = bridge.small_config()
    cfg = dataclasses.replace(small, image=dataclasses.replace(
        small.image, img_size=32, use_fused_bottleneck=True))
    variables = bridge.random_state(cfg, 0)
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    jvars = {"params": variables["params"]["image_encoder"],
             "batch_stats": variables["batch_stats"]["image_encoder"]}
    enc = JaxImageEncoder(config=JaxImageConfig(**dataclasses.asdict(cfg.image)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(enc.apply)(jax.tree.map(jnp.asarray, jvars), x)["embeddings"])
    port = bridge.bundle_from_variables(variables, cfg).model.image_encoder
    fusable = [i for i, blk in enumerate(port.backbone.blocks) if blk.fusable]
    assert fusable == [0, 1, 2, 4, 5, 6]
    unfused_port = ImageEncoder(dataclasses.replace(cfg.image, use_fused_bottleneck=False))
    unfused_port.load_state_dict(port.state_dict())
    calls = []
    original = bn.fused_bottleneck

    def spy(*a, **kw):
        calls.append(1)
        return original(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr("mmdx_tpu_torch.models.resnet.fused_bottleneck", spy)
    try:
        with torch.inference_mode():
            got = port.encode(_t(x)).numpy()
            unfused = unfused_port.encode(_t(x)).numpy()
    finally:
        mp.undo()
    assert len(calls) == 6
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, unfused, rtol=2e-4, atol=2e-4)


def test_fused_operands_made_once():
    """A fused block makes its kernel operands at its first call and keeps
    them; a cast to bf16 (weights bf16, biases f32) and a load of new
    weights make them again."""
    small = bridge.small_config()
    cfg = dataclasses.replace(small.image, img_size=32, use_fused_bottleneck=True)
    enc = ImageEncoder(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    blk = enc.backbone.blocks[0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        enc.encode(x)
        first = blk.fused_operands(torch.float32)
        enc.encode(x)
        assert blk.fused_operands(torch.float32) is first
        assert [t.shape for t in first[:2]] == [(64, 64), (64,)]
        cast_(enc, torch.bfloat16)
        z = enc.encode(x.to(torch.bfloat16))
        ops = blk.fused_operands(torch.bfloat16)
        assert ops is not first and torch.isfinite(z.float()).all()
        assert [t.dtype for t in ops] == [torch.bfloat16, torch.float32] * 3 + [
            torch.bfloat16, torch.float32]
        w1 = blk.conv1.weight[:, :, 0, 0].t()
        assert torch.equal(ops[0], w1) and torch.equal(ops[1], blk.conv1.bias)
        # bf16: views of K-major storage, the tensor-core kernel's layout
        assert ops[0].t().is_contiguous() and ops[4].t().is_contiguous()
        assert ops[2].shape == (3, 3, 64, 64) and ops[2].permute(3, 0, 1, 2).is_contiguous()
        assert torch.equal(ops[2], blk.conv2.weight.permute(2, 3, 1, 0))
    enc.load_state_dict({k: v * 2 for k, v in enc.state_dict().items()})
    again = blk.fused_operands(torch.bfloat16)
    assert again is not ops and torch.equal(again[0], 2 * ops[0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_engine_int8_fused_blocks_switch(monkeypatch):
    """MMDX_INT8_FUSED_BLOCKS=1,2 is read when a turbo engine is built: 5
    fused blocks per classify, probabilities within the JAX turbo guard
    (0.05) of an unfused turbo engine on the same scales; fast mode ignores
    it and keeps the bf16 fused bottleneck off."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    cfg = dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, use_fused_bottleneck=True))
    tb = bridge.bundle_from_variables(bridge.random_state(cfg, 1), cfg)
    imgs = [np.random.default_rng(7).integers(0, 256, (70, 70, 3), dtype=np.uint8)]
    texts = ["62 year old male, cough"]
    base = InferenceEngine(tb, mode="turbo", device="cpu")
    monkeypatch.setenv("MMDX_INT8_FUSED_BLOCKS", "1,2")
    fused = InferenceEngine(tb, mode="turbo", device="cpu")
    fast = InferenceEngine(tb, mode="fast", device="cpu")
    monkeypatch.delenv("MMDX_INT8_FUSED_BLOCKS")
    assert base.int8_fused_blocks == () and fused.int8_fused_blocks == (1, 2)
    assert fast.int8_fused_blocks == ()
    ref, _, _ = base.classify_batch(imgs, texts)
    fused._qparams = base._qparams  # the same calibrated int8 tower
    calls = []
    original = ri.fused_bottleneck_int8
    monkeypatch.setattr(ri, "fused_bottleneck_int8",
                        lambda *a, **kw: calls.append(1) or original(*a, **kw))
    got, _, _ = fused.classify_batch(imgs, texts)
    assert len(calls) == 5
    assert np.abs(got - ref).max() < 0.05
    # fast mode folds, as the JAX engine does: the bf16 fused blocks stay off
    assert fast.model.image_encoder.config.use_folded_bn
    monkeypatch.setattr("mmdx_tpu_torch.models.resnet.fused_bottleneck",
                        lambda *a, **kw: calls.append("bf16"))
    probs, _, _ = fast.classify_batch(imgs, texts)
    assert "bf16" not in calls and np.isfinite(probs).all()
