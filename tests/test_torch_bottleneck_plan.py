"""The fused bottlenecks' tensor-core kernel (rows 12, 13) on the CPU: its
plan, and a walk of its order against the plain versions and the Pallas
functions.

* the plan (``ops/bottleneck.tc_plan``, ``bottleneck_plan``) at every shape
  of the two routes (stage 1 block 0 with its projection, stage 1 identity,
  stage 2 identity; row 13's stage 1 and 2) at B = 1, 4, 32 and 512: band
  height, ring, cluster, grid and a block's shared memory within Hopper's
  232,448 bytes, in bf16, s8 and f32 (the CUDA-core body);
* the walk (``band_walk``): bands, the halo rows' conv1 with the
  out-of-image zero mask, the nine taps as row offsets into the a1 tile,
  passes of rows, column chunks and 64-byte K slices, as the card runs
  them: row 13 bit-equal to its plain version and to the Pallas function
  (interpret mode, under ``jax.jit``), row 12 within the Pallas tests'
  bf16 tolerance of its plain version and of the Pallas function;
  including a ragged last band (H = 28, TR = 8) and B = 1.

Each test is held to 120 s by an alarm, and a watchdog ends a worker
blocked past 180 s, so that a hang fails one test.
"""
import faulthandler
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import bottleneck as bn
from mmdx_tpu_torch.ops import int8_bottleneck as ib


@pytest.fixture(autouse=True)
def time_guard():
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


# (H = W, Cin, M, Cout, projection): the blocks each route fuses at 224x224
ROW12_SHAPES = [(56, 64, 64, 256, True), (56, 256, 64, 256, False),
                (28, 512, 128, 512, False)]
ROW13_SHAPES = [(56, 256, 64), (28, 512, 128)]
BATCHES = [1, 4, 32, 512]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", ROW12_SHAPES, ids=["s1-proj", "s1-identity", "s2-identity"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_row12_plan(dtype, shape, b):
    hw, cin, m, cout, proj = shape
    plan = bn.bottleneck_plan(b, hw, hw, cin, m, cout, dtype, proj)
    assert 1 <= plan.tr <= min(hw, bn.MAX_TR)
    assert plan.grid == (-(-hw // plan.tr), b) and plan.cluster == 1
    assert 0 < plan.smem <= bn.SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert plan.stages == bn.STAGES[2]
        assert plan.smem == bn.tc_smem_bytes(hw, m, cout, plan.tr, 2, proj)
        # no band height that fits costs less by the plan's own model
        best = min(bn.tc_cost(b, hw, hw, cin, m, cout, 2, proj, tr)
                   for tr in range(1, bn.MAX_TR + 1)
                   if bn.tc_smem_bytes(hw, m, cout, tr, 2, proj) <= bn.SMEM_LIMIT)
        assert bn.tc_cost(b, hw, hw, cin, m, cout, 2, proj, plan.tr) == best
    else:
        assert plan.stages == 0 and plan.tr == bn.band_rows(hw, hw, m, 4)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", ROW13_SHAPES, ids=["stage1", "stage2"])
def test_row13_plan(shape, b):
    hw, c, m = shape
    plan = bn.tc_plan(b, hw, hw, c, m, c, 1, False)
    assert 1 <= plan.tr <= bn.MAX_TR and plan.stages == bn.STAGES[1]
    assert plan.grid == (-(-hw // plan.tr), b) and plan.cluster == 1
    assert plan.smem == bn.tc_smem_bytes(hw, m, c, plan.tr, 1, False) <= bn.SMEM_LIMIT


def test_plan_at_full_batch_fills_the_card():
    """At B=32 each route's plan fills the 132 SMs at least once over."""
    for hw, cin, m, cout, proj in ROW12_SHAPES:
        plan = bn.tc_plan(32, hw, hw, cin, m, cout, 2, proj)
        assert plan.grid[0] * plan.grid[1] >= 128, (hw, cin, plan)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiples of 64"):
        bn.tc_plan(1, 16, 16, 32, 16, 32, 2, False)
    with pytest.raises(ValueError, match="Cin == Cout"):
        bn.tc_plan(1, 16, 16, 64, 64, 128, 2, False)
    with pytest.raises(ValueError, match="does not fit"):
        bn.tc_plan(1, 8, 512, 256, 256, 1024, 2, True)


# ---------------------------------------------------------------------------
# row 13: the walk, bit for bit
# ---------------------------------------------------------------------------
def _int8_args(rng, c, m):
    """tests/test_pallas_int8_bottleneck.py:_rand_args, as tensors; the
    weights are the transposed views of K-major storage, as
    ``fold_block_epilogues`` hands them out."""
    def i8(*s):
        return _t(rng.integers(-127, 128, s).astype(np.int8))

    def f(a):
        return _t(a.astype(np.float32))

    return dict(
        w1=i8(m, c).t(), k1=f(rng.random(m) * 0.01 + 1e-3), b1=f(rng.standard_normal(m) * 2),
        w2flat=i8(m, 9 * m).t(), k2=f(rng.random(m) * 0.002 + 1e-4),
        b2=f(rng.standard_normal(m) * 2), w3=i8(c, m).t(), k3=f(rng.random(c) * 0.01 + 1e-3),
        b3=f(rng.standard_normal(c) * 2), kx=0.7)


@pytest.mark.parametrize("b,h,w,c,m,tr", [
    (1, 28, 30, 128, 64, 8),    # ragged last band (28 = 3 x 8 + 4), two passes of conv1
    (2, 5, 4, 256, 128, None),  # M = 128: 128-column chunks; the plan's band
    (1, 3, 7, 64, 64, 2),       # B = 1, ragged, one-row last band
])
def test_int8_walk_matches_plain(b, h, w, c, m, tr):
    rng = np.random.default_rng(5)
    x = _t(rng.integers(-127, 128, (b, h, w, c)).astype(np.int8))
    args = _int8_args(rng, c, m)
    plan = None if tr is None else bn.BottleneckPlan(tr, bn.STAGES[1], 1, (-(-h // tr), b), 0)
    got = ib.band_walk_int8(x, **args, plan=plan)
    ref = ib.fused_bottleneck_int8_plain(x, **args)
    assert got.dtype == torch.int8 and got.shape == (b, h, w, c)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_int8_walk_matches_pallas():
    from mmdx_tpu.ops.pallas_int8_bottleneck import fused_bottleneck_int8, pad_wp, unpad_wp

    b, h, w, c, m, wp = 2, 6, 5, 128, 64, 32
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    args = _int8_args(rng, c, m)
    jargs = {k: jnp.asarray(v.contiguous().numpy()) if k != "kx" else np.float32(v)
             for k, v in args.items()}
    ref = np.asarray(jax.jit(lambda x, a: unpad_wp(fused_bottleneck_int8(
        pad_wp(x, wp), **a, height=h, width=w, wp=wp, g=1, interpret=True), h, w, wp))(
        jnp.asarray(x), jargs))
    plan = bn.BottleneckPlan(4, bn.STAGES[1], 1, (2, b), 0)  # a ragged band of 2 rows
    got = ib.band_walk_int8(_t(x), **args, plan=plan)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# row 12: the walk, within the bf16 tolerance
# ---------------------------------------------------------------------------
BF_TOL = 3e-2  # tests/test_pallas_bottleneck.py, bf16


def _bf_args(rng, cin, m, cout, proj):
    def r(*s, scale=0.1):
        return _t((rng.standard_normal(s) * scale).astype(np.float32))

    args = dict(w1=r(m, cin).to(torch.bfloat16).t(), b1=r(m),
                w2=bn.kmajor_hwio(r(m, 9 * m).to(torch.bfloat16), m), b2=r(m),
                w3=r(cout, m).to(torch.bfloat16).t(), b3=r(cout))
    if proj:
        args.update(wp=r(cout, cin).to(torch.bfloat16).t(), bp=r(cout))
    return args


@pytest.mark.parametrize("b,h,w,cin,m,cout,proj,tr", [
    (1, 28, 30, 64, 64, 128, True, 8),       # projection, ragged band, passes
    (2, 6, 5, 128, 128, 128, False, None),   # M = 128, the plan's band
    (1, 5, 9, 64, 64, 64, False, 2),         # B = 1, ragged
])
def test_bf16_walk_matches_plain(b, h, w, cin, m, cout, proj, tr):
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((b, h, w, cin)).astype(np.float32)).to(torch.bfloat16)
    args = _bf_args(rng, cin, m, cout, proj)
    plan = None if tr is None else bn.BottleneckPlan(tr, bn.STAGES[2], 1, (-(-h // tr), b), 0)
    got = bn.tc_walk(x, **args, plan=plan)
    ref = bn.fused_bottleneck_plain(x, **args)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=BF_TOL, atol=BF_TOL)


def test_bf16_walk_matches_pallas():
    from mmdx_tpu.ops.pallas_bottleneck import fused_bottleneck

    b, h, w, cin, m = 1, 6, 6, 64, 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    args = _bf_args(rng, cin, m, cin, True)
    jargs = {k: jnp.asarray(v.float().contiguous().numpy(),
                            jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
             for k, v in args.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x, a: fused_bottleneck(x, **a))(jnp.asarray(x, jnp.bfloat16), jargs)
    plan = bn.BottleneckPlan(4, bn.STAGES[2], 1, (2, b), 0)
    got = bn.tc_walk(_t(x).to(torch.bfloat16), **args, plan=plan)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=BF_TOL, atol=BF_TOL)
