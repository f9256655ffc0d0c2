"""The port's fused preprocessing (Queue 2 row 17) against the JAX package,
on the CPU.

* the plain version of ``preprocess_batch_fused`` against the Pallas
  ``preprocess_batch_pallas`` in interpret mode, gray and RGB, at 1e-5;
* the compact tap tables (``tap_tables``) rebuild the dense resize + crop
  matrices exactly; at the serving wire shape 256x256 they are one-hot;
* the kernel's two passes over those tables (``tap_sums``, in its order)
  against the dense product before the normalize, as the banded sums were
  held; with the normalize (``tap_walk``) against the Pallas kernel, f32
  at 1e-5 and bf16 within one bf16 ulp, 1 and 3 channels;
* the kernel's block plan (three blocks an SM, TRo), the device-constant
  caches, and the wrapper's refusals;
* the wrapper on a CPU tensor runs the plain version and counts no launch.

The JAX side runs under ``jax.jit``: eager ops dispatched while an
interpret-mode Pallas call is still running its host callbacks can
deadlock. Each test is held to 120 s by an alarm, and a watchdog ends a
worker blocked past 180 s, so that a hang fails one test.
"""
import faulthandler
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import preprocess as pp


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


@pytest.mark.parametrize("shape", [(2, 256, 256, 1), (2, 256, 256, 3), (2, 96, 80, 3)])
def test_fused_preprocess_plain_matches_pallas(shape):
    from mmdx_tpu.ops.pallas_preprocess import preprocess_batch_pallas

    batch = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    size, rs = (128, 144) if shape[1] == 256 else (48, 56)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda u: preprocess_batch_pallas(
            u, img_size=size, resize_size=rs))(jnp.asarray(batch)))
    got = pp.preprocess_batch_fused(torch.from_numpy(batch), img_size=size,
                                    resize_size=rs).numpy()
    assert got.shape == ref.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    dev = pp.preprocess_batch_device(torch.from_numpy(batch), img_size=size,
                                     resize_size=rs).numpy()
    np.testing.assert_allclose(got, dev, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,rs,crop", [(512, 512, 256, 224), (600, 480, 256, 224),
                                         (100, 90, 256, 224)])
def test_banded_sums_equal_the_dense_product(h, w, rs, crop):
    """The kernel's arithmetic in numpy (``tap_sums``: the row pass over each
    kh row's taps, the column pass over each kw row's taps, FMA chains in
    increasing tap order, f32) against the dense product, before the
    normalize; the columns outside every kw row's taps are never read.
    (100x90 upsamples: two taps a row.)"""
    th, tw = pp.tap_tables(h, w, rs, crop)
    kh, kw = pp.R.fused_resize_crop_matrices(h, w, rs, crop)
    for k, t in ((kh, th), (kw, tw)):
        assert t.coef.shape[1] < k.shape[1] // 2
    img = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.float32)
    got = pp.tap_sums(img.astype(np.uint8)[None, :, :, None], crop, rs)
    dense = (kh @ img) @ kw.T
    np.testing.assert_allclose(got[0, :, :, 0], dense, rtol=1e-5, atol=1e-3)


def test_fused_preprocess_wrapper_takes_the_plain_version_only_on_the_cpu():
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 40, 40, 3),
                                                              dtype=np.uint8))
    before = pp.preprocess_batch_fused.launches
    out = pp.preprocess_batch_fused(batch, img_size=32, resize_size=36, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pp.preprocess_batch_fused(batch.to("meta"), img_size=32, resize_size=36)
    assert pp.preprocess_batch_fused.launches == before


# ---------------------------------------------------------------------------
# the compact form of csrc/preprocess.cu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,w", [(512, 512), (256, 256), (600, 480), (100, 90)])
def test_tap_tables_rebuild_the_dense_matrices(h, w):
    th, tw = pp.tap_tables(h, w, 256, 224)
    kh, kw = pp.R.fused_resize_crop_matrices(h, w, 256, 224)
    for k, t in ((kh, th), (kw, tw)):
        assert t.start.dtype == np.int32 and t.coef.dtype == np.float32
        assert t.start.min() >= 0 and t.start.max() + t.coef.shape[1] <= k.shape[1]
        dense = np.zeros_like(k)
        np.put_along_axis(dense, t.start[:, None] + np.arange(t.coef.shape[1]), t.coef, 1)
        np.testing.assert_array_equal(dense, k)
    if (h, w) == (256, 256):  # the wire shape: a pure crop
        for t in (th, tw):
            assert t.coef.shape[1] == 1 and (t.coef == 1.0).all()
            np.testing.assert_array_equal(t.start, np.arange(224) + 16)


_PALLAS = {}


def _pallas(batch, size, rs, out_dtype):
    """``preprocess_batch_pallas`` in interpret mode under ``jax.jit``,
    once per input."""
    from mmdx_tpu.ops.pallas_preprocess import preprocess_batch_pallas

    key = (batch.shape, size, rs, out_dtype)
    if key not in _PALLAS:
        with pltpu.force_tpu_interpret_mode():
            _PALLAS[key] = np.asarray(jax.jit(lambda u: preprocess_batch_pallas(
                u, img_size=size, resize_size=rs, out_dtype=out_dtype))(
                    jnp.asarray(batch)).astype(jnp.float32))
    return _PALLAS[key]


@pytest.mark.parametrize("shape", [(2, 256, 256, 1), (2, 256, 256, 3), (2, 96, 80, 3)])
def test_tap_walk_matches_pallas(shape):
    batch = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    size, rs = (128, 144) if shape[1] == 256 else (48, 56)
    got = pp.tap_walk(batch, size, rs)
    assert got.dtype == np.float32 and got.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, _pallas(batch, size, rs, jnp.float32),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3])
def test_bf16_output_matches_pallas_within_one_ulp(channels):
    """``out_dtype`` bf16: the walk's f32 values rounded once to bf16 (the
    kernel's store) against the Pallas kernel's bf16 output, each within one
    bf16 ulp of it (2^-7 of its magnitude), or, for the few outputs near 0
    after ``x * scale - shift`` cancels, within the f32 comparison's 1e-5;
    the wrapper's plain version on the CPU is held to the same."""
    shape = (2, 256, 256, channels)
    batch = np.random.default_rng(7 + channels).integers(0, 256, shape, dtype=np.uint8)
    ref = _pallas(batch, 128, 144, jnp.bfloat16)
    limit = np.maximum(np.abs(ref) * 2.0 ** -7, 1e-5)
    got = torch.from_numpy(pp.tap_walk(batch, 128, 144)).to(torch.bfloat16)
    assert (np.abs(got.float().numpy() - ref) <= limit).all()
    assert (np.abs(got.float().numpy() - ref) <= np.abs(ref) * 2.0 ** -7).mean() > 0.999
    plain = pp.preprocess_batch_fused(torch.from_numpy(batch), 128, 144,
                                      out_dtype=torch.bfloat16)
    assert plain.dtype == torch.bfloat16
    assert (np.abs(plain.float().numpy() - ref) <= limit).all()


def test_device_constant_caches_return_the_same_tensors():
    dev = torch.device("cpu")
    first = pp.device_tables(dev, 512, 512, 256, 224)
    again = pp.device_tables(dev, 512, 512, 256, 224)
    assert all(a is b for a, b in zip(first, again))
    th, tw = pp.tap_tables(512, 512, 256, 224)
    np.testing.assert_array_equal(first[1].numpy(), th.coef)
    np.testing.assert_array_equal(first[2].numpy(), tw.start)
    kh = pp.dense_matrices(dev, 512, 512, 256, 224)
    assert all(a is b for a, b in zip(kh, pp.dense_matrices(dev, 512, 512, 256, 224)))
    assert pp._norm_consts(dev, pp.IMAGENET_MEAN, pp.IMAGENET_STD)[0] is \
        pp._norm_consts(dev, pp.IMAGENET_MEAN, pp.IMAGENET_STD)[0]


@pytest.mark.parametrize("b,h,w,c,out_bytes,tro,blocks", [
    (32, 512, 512, 3, 4, 4, 4), (32, 512, 512, 1, 4, 8, 3), (32, 512, 512, 3, 2, 4, 4),
    (32, 256, 256, 3, 4, 8, 3), (4, 256, 256, 1, 2, 2, 4), (4, 512, 512, 3, 4, 2, 4),
    (32, 600, 480, 3, 4, 4, 4)])
def test_block_plan_fits_its_blocks_an_sm(b, h, w, c, out_bytes, tro, blocks):
    """Of three and four blocks an SM, the one whose blocks fit the tallest
    bands, four on a tie; the grid fills the card."""
    plan = pp.preprocess_plan(b, h, w, c, 256, 224, out_bytes)
    th, tw = pp.tap_tables(h, w, 256, 224)
    w0, span = pp.slice_columns(tw)
    assert w0 % 4 == 0 and w0 <= tw.start.min() and w0 + span == tw.start.max() + \
        tw.coef.shape[1] <= w
    pitch = -(-span * c // 4) * 4
    bands = -(-224 // tro)
    assert (plan.tro, plan.blocks) == (tro, blocks)
    assert blocks * (plan.smem + 1024) <= 228 * 1024 and plan.smem <= pp.smem_per_block(blocks)
    assert plan.grid == min(b * bands, blocks * 132)
    assert plan.io_off % 16 == 0 and plan.io_off >= 4 * (plan.tro * pitch + 224 * (
        tw.coef.shape[1] + 1) + 2 * plan.tro * (th.coef.shape[1] + 1))
    # each of the two buffers holds a band's staged rows (misaligned start
    # and tail included) and later the band's output
    assert plan.io_bytes % 16 == 0 and plan.smem == plan.io_off + 2 * plan.io_bytes
    assert plan.io_bytes >= max(plan.rows_in * w * c + 30, plan.tro * 224 * 3 * out_bytes)
    starts = th.start
    assert plan.rows_in == max(int(starts[r:r + tro].max() - starts[r:r + tro].min())
                               + th.coef.shape[1] for r in range(0, 224, tro))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    batch = torch.zeros((1, 4096, 4096, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="taps a row"):
        pp.preprocess_batch_fused(batch)
    small = torch.zeros((1, 40, 40, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="img_size % 8"):
        pp.preprocess_batch_fused(small, img_size=36, resize_size=36)
    with pytest.raises(ValueError, match="out_dtype"):
        pp.preprocess_batch_fused(small, img_size=32, resize_size=36, out_dtype=torch.float16)
