"""The port's fused preprocessing (Queue 2 row 17) against the JAX package,
on the CPU.

* the plain version of ``preprocess_batch_fused`` against the Pallas
  ``preprocess_batch_pallas`` in interpret mode, gray and RGB, at 1e-5;
* the kernel's banded sums (each row of the resize matrices summed over its
  nonzero band only, as ``csrc/preprocess.cu`` sums them), replayed in numpy
  f32 against the dense product;
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
    """The kernel's arithmetic in numpy: row pass over each kh row's band,
    column pass over each kw row's band, f32; the columns outside every kw
    band are never read. (100x90 upsamples: bands of two taps.)"""
    kh, kw, (hlo, hhi), (wlo, whi), scale, shift = pp._fused_consts(
        h, w, rs, crop, pp.IMAGENET_MEAN, pp.IMAGENET_STD)
    for k, (lo, hi) in ((kh, (hlo, hhi)), (kw, (wlo, whi))):
        inside = (np.arange(k.shape[1])[None, :] >= lo[:, None]) & \
            (np.arange(k.shape[1])[None, :] < hi[:, None])
        assert not k[~inside].any() and (hi - lo).max() < k.shape[1] // 2
    img = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.float32)
    w0, w1 = int(wlo.min()), int(whi.max())
    tmp = np.zeros((crop, w), np.float32)
    for r in range(crop):
        tmp[r, w0:w1] = kh[r, hlo[r]:hhi[r]] @ img[hlo[r]:hhi[r], w0:w1]
    out = np.stack([tmp[:, wlo[o]:whi[o]] @ kw[o, wlo[o]:whi[o]] for o in range(crop)], 1)
    dense = (kh @ img) @ kw.T
    np.testing.assert_allclose(out, dense, rtol=1e-5, atol=1e-3)


def test_fused_preprocess_wrapper_takes_the_plain_version_only_on_the_cpu():
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 40, 40, 3),
                                                              dtype=np.uint8))
    before = pp.preprocess_batch_fused.launches
    out = pp.preprocess_batch_fused(batch, img_size=32, resize_size=36, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pp.preprocess_batch_fused(batch.to("meta"), img_size=32, resize_size=36)
    assert pp.preprocess_batch_fused.launches == before
