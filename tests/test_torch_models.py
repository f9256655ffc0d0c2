"""The port's models and decode pieces against their JAX counterparts.

Small widths (those of ``new_random_bundle(small=True)``), one seeded numpy
weight tree given to both packages (the JAX modules take it as their
variables, the port through ``variables_to_torch``), the same numpy-seeded
inputs; f32 on both sides.
Tolerances: 1e-5 where both sides run the same f32 ops in another order;
1e-4 for the ResNet tower, whose 53 convolutions sum in different orders in
XLA and in PyTorch; exact for integer outputs (buckets, ban masks).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmdx_tpu_torch.checkpoints.bridge import (random_state, small_config,
                                               variables_to_torch)


@pytest.fixture(scope="module")
def small():
    config = small_config()
    variables = random_state(config, seed=0)
    return config, variables, variables_to_torch(variables, config)


def test_resnet_folded_matches_jax(small):
    from mmdx_tpu.models.resnet import ImageEncoder

    config, variables, model = small
    cfg = dataclasses.replace(config.image, use_folded_bn=True)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = ImageEncoder(config=cfg).apply(
        {"params": variables["params"]["image_encoder"],
         "batch_stats": variables["batch_stats"]["image_encoder"]},
        jnp.asarray(x), method=ImageEncoder.encode)
    got = model.image_encoder.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernels", [False, True])
def test_bert_tower_matches_jax(small, kernels):
    """kernels=True takes the kernel wrappers, which run the plain versions
    for CPU tensors."""
    from mmdx_tpu.models.bert import TextEncoder

    config, variables, model = small
    cfg = config.text
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[1, 9:] = 0
    tt = np.zeros_like(ids)
    ref = TextEncoder(config=cfg).apply(
        {"params": variables["params"]["text_encoder"]}, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(tt), method=TextEncoder.encode)
    got = model.text_encoder.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                                    torch.from_numpy(tt), kernels=kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_decode_step_beam_matches_jax(small, kernels):
    """Three beam decode steps over the ancestry cache. kernels=False: cache
    write then full attention (JAX parity path); kernels=True: deferred
    writes, partials over the old cache composed with the own token."""
    from mmdx_tpu.models.diagnosis import MultiModalDiagnosisModel

    cfg, variables, model = small
    b, nb, lmax = 2, 4, 6
    rng = np.random.default_rng(2)
    zi = rng.standard_normal((b * nb, cfg.fusion.d_img)).astype(np.float32)
    zt = rng.standard_normal((b * nb, cfg.fusion.d_txt)).astype(np.float32)
    anc = rng.integers(0, nb, (b, nb, lmax)).astype(np.int32)
    jm = MultiModalDiagnosisModel(config=cfg)
    prep = jm.apply(variables, jnp.asarray(zi), jnp.asarray(zt), lmax, nb,
                    method=MultiModalDiagnosisModel.prepare_generation)
    tprep = model.prepare_generation(torch.from_numpy(zi), torch.from_numpy(zt), lmax, nb)
    np.testing.assert_array_equal(tprep["self_bias"].numpy(), np.asarray(prep["self_bias"]))
    jcache = prep["cache"]
    for pos in range(3):
        tokens = rng.integers(0, cfg.report.vocab_size, (b * nb,))
        ref, jcache = jm.apply(
            variables, jnp.asarray(tokens[:, None], jnp.int32), pos, jcache,
            jnp.asarray(anc), prep["static_kv"], prep["self_bias"], prep["enc_mask"],
            method=MultiModalDiagnosisModel.decode_step_beam)
        got = model.decode_step_beam(
            torch.from_numpy(tokens), pos, tprep["cache"], torch.from_numpy(anc).long(),
            tprep["static_kv"], tprep["self_bias"], tprep["enc_mask"], kernels=kernels)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for jc, tc in zip(jcache, tprep["cache"]):
        np.testing.assert_allclose(tc["kv"].numpy(), np.asarray(jc["kv"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_relative_position_bucket_matches_jax(bidirectional):
    from mmdx_tpu.models.t5 import relative_position_bucket as jax_bucket
    from mmdx_tpu_torch.models.t5 import relative_position_bucket

    rel = np.arange(-300, 300)
    ref = jax_bucket(jnp.asarray(rel, jnp.int32), bidirectional, 32, 128)
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cur", [1, 2, 3, 9, 20])
def test_banned_ngram_mask_matches_jax(cur):
    from mmdx_tpu.decode.ngram import banned_ngram_mask as jax_ban
    from mmdx_tpu_torch.decode.ngram import banned_ngram_mask

    seqs = np.random.default_rng(cur).integers(0, 6, (5, 20))  # repeats on purpose
    ref = jax_ban(jnp.asarray(seqs, jnp.int32), jnp.asarray(cur, jnp.int32), 13, 3)
    got = banned_ngram_mask(torch.from_numpy(seqs), cur, 13, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("channels", [1, 3])
def test_preprocess_matches_jax(channels):
    from mmdx_tpu.ops.preprocess import preprocess_batch_device as jax_dev
    from mmdx_tpu.ops.preprocess import preprocess_exact as jax_exact
    from mmdx_tpu_torch.ops.preprocess import preprocess_batch_device, preprocess_exact

    imgs = np.random.default_rng(channels).integers(0, 256, (2, 80, 96, channels),
                                                    dtype=np.uint8)
    ref = jax_dev(jnp.asarray(imgs), 64, 72)
    got = preprocess_batch_device(torch.from_numpy(imgs), 64, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(preprocess_exact(imgs[0], 64, 72),
                                  jax_exact(imgs[0], 64, 72))
