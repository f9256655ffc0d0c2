"""mmdx_tpu_torch: the PyTorch + CUDA port of mmdx_tpu for one NVIDIA H100.

The package mirrors ``mmdx_tpu``'s layout (``models/``, ``ops/``, ``decode/``,
``runtime/``, ``checkpoints/``, ``pipelines/``, ``serve/``); each module's
docstring names the JAX module it ports. It imports torch and never jax or
flax, and reuses the framework-free parts of ``mmdx_tpu`` (config, tokenizers,
resize matrices, micro-batcher, WSGI app, torch checkpoint import) by
importing them. The hand-written Hopper kernels live in ``csrc/`` and are
built by ``_build.py`` at first use.
"""
