"""mmdx_tpu_torch: the PyTorch + CUDA port of mmdx_tpu for one NVIDIA H100.

The package mirrors ``mmdx_tpu``'s layout (``models/``, ``ops/``, ``decode/``,
``runtime/``, ``checkpoints/``, ``pipelines/``, ``serve/``, ``text/``,
``io/``); each module's docstring names the JAX module it ports. It imports
torch and never jax, flax or any module of ``mmdx_tpu``: the framework-free
parts it needs (config, tokenizers, resize matrices, image decode,
micro-batcher, WSGI app, torch checkpoint import) are copies kept here. It
reads only data files of ``mmdx_tpu`` (the shipped vocabularies, the
frontend, the sample assets). The hand-written Hopper kernels live in
``csrc/`` and are built by ``_build.py`` at first use.
"""
