"""Multi-device: a ("data", "model") DeviceMesh over ``torch.distributed``
ranks, the tensor-parallel sharding rules and the dp x tp joint train step.

Port of ``mmdx_tpu/parallel/`` in the PyTorch idiom: one process per rank
(SPMD), every rank building the same engine or model and making the same
calls, where the JAX package drives all devices from one process through
GSPMD. ``mesh.py`` makes the process group and the mesh, ``sharding.py``
holds the rules and the collectives of a tensor-parallel region, and
``train.py`` the joint train step.
"""
