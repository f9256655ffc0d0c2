"""Tree helpers over nested dicts (and lists or tuples) of numpy arrays or
tensors, and over an ``nn.Module``'s parameters.

Port of ``mmdx_tpu/utils/pytree.py`` without jax: dict keys are walked in
sorted order and None is no leaf, as ``jax.tree_util`` flattens a dict, so
``tree_paths`` lists the same paths in the same order for the same tree.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def count_params(tree) -> int:
    """Total number of elements across all leaves (a module: its
    parameters)."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(int(np.prod(x.shape)) for _, x in _leaves_with_path(tree)
               if hasattr(x, "shape"))


def tree_paths(tree) -> list[str]:
    """'/'-joined key paths of all leaves (a module: of its parameters)."""
    if isinstance(tree, torch.nn.Module):
        return [name.replace(".", "/") for name, _ in tree.named_parameters()]
    return ["/".join(str(p) for p in path) for path, _ in _leaves_with_path(tree)]


def cast_floating(tree, dtype=torch.bfloat16):
    """Cast floating-point leaves to ``dtype`` (e.g. bf16 serving weights):
    a tensor with ``.to`` (a numpy dtype as its torch counterpart); a numpy
    array to a numpy dtype with ``astype``,
    or to a torch dtype as a tensor (numpy has no bfloat16). A module casts
    its floating parameters and buffers in place and is returned."""
    if isinstance(tree, torch.nn.Module):
        return tree.to(dtype)

    as_torch = dtype if isinstance(dtype, torch.dtype) else \
        torch.from_numpy(np.empty(0, dtype)).dtype

    def cast(x):
        if isinstance(x, torch.Tensor):
            return x.to(as_torch) if x.is_floating_point() else x
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            if isinstance(dtype, torch.dtype):
                return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
            return x.astype(dtype)
        return x

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return cast(t)

    return walk(tree)
