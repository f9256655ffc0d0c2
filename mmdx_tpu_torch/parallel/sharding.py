"""Megatron-style tensor parallelism: the sharding rules and the
collectives of a tensor-parallel region.

Port of ``mmdx_tpu/parallel/sharding.py`` (``:24-92``). The JAX package
annotates shardings on the weight tree and lets GSPMD insert the
collectives; here the rank holds plain local tensors (the hand kernels take
plain tensors) and the modules call the collectives themselves:

* transformer FFN: ``wi`` column-sharded, ``wo`` row-sharded -> one
  all-reduce per FFN over "model";
* attention q/k/v column-sharded by heads, the output projection
  row-sharded -> one all-reduce per attention block;
* the fusion MLP's and the conditioning projection's kernels
  column-sharded, their outputs put together by ``gather_columns``;
* embeddings, norms, the other biases, small heads, conv towers:
  replicated;
* batches: the leading axis split over "data" (``shard_batch``).

A column-sharded kernel's bias is sliced with it (``port_shardings``); a
row-sharded kernel's bias is added once, after the reduce. ``shard_model_``
applies the same specs to a port model's ``Dense`` modules, found by their
JAX paths (``dense_kernels``). A sharded axis
whose size the model degree does not divide falls back to replication, as
in JAX (``:59-72``).

Every collective is an ``all_reduce`` (gloo runs no other on CUDA tensors
besides ``broadcast``): a gather writes the rank's columns into a
zero-filled buffer and sums it over the group.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from mmdx_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Spec = tuple  # axis name (or None) per dimension; () = replicated

# (path regex, spec) — first match wins; paths are "/"-joined key paths like
# "params/text_encoder/bert/layer0/ffn_in/kernel" (the JAX tree's)
_RULES: list[tuple[str, Spec]] = [
    # BERT / generic attention projections
    (r"attn_[qkv]/kernel$", (None, MODEL_AXIS)),
    (r"attn_out/kernel$", (MODEL_AXIS, None)),
    (r"ffn_in/kernel$", (None, MODEL_AXIS)),
    (r"ffn_out/kernel$", (MODEL_AXIS, None)),
    # T5 attention + FFN
    (r"(self_attn|cross_attn)/[qkv]/kernel$", (None, MODEL_AXIS)),
    (r"(self_attn|cross_attn)/o/kernel$", (MODEL_AXIS, None)),
    (r"ffn_wi/kernel$", (None, MODEL_AXIS)),
    (r"ffn_wo/kernel$", (MODEL_AXIS, None)),
    # fusion MLP / conditioning projection
    (r"fusion/fuse_dense/kernel$", (None, MODEL_AXIS)),
    (r"fusion/cond_proj/kernel$", (None, MODEL_AXIS)),
    (r"cond_proj/kernel$", (None, MODEL_AXIS)),
    (r"fuse_dense/kernel$", (None, MODEL_AXIS)),
]


def spec_for_path(path: str) -> Spec:
    """Match the rules against the tail of a '/'-joined key path (with or
    without a leading 'params/')."""
    for pattern, spec in _RULES:
        if re.search(r"(^|/)" + pattern, path):
            return spec
    return ()  # replicate


def _walk(tree: dict, fn, path: str = ""):
    """Map ``fn(path, leaf)`` over a nested dict, keeping its structure."""
    return {k: (_walk(v, fn, f"{path}/{k}" if path else k) if isinstance(v, dict)
                else fn(f"{path}/{k}" if path else k, v)) for k, v in tree.items()}


def fits(spec: Spec, shape, sizes: dict) -> bool:
    """Every sharded axis divides evenly over its mesh axis."""
    return all(axis is None or shape[d] % sizes[axis] == 0 for d, axis in enumerate(spec))


def leaf_spec(path: str, shape, sizes: dict) -> Spec:
    """The spec of one leaf: the rule's, or () where a sharded axis does not
    divide its mesh axis (JAX ``:59-72``)."""
    spec = spec_for_path(path)
    return spec if fits(spec, shape, sizes) else ()


def variable_shardings(variables: dict, mesh) -> dict:
    """The spec of each leaf of a variables tree (JAX's ``variable_shardings``
    with specs for NamedShardings). ``mesh`` is the DeviceMesh or its sizes,
    {"data": dp, "model": tp}."""
    sizes = mesh if isinstance(mesh, dict) else _mesh_sizes(mesh)[0]
    return _walk(variables, lambda path, leaf: leaf_spec(path, np.shape(leaf), sizes))


def dense_kernels(model) -> dict:
    """Each ``Dense`` of a port model (``DiagnosisModel``,
    ``JointTrainModel``) by its kernel's path in the JAX tree, the names
    ``checkpoints/train_bridge.py`` maps ("bert.layers.0" is "bert/layer0",
    "decoder_layers.1" is "decoder_layer1"); the merged ``attn_qkv`` goes by
    its q's path, whose rule and width k and v share."""
    from mmdx_tpu_torch.models.layers import Dense

    return {re.sub(r"layers\.(\d+)", r"layer\1", name).replace(".", "/")
            .replace("attn_qkv", "attn_q") + "/kernel": mod
            for name, mod in model.named_modules() if isinstance(mod, Dense)}


def dense_specs(model, tp: int) -> dict:
    """``leaf_spec`` of each kernel of ``dense_kernels(model)`` at model
    degree ``tp``, over the JAX tree's shapes (a merged kernel's block)."""
    sizes = {DATA_AXIS: 1, MODEL_AXIS: tp}
    return {path: leaf_spec(path, (d.kernel.shape[0], d.kernel.shape[1] // d.blocks), sizes)
            for path, d in dense_kernels(model).items()}


def shard_model_(model, specs: dict, shard: "ModelShard"):
    """Keep this model rank's part of each ``Dense`` of ``model`` whose
    kernel's spec in ``specs`` (JAX path -> spec, as ``dense_specs``) is
    sharded: (None, "model") its columns, ("model", None) its rows; a path
    absent or () stays whole. The one place the rules reach the modules."""
    for path, dense in dense_kernels(model).items():
        spec = specs.get(path, ())
        if spec:
            dense.shard_(shard, "col" if spec == (None, MODEL_AXIS) else "row")
    return model


def port_shardings(variables: dict, mesh) -> dict:
    """``variable_shardings`` as the port holds the tree: the bias of a
    column-sharded kernel is sliced with its columns (JAX replicates it
    and GSPMD slices it in the program)."""
    specs = variable_shardings(variables, mesh)

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node.get("kernel") == (None, MODEL_AXIS) and "bias" in node:
            node["bias"] = (MODEL_AXIS,)
        return node

    return fix(specs)


def _local(leaf, spec: Spec, sizes: dict, ranks: dict):
    for d, axis in enumerate(spec):
        if axis is not None:
            per = leaf.shape[d] // sizes[axis]
            index = [slice(None)] * leaf.ndim
            index[d] = slice(ranks[axis] * per, (ranks[axis] + 1) * per)
            leaf = leaf[tuple(index)]
    return leaf


def _mesh_sizes(mesh) -> tuple[dict, dict]:
    from mmdx_tpu_torch.parallel.mesh import layout

    lay = layout(mesh)
    return ({DATA_AXIS: lay.dp, MODEL_AXIS: lay.tp},
            {DATA_AXIS: lay.data_rank, MODEL_AXIS: lay.model_rank})


def shard_variables(variables: dict, mesh) -> dict:
    """The rank's slice of each numpy leaf of a JAX-path variables tree,
    by ``port_shardings``."""
    sizes, ranks = _mesh_sizes(mesh)
    specs = port_shardings(variables, sizes)
    flat_specs = {}
    _walk(specs, lambda p, s: flat_specs.__setitem__(p, s))
    return _walk(variables, lambda p, leaf: np.ascontiguousarray(
        _local(np.asarray(leaf), flat_specs[p], sizes, ranks)))


def unshard_variables(local: dict, specs: dict, mesh) -> dict:
    """The whole tree on every rank from the ranks' slices: each sharded
    leaf is written at the rank's offset into a zero-filled buffer and
    summed over "model" by ``all_reduce``. ``specs`` is ``port_shardings``
    of the whole tree (the slices alone cannot tell a split leaf from a
    replicated one)."""
    from mmdx_tpu_torch.parallel.mesh import layout

    lay = layout(mesh)
    flat_specs = {}
    _walk(specs, lambda p, s: flat_specs.__setitem__(p, s))

    def one(path, leaf):
        spec = flat_specs[path]
        leaf = np.asarray(leaf)
        if MODEL_AXIS not in spec or lay.tp == 1:
            return leaf
        d = spec.index(MODEL_AXIS)
        shape = list(leaf.shape)
        shape[d] *= lay.tp
        full = torch.zeros(shape, dtype=torch.float64 if leaf.dtype == np.float64
                           else torch.float32)
        index = [slice(None)] * leaf.ndim
        index[d] = slice(lay.model_rank * leaf.shape[d], (lay.model_rank + 1) * leaf.shape[d])
        full[tuple(index)] = torch.from_numpy(np.ascontiguousarray(leaf)).to(full.dtype)
        dist.all_reduce(full, group=lay.model_group)
        return full.numpy().astype(leaf.dtype)

    return _walk(local, one)


def shard_batch(batch: dict, mesh) -> dict:
    """Pad each array to a multiple of the data degree by repeating row 0
    (as the JAX engine pads, ``runtime/engine.py:197-213``), then the rank's
    rows."""
    from mmdx_tpu_torch.parallel.mesh import layout, rows_of

    lay = layout(mesh)

    def one(a):
        a = np.asarray(a)
        padded, rows = rows_of(a.shape[0], lay.dp, lay.data_rank)
        if padded > a.shape[0]:
            a = np.concatenate([a, np.repeat(a[:1], padded - a.shape[0], axis=0)])
        return np.ascontiguousarray(a[rows])

    return {k: one(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the collectives of a tensor-parallel region
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelShard:
    """What a sharded module needs of the mesh: the "model" group, the
    rank's index in it and its size."""

    group: object
    rank: int
    size: int

    def cols(self, n: int, offset: int = 0) -> torch.Tensor:
        """The indices of the rank's equal share of ``n`` columns."""
        per = n // self.size
        return torch.arange(offset + self.rank * per, offset + (self.rank + 1) * per)


def model_shard(mesh) -> ModelShard:
    from mmdx_tpu_torch.parallel.mesh import layout

    lay = layout(mesh)
    return ModelShard(lay.model_group, lay.model_rank, lay.tp)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t``; bf16 and f16 travel as f32 (exact
    for the zero-filled gathers, and gloo's sums are then f32)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, op=op, group=group)
        return t.copy_(wide)
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """Forward identity, backward ``all_reduce`` over "model": the input of
    a column-parallel product, whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward ``all_reduce`` over "model", backward identity: the partial
    sums of a row-parallel product."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOver(torch.autograd.Function):
    """Forward and backward ``all_reduce``: a sum over the batch rows of
    every rank of ``group`` (BatchNorm's statistics over "data"), whose
    gradient reaches each rank's rows from every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """The rank's columns (last dim) into a zero-filled buffer, summed over
    "model"; backward takes the rank's columns of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, shard: ModelShard):
        n = x.shape[-1]
        ctx.cols = slice(shard.rank * n, (shard.rank + 1) * n)
        full = x.new_zeros(*x.shape[:-1], n * shard.size)
        full[..., ctx.cols] = x
        return all_reduce_(full, shard.group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _ReduceFromModel.apply(x, shard.group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def gather_columns(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A column-sharded product with no row partner (fusion's ``fuse_dense``
    and ``cond_proj``) put together on every model rank."""
    return _GatherColumns.apply(x, shard)


def gather_rows(x: torch.Tensor, n: int, rows: slice, group) -> torch.Tensor:
    """The rows ``rows`` of an ``n``-row batch that this data rank holds ->
    the whole batch on every rank of ``group`` (a zero-filled buffer summed
    by ``all_reduce``)."""
    full = x.new_zeros((n,) + tuple(x.shape[1:]))
    full[rows] = x
    return all_reduce_(full, group)
