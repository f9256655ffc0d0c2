"""The sharded end-to-end training step (dp x tp) of the whole model.

Port of ``mmdx_tpu/parallel/train.py`` (``:24-134``). The JAX package jits
one step over a ("data", "model") mesh and lets GSPMD insert the
collectives; here every rank runs the same step on its rows and its shard
(``models/diagnosis.JointTrainModel`` after ``sharding.shard_model_``), under the joint
loss BCE(disease) + CE(report), with the collectives written out:

* every mean the JAX step takes over the logical batch is taken over the
  whole batch across the data ranks: the BCE (the rank's sum over the
  batch's element count), the report CE (the rank's sum over the batch's
  count of valid labels, ``pipelines/losses.py``), and train-mode
  BatchNorm's statistics (sums and sums of squares by ``all_reduce`` over
  "data", flax's E[x^2] - E[x]^2, so every rank keeps the same running
  statistics);
* the gradients are summed over "data" by hand after the backward (each
  rank's loss already carries its share of the means, so nothing is scaled
  twice);
* the global-norm clip measures the whole logical model: the squares of
  sharded leaves are summed over "model", replicated leaves count once;
* four AdamW groups at the per-tower learning rates after the clip
  (``build_joint_optimizer``).

No hand-written kernel runs in training (none has a backward), as in the
single-device trainer. ``MMDX_TRAIN_DONATE`` is an XLA buffer-donation
switch and has no counterpart: the step updates the parameters in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mmdx_tpu_torch.checkpoints.train_bridge import joint_model, joint_vars_of
from mmdx_tpu_torch.models.layers import Dense, Dropout
from mmdx_tpu_torch.parallel.sharding import (all_reduce_, dense_specs, model_shard,
                                              port_shardings, shard_batch, shard_model_,
                                              unshard_variables)
from mmdx_tpu_torch.pipelines.losses import IGNORE_INDEX, bce_with_logits, t5_cross_entropy
from mmdx_tpu_torch.pipelines.training_pipeline import _adamw, clip_by_global_norm

F32 = torch.float32
CLIP_NORM = 1.0  # the global-norm clip before the update (JAX's clip_norm)


def build_joint_optimizer(model, lr_image: float = 1e-4, lr_text: float = 2e-5,
                          lr_heads: float = 5e-4, lr_t5: float = 2e-5,
                          weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """Per-tower learning rates (JAX ``build_joint_optimizer``): the image
    tower, the text tower, the T5 report model, and the rest of the fusion
    head; the step clips the global norm first."""
    groups = {"image": [], "text": [], "t5": [], "fusion_heads": []}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        if top == "image_encoder":
            groups["image"].append(p)
        elif top == "text_encoder":
            groups["text"].append(p)
        elif name.startswith("fusion.report_model."):
            groups["t5"].append(p)
        else:
            groups["fusion_heads"].append(p)
    lrs = {"image": lr_image, "text": lr_text, "t5": lr_t5, "fusion_heads": lr_heads}
    return _adamw([{"params": ps, "lr": lrs[k], "name": k} for k, ps in groups.items()],
                  weight_decay)


@dataclass
class TrainState:
    """The rank's shard of the model (on its device), its optimizer, the
    step count, and the layout of the whole tree (``port_shardings``) that
    ``variables`` needs to put the shards back together."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    specs: dict | None = None

    @classmethod
    def create(cls, variables: dict, config, mesh=None, device="cpu",
               dtype=F32) -> "TrainState":
        """From the whole JAX variable tree (numpy): the joint model, the
        rank's shard of it under ``mesh`` (None: one rank, whole), on
        ``device`` in ``dtype``, and ``build_joint_optimizer``."""
        model = joint_model(variables, config)
        specs = None
        if mesh is not None:
            from mmdx_tpu_torch.parallel.mesh import layout

            lay = layout(mesh)
            if lay.tp > 1:
                shard_model_(model, dense_specs(model, lay.tp), model_shard(mesh))
            if lay.dp > 1:
                model.image_encoder.sync_batch_stats_(lay.data_group)
            specs = port_shardings(variables, mesh)
        model = model.to(device=torch.device(device), dtype=dtype)
        return cls(step=0, model=model, optimizer=build_joint_optimizer(model),
                   specs=specs)

    def variables(self, mesh=None) -> dict:
        """The whole variable tree (numpy f32) on every rank."""
        local = joint_vars_of(self.model)
        return local if mesh is None else unshard_variables(local, self.specs, mesh)


def sharded_parameters(model) -> set[int]:
    """ids of the parameters each model rank holds a slice of: the kernel
    of every sharded ``Dense`` and the bias of a column-sharded one."""
    out = set()
    for mod in model.modules():
        if isinstance(mod, Dense) and mod.tp is not None:
            out.add(id(mod.kernel))
            if mod.tp[0] == "col" and mod.bias is not None:
                out.add(id(mod.bias))
    return out


def _generator(device, seed: int, data_rank: int) -> torch.Generator:
    """The step's dropout stream: one per (seed, data rank), the same on
    every model rank of a data rank (replicated activations draw the same
    masks)."""
    state = int(np.random.SeedSequence([int(seed), data_rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def make_sharded_train_step(mesh=None):
    """-> ``step(state, batch, seed) -> (state, loss)``: one joint step on
    the rank's rows (``batch`` is the whole batch, numpy, on every rank; its
    size must divide over the data ranks) and shard; ``loss`` is the whole
    batch's joint loss (a float), the same on every rank. ``mesh`` None is
    the single-rank step."""
    from mmdx_tpu_torch.parallel.mesh import layout

    lay = layout(mesh) if mesh is not None else None
    dp, data_rank = (lay.dp, lay.data_rank) if lay else (1, 0)
    data_group = lay.data_group if lay and lay.dp > 1 else None
    model_group = lay.model_group if lay and lay.tp > 1 else None

    def step(state: TrainState, batch: dict, seed: int):
        model, optim = state.model, state.optimizer
        cfg = model.config
        param = next(model.parameters())
        dev, dtype = param.device, param.dtype
        n = int(batch["images"].shape[0])
        if n % dp:
            raise ValueError(f"a joint train batch of {n} rows does not divide over "
                             f"{dp} data ranks")
        rows = shard_batch(batch, mesh) if lay else batch

        def tensor(k, dt=None):
            return torch.as_tensor(np.ascontiguousarray(rows[k])).to(dev, dt)

        gen = _generator(dev, seed, data_rank)
        out = model(tensor("images", dtype), tensor("input_ids", torch.long),
                    tensor("attention_mask", torch.long),
                    tensor("token_type_ids", torch.long) if "token_type_ids" in rows
                    else None, report_labels=tensor("report_labels", torch.long),
                    drop_text=Dropout(cfg.text.hidden_dropout, gen),
                    drop_fusion=Dropout(cfg.fusion.dropout, gen))
        targets = tensor("disease_targets")
        labels = batch["report_labels"]
        valid = torch.tensor(float(max((labels != IGNORE_INDEX).sum(), 1)), dtype=F32,
                             device=dev)
        loss = (bce_with_logits(out["disease_logits"], targets, count=targets.numel() * dp)
                + t5_cross_entropy(out["report_logits"], tensor("report_labels", torch.long),
                                   valid_count=valid))
        optim.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in optim.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if data_group is not None:  # one all_reduce of every gradient
            flat = all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]), data_group)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p.grad))
        clip_by_global_norm(params, CLIP_NORM, sharded_parameters(model), model_group)
        optim.step()
        total = loss.detach().clone()
        if data_group is not None:
            all_reduce_(total, data_group)
        state.step += 1
        return state, float(total)

    return step


def make_joint_batch(seed: int, config, batch: int, report_len: int = 16) -> dict:
    """A synthetic joint batch (numpy) from ``seed``: the same draws as the
    JAX ``make_joint_batch`` makes after turning its key into this seed
    (``int(jax.random.randint(rng, (), 0, 2**31 - 1))``)."""
    r = np.random.default_rng(int(seed))
    size, max_len = config.image.img_size, config.text.max_len
    return {
        "images": r.standard_normal((batch, size, size, 3)).astype(np.float32),
        "input_ids": r.integers(0, config.text.vocab_size, (batch, max_len)).astype(np.int32),
        "attention_mask": np.ones((batch, max_len), np.int32),
        "token_type_ids": np.zeros((batch, max_len), np.int32),
        "disease_targets": (r.random((batch, 13)) > 0.5).astype(np.float32),
        "report_labels": r.integers(1, config.report.vocab_size,
                                    (batch, report_len)).astype(np.int32),
    }
