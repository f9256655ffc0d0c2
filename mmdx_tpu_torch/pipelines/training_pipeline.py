"""Training pipeline: two-phase tower fine-tuning, fusion training on frozen
embeddings, evaluation, int8 calibration and publication.

Port of ``mmdx_tpu/pipelines/training_pipeline.py`` with PyTorch autograd:

  JAX (optax, flax)                       -> here
  ------------------------------------------------------------------------
  optax.multi_transform, set_to_zero on   -> one torch.optim.AdamW per
  the frozen backbone (:54-70)               phase; the frozen backbone runs
                                             under no_grad and is in no
                                             parameter group (no update, no
                                             decay)
  adamw per label group (:47-51, :73-82)  -> AdamW parameter groups (b1 0.9,
                                             b2 0.999, eps 1e-8, decay on
                                             every parameter of a group)
  optax.clip_by_global_norm(1.0)          -> ``clip_by_global_norm``, optax's
                                             form: g * (max / norm) only when
                                             norm >= max
  train=False / True BatchNorm            -> models/resnet_train.py (flax's
                                             running-statistics update)
  dropout rngs                            -> one seeded torch.Generator
  orbax resume (:369-394)                 -> checkpoints/train_state.py

The steps run plain PyTorch ops with cuBLAS and cuDNN: no TPU kernel lies on
the JAX training path (every ``use_fused_*`` and flash flag is off there),
so no hand-written kernel runs here, and none has a backward.
``compute_dtype="bfloat16"`` is bf16 compute over f32 master weights
(``torch.autocast``, no loss scaling). ``enable_compile_cache()`` is not
ported: it caches XLA programs only.

Everything after the feature-store read works on plain columns (``Rows``:
lists and numpy arrays), not on pandas frames: ``run_training_pipeline``
reads the feature store (pandas, parquet) and hands its rows to
``train_on_rows``, which a caller without pandas can drive from
``data_prep.prepared_rows`` directly. Sampling follows pandas'
``DataFrame.sample`` (``RandomState(seed).choice`` without replacement),
so both entries see the rows in the JAX package's order.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from mmdx_tpu_torch.checkpoints.bundle import (ModelBundle, assemble_variables,
                                               new_random_bundle, split_variables)
from mmdx_tpu_torch.checkpoints.train_bridge import (fusion_head, fusion_vars_of,
                                                     image_tower, image_vars_of,
                                                     text_tower, text_vars_of)
from mmdx_tpu_torch.models.layers import Dropout
from mmdx_tpu_torch.pipelines.losses import IGNORE_INDEX, bce_with_logits, fusion_loss

Rows = dict  # column name -> list (or array) of per-row values
COLUMNS = ("image_url", "patient_details", "disease_classification_vector", "report")


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _adamw(groups: list[dict], weight_decay: float) -> torch.optim.AdamW:
    """torch.optim.AdamW with the torch defaults optax's adamw is given
    (``_adamw``, ``:47-51``); decoupled decay on every parameter."""
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _params_under(module: torch.nn.Module, top: set[str], inside: bool) -> list:
    """Parameters whose top-level name is (``inside``) or is not in ``top``."""
    return [p for name, p in module.named_parameters()
            if (name.split(".", 1)[0] in top) == inside]


def build_encoder_optimizer(tower: torch.nn.Module, backbone_key: str, phase: int,
                            lr_backbone: float = 1e-4, lr_head: float = 5e-4,
                            weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """Phase 1 trains the heads only (the backbone gets no update and no
    decay, as ``optax.set_to_zero``); phase 2 adds the backbone at its own
    learning rate (``:54-70``)."""
    groups = [{"params": _params_under(tower, {backbone_key}, False), "lr": lr_head}]
    if phase != 1:
        groups.append({"params": _params_under(tower, {backbone_key}, True),
                       "lr": lr_backbone})
    return _adamw(groups, weight_decay)


def build_fusion_optimizer(model: torch.nn.Module, lr_heads: float = 5e-4,
                           lr_t5: float = 2e-5,
                           weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """The ``t5`` (report model) and ``heads`` groups (``:73-82``); the
    caller clips the global norm first (``clip_by_global_norm``)."""
    return _adamw([
        {"params": _params_under(model, {"report_model"}, True), "lr": lr_t5},
        {"params": _params_under(model, {"report_model"}, False), "lr": lr_heads},
    ], weight_decay)


def clip_by_global_norm(params: list, max_norm: float, sharded=frozenset(),
                        group=None) -> torch.Tensor:
    """optax.clip_by_global_norm: when the global norm of the gradients is
    at least ``max_norm``, every gradient becomes g / norm * max_norm (not
    ``clip_grad_norm_``'s max / (norm + 1e-6)). Under tensor parallelism
    ``sharded`` holds the ids of the parameters each model rank holds a
    slice of: their squares are summed over ``group`` ("model") and the
    replicated ones count once, so the norm is the whole logical model's.
    -> the norm before."""
    wide = torch.promote_types(params[0].grad.dtype, torch.float32)
    norm2 = sum((p.grad.to(wide) ** 2).sum() for p in params if id(p) not in sharded)
    if sharded:
        from mmdx_tpu_torch.parallel.sharding import all_reduce_

        part = sum((p.grad.to(wide) ** 2).sum() for p in params if id(p) in sharded)
        norm2 = norm2 + (part if group is None else all_reduce_(part.clone(), group))
    norm = torch.sqrt(norm2)
    clip = norm >= max_norm
    for p in params:
        p.grad.copy_(torch.where(clip, p.grad / norm.to(p.grad.dtype) * max_norm, p.grad))
    return norm


def optimizer_step(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                   clip_norm: float | None = None) -> None:
    """Backward, the optional global-norm clip, one update. A parameter of a
    group that got no gradient gets a zero one, so it decays and counts its
    step as under optax (a JAX gradient is never absent: the BERT pooler's
    is zero)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip_norm:
        clip_by_global_norm(params, clip_norm)
    optimizer.step()


# ---------------------------------------------------------------------------
# losses of one step (the JAX steps' loss_fn)
# ---------------------------------------------------------------------------
def image_loss(tower, phase: int, images, labels) -> torch.Tensor:
    """``image_train_step``'s loss (``:113-145``): phase 1 the frozen
    backbone in eval mode under no_grad, then the heads; phase 2 the whole
    tower in train mode (batch statistics, running statistics updated)."""
    if phase == 1:
        with torch.no_grad():
            feats = tower.backbone_features(images, train=False)
        out = tower.heads(feats)
    else:
        out = tower(images, train=True)
    return bce_with_logits(out["logits"], labels)


def text_loss(tower, phase: int, input_ids, attention_mask, token_type_ids, labels,
              drop=None) -> torch.Tensor:
    """``text_train_step``'s loss (``:151-176``): phase 1 the frozen encoder
    without dropout under no_grad, then the heads; phase 2 the whole tower,
    with ``drop`` (dropout) when given."""
    if phase == 1:
        with torch.no_grad():
            pooled = tower.backbone_pooled(input_ids, attention_mask, token_type_ids)
        out = tower.heads(pooled)
    else:
        out = tower.encode_train(input_ids, attention_mask, token_type_ids, drop)
    return bce_with_logits(out["logits"], labels)


def fusion_step_loss(model, z_img, z_txt, disease_targets, report_labels, drop=None):
    """``fusion_train_step``'s loss (``:182-196``) -> (total, {"cls", "gen"})."""
    out = model(z_img, z_txt, report_labels=report_labels, drop=drop)
    return fusion_loss(out["disease_logits"], disease_targets,
                       out.get("report_logits"), report_labels)


# ---------------------------------------------------------------------------
# the end-to-end pipeline
# ---------------------------------------------------------------------------
@dataclass
class TrainingOptions:
    image_phase1_steps: int = 1
    image_phase2_steps: int = 1
    text_steps_per_phase: int = 3
    fusion_steps: int = 300
    fusion_batch: int = 10
    image_batch: int = 32
    lr_head: float = 5e-4
    lr_backbone: float = 1e-4
    lr_text_enc: float = 2e-5
    lr_t5: float = 2e-5
    weight_decay: float = 1e-2
    seed: int = 0
    val_fraction: float = 0.2
    # "bfloat16": bf16 compute over f32 master weights (autocast), no loss
    # scaling
    compute_dtype: str = "float32"
    log_every: int = 25
    publish_model_name: str = "fusion_model_T5"
    log: Callable[[str], None] = field(default=print)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    local_bundle_path: str | None = None
    save_local_bundle: bool = True
    calibrate_int8: bool = True
    calibrate_images: int = 32
    # a dict to collect {phase: [wall ms, ...]} per train step
    step_times: dict | None = None


def rows_from_frame(df) -> Rows:
    """The feature store's frame -> plain columns, in the frame's order."""
    return {c: df[c].tolist() for c in COLUMNS}


def take_rows(rows: Rows, idx) -> Rows:
    return {k: [v[int(i)] for i in idx] for k, v in rows.items()}


def sample_rows(rows: Rows, n: int, seed: int) -> Rows:
    """``DataFrame.sample(n=min(n, len), random_state=seed)``'s rows."""
    size = len(rows["image_url"])
    return take_rows(rows, np.random.RandomState(seed).choice(size, size=min(n, size),
                                                               replace=False))


def _labels(rows: Rows) -> np.ndarray:
    return np.stack([np.asarray(v, np.float32)
                     for v in rows["disease_classification_vector"]])


class _Prep:
    """The parity engine's host input prep (``prep_images``, ``prep_texts``,
    the report tokenizer) without building a model."""

    def __init__(self, bundle):
        self.config = bundle.config
        self.bert_tok, self.t5_tok = bundle.tokenizers()

    def images(self, blobs) -> np.ndarray:
        from mmdx_tpu_torch.ops.preprocess import preprocess_exact
        from mmdx_tpu_torch.runtime.engine import InferenceEngine

        c = self.config.image
        return np.stack([preprocess_exact(a, c.img_size, c.resize_size, c.mean, c.std)
                         for a in InferenceEngine._decode(blobs)])

    def texts(self, texts: list[str]) -> dict:
        return self.bert_tok.encode_batch(texts, max_len=self.config.text.max_len)


def _fetch_training_batch(rows: Rows, prep: _Prep, n: int, seed: int,
                          images: bool = True):
    """Sample rows, fetch + preprocess images, tokenize texts and reports
    (``:242-259``) -> (rows, images or None, tokens, labels, report labels)."""
    from mmdx_tpu_torch.io.store import open_url

    rows = sample_rows(rows, n, seed)
    imgs = prep.images([open_url(u) for u in rows["image_url"]]) if images else None
    tok = prep.texts([str(t) for t in rows["patient_details"]])
    rep = prep.t5_tok.encode_batch([str(r) for r in rows["report"]],
                                   max_length=prep.config.report.max_report_len)
    report_labels = np.where(rep["attention_mask"] == 0, IGNORE_INDEX, rep["input_ids"])
    return rows, imgs, tok, _labels(rows), report_labels.astype(np.int64)


class _StepClock:
    """Each train step inside a ``torch.profiler.record_function`` range
    named ``train_step/<phase>``, by which a profiler around the run can
    attribute device work to steps; with ``options.step_times`` set, also
    the step's wall time, synchronized on a card, into that dict."""

    def __init__(self, times: dict | None, device: torch.device):
        self.times, self.cuda = times, device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, key: str):
        with torch.profiler.record_function(f"train_step/{key}"):
            if self.times is None:
                yield
                return
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            self.times.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)


def run_training_pipeline(feature_store, registry, bundle: ModelBundle | None = None,
                          options: TrainingOptions | None = None, device=None) -> dict:
    """Full training run from the feature store: returns {bundle, version,
    metrics, losses, reports}. ``device`` None is the first CUDA card."""
    from mmdx_tpu_torch.pipelines.feature_pipeline import (
        load_features_labels_from_feature_store)

    (options or TrainingOptions()).log("[mmdx] loading features from feature store")
    df = load_features_labels_from_feature_store(feature_store)
    return train_on_rows(rows_from_frame(df), registry, bundle, options, device)


def train_on_rows(rows: Rows, registry, bundle: ModelBundle | None = None,
                  options: TrainingOptions | None = None, device=None) -> dict:
    """The pipeline after the feature-store read (``:262-484``), on plain
    columns in the feature store's order."""
    from mmdx_tpu_torch.runtime.engine import resolve_device

    opt = options or TrainingOptions()
    log = opt.log
    device = resolve_device(device)
    bundle = bundle or new_random_bundle(seed=opt.seed)
    cfg = bundle.config
    prep = _Prep(bundle)
    clock = _StepClock(opt.step_times, device)
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    bf16 = opt.compute_dtype in ("bfloat16", "bf16")

    def autocast():
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    # held-out split: a deterministic shuffle, the last val_fraction rows
    # never trained on (too small a dataset evaluates on the train set)
    n_rows = len(rows["image_url"])
    shuffled = sample_rows(rows, n_rows, opt.seed)
    n_val = int(n_rows * opt.val_fraction) if n_rows >= 5 else 0
    val_rows = take_rows(shuffled, range(n_rows - n_val, n_rows))
    train_rows = take_rows(shuffled, range(n_rows - n_val))
    log(f"[mmdx] split: {n_rows - n_val} train / {n_val} val rows")

    image_vars, text_vars, fusion_vars = split_variables(bundle.variables)
    losses: dict[str, list[float]] = {}

    # ---- image tower, two phases, fed by the prefetching DataLoader ----
    from mmdx_tpu_torch.pipelines.dataloader import CXRImageDataset, DataLoader

    dataset = CXRImageDataset(
        image_urls=list(train_rows["image_url"]),
        labels=[np.asarray(v, np.float32) for v in train_rows["disease_classification_vector"]],
        img_size=cfg.image.img_size, resize_size=cfg.image.resize_size)
    loader = DataLoader(dataset, batch_size=min(opt.image_batch, len(dataset)),
                        shuffle=True, seed=opt.seed, drop_last=True)
    tower = image_tower(image_vars, cfg).to(device)
    for phase, steps in ((1, opt.image_phase1_steps), (2, opt.image_phase2_steps)):
        optim = build_encoder_optimizer(tower, "backbone", phase, lr_backbone=opt.lr_backbone,
                                        lr_head=opt.lr_head, weight_decay=opt.weight_decay)
        key = f"image_phase{phase}"
        losses[key] = []
        while len(losses[key]) < steps:
            for imgs, y in loader:
                with clock(key):
                    with autocast():
                        loss = image_loss(tower, phase, tensor(imgs), tensor(y))
                    optimizer_step(optim, loss)
                    losses[key].append(float(loss.detach()))
                if len(losses[key]) >= steps:
                    break
        image_vars = image_vars_of(tower)
        log(f"[mmdx] image phase {phase}: loss {losses[key]}")

    # text batch (patient details + labels) for the text phases
    _, _, tok, y, _ = _fetch_training_batch(train_rows, prep, opt.image_batch, opt.seed,
                                            images=False)
    ids, mask, tt = (tensor(tok[k], torch.long)
                     for k in ("input_ids", "attention_mask", "token_type_ids"))
    y = tensor(y)

    # ---- text tower, two phases ----
    text = text_tower(text_vars, cfg).to(device)
    drop_text = Dropout(cfg.text.hidden_dropout, gen)
    for phase in (1, 2):
        optim = build_encoder_optimizer(text, "bert", phase, lr_backbone=opt.lr_text_enc,
                                        lr_head=opt.lr_head, weight_decay=opt.weight_decay)
        key = f"text_phase{phase}"
        losses[key] = []
        for _ in range(opt.text_steps_per_phase):
            with clock(key):
                with autocast():
                    loss = text_loss(text, phase, ids, mask, tt, y,
                                     drop=drop_text if phase == 2 else None)
                optimizer_step(optim, loss)
                losses[key].append(float(loss.detach()))
        text_vars = text_vars_of(text)
        log(f"[mmdx] text phase {phase}: loss {losses[key]}")

    # ---- fusion on frozen precomputed embeddings ----
    rows_f, f_imgs, f_tok, f_y, f_report_labels = _fetch_training_batch(
        train_rows, prep, opt.fusion_batch, opt.seed + 42)
    with torch.no_grad(), autocast():
        z_img = tower(tensor(f_imgs), train=False)["embeddings"]
        z_txt = text.encode_train(*(tensor(f_tok[k], torch.long) for k in (
            "input_ids", "attention_mask", "token_type_ids")))["embeddings"]
    del tower, text
    f_y, f_report_labels = tensor(f_y), tensor(f_report_labels, torch.long)

    fusion_vars, losses["fusion"] = train_fusion(
        fusion_vars, cfg, z_img, z_txt, f_y, f_report_labels, opt, gen, device, clock)
    del z_img, z_txt
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- assemble the trained bundle, generate, compute real metrics ----
    trained = ModelBundle(
        config=cfg, variables=assemble_variables(image_vars, text_vars, fusion_vars),
        bert_vocab=bundle.bert_vocab, t5_vocab=bundle.t5_vocab, t5_scores=bundle.t5_scores,
        class_names=bundle.class_names, thresholds=bundle.thresholds,
        version=bundle.version)
    metrics, reports, serving = _evaluate_and_calibrate(
        trained, rows, rows_f, val_rows, opt, device, log, losses)
    del serving

    version = registry.create_model(
        opt.publish_model_name, trained,
        metrics={k: v for k, v in metrics.items() if v == v},  # drop nans
        description="CXR fusion: CNN+Text -> MLP; multi-label disease head; T5 report head.",
    )
    trained.version = version
    log(f"[mmdx] published {opt.publish_model_name} v{version}")
    if opt.save_local_bundle:
        from mmdx_tpu_torch.checkpoints.bundle import save_bundle
        from mmdx_tpu_torch.pipelines.inference_pipeline import default_bundle_path

        path = save_bundle(trained, opt.local_bundle_path or default_bundle_path())
        log(f"[mmdx] saved local bundle: {path}")
    return {"bundle": trained, "version": version, "metrics": metrics,
            "losses": losses, "reports": reports}


def train_fusion(fusion_vars: dict, cfg, z_img, z_txt, disease_targets, report_labels,
                 opt: TrainingOptions, gen: torch.Generator, device,
                 clock: _StepClock | None = None) -> tuple[dict, list[float]]:
    """The fusion loop on frozen embeddings (``:352-385``): ``fusion_steps``
    steps with fusion dropout, the global-norm clip at 1.0, a checkpoint
    every ``checkpoint_every`` steps when ``checkpoint_dir`` is set, and a
    resume from its latest step (parameters, optimizer state and the dropout
    generator's state, so a resumed run continues the uninterrupted one).
    -> (fusion variables, the losses of the steps run here)."""
    clock = clock or _StepClock(None, device)
    bf16 = opt.compute_dtype in ("bfloat16", "bf16")
    fusion = fusion_head(fusion_vars, cfg).to(device)
    optim = build_fusion_optimizer(fusion, lr_heads=opt.lr_head, lr_t5=opt.lr_t5,
                                   weight_decay=opt.weight_decay)
    drop = Dropout(cfg.fusion.dropout, gen)
    start_step = 0
    if opt.checkpoint_dir:
        from mmdx_tpu_torch.checkpoints.train_state import (restore_train_state,
                                                            save_train_state)

        state, ck_step = restore_train_state(opt.checkpoint_dir, map_location=device)
        if state is not None:
            fusion.load_state_dict(state["params"])
            optim.load_state_dict(state["opt_state"])
            gen.set_state(state["rng"].cpu())
            start_step = int(ck_step)
            opt.log(f"[mmdx][fusion] resumed from checkpoint step {start_step}")
    losses = []
    for step in range(start_step + 1, opt.fusion_steps + 1):
        with clock("fusion"):
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
                loss, parts = fusion_step_loss(fusion, z_img, z_txt, disease_targets,
                                               report_labels, drop)
            optimizer_step(optim, loss, clip_norm=1.0)
            losses.append(float(loss.detach()))
        if step % opt.log_every == 0 or step == 1:
            opt.log(f"[mmdx][fusion] step {step:04d} | cls={float(parts['cls'].detach()):.4f} "
                    f"gen={float(parts['gen'].detach()):.4f} total={float(loss.detach()):.4f}")
        if opt.checkpoint_dir and step % opt.checkpoint_every == 0:
            save_train_state(opt.checkpoint_dir, {
                "step": step, "params": fusion.state_dict(),
                "opt_state": optim.state_dict(), "rng": gen.get_state()}, step=step)
    return fusion_vars_of(fusion), losses


def _evaluate_and_calibrate(trained: ModelBundle, rows: Rows, rows_f: Rows,
                            val_rows: Rows, opt: TrainingOptions, device, log,
                            losses: dict):
    """Evaluation through a parity engine (greedy reports, AUROC, ROUGE-L)
    on the fusion batch and the held-out rows, then the int8 activation
    scales into ``trained.metadata`` (``:400-446``). -> (metrics, reports,
    the serving bundle the engine ran)."""
    from mmdx_tpu_torch.io.store import open_url
    from mmdx_tpu_torch.pipelines.metrics import auroc_micro, rouge_l_corpus
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    serving = trained.to_torch()
    engine = InferenceEngine(serving, mode="parity", device=device)

    def evaluate(eval_rows: Rows, targets, chunk: int = 64):
        probs_l, reps = [], []
        urls = list(eval_rows["image_url"])
        texts = [str(t) for t in eval_rows["patient_details"]]
        for i in range(0, len(urls), chunk):
            probs, zi, zt = engine.classify_batch([open_url(u) for u in urls[i:i + chunk]],
                                                  texts[i:i + chunk])
            probs_l.append(probs)
            reps.extend(engine.generate_reports(zi, zt, greedy=True))
        probs = np.concatenate(probs_l, axis=0)
        return (auroc_micro(targets, probs),
                rouge_l_corpus([str(r) for r in eval_rows["report"]], reps), reps)

    train_auroc, train_rouge, reports = evaluate(rows_f, _labels(rows_f))
    metrics = {
        "train_auroc_micro": train_auroc,
        "train_rougeL": train_rouge,
        "final_fusion_loss": losses["fusion"][-1] if losses["fusion"] else None,
    }
    if len(val_rows["image_url"]):
        val_auroc, val_rouge, _ = evaluate(val_rows, _labels(val_rows))
        metrics["val_auroc_micro"] = val_auroc
        metrics["val_rougeL"] = val_rouge
    else:
        log("[mmdx] WARNING: dataset too small for a held-out split; "
            "val_* metrics omitted")
    log(f"[mmdx] metrics: {metrics}")

    if opt.calibrate_int8 and len(rows["image_url"]):
        # turbo-ready publish: the int8 tower's activation scales from the
        # folded f32 tower over training images, persisted in the bundle
        from mmdx_tpu_torch.models import resnet_int8 as ri

        cal_urls = list(rows["image_url"])[: opt.calibrate_images]
        cal = torch.from_numpy(engine.prep_images([open_url(u) for u in cal_urls]))
        folded = ri.folded_backbone(serving.model.image_encoder.backbone, device)
        scales = ri.calibrate_backbone(folded, cal.to(device))
        trained.metadata = {**(trained.metadata or {}), "int8_scales": scales}
        log(f"[mmdx] int8 scales calibrated on {len(cal_urls)} training images "
            "(persisted in bundle metadata)")
    return metrics, reports, serving
