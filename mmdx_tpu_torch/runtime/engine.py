"""InferenceEngine: batched classification and report generation (beam-4 or greedy).

Port of ``mmdx_tpu/runtime/engine.py`` with the same public surface
(``prep_images``, ``prep_texts``, ``classify_batch``, ``generate_report_ids``,
``generate_reports``, ``infer``, ``result_dict``) and three modes:

* ``parity`` — f32 weights and math, host-exact PIL-equivalent
  preprocessing, the plain PyTorch version of every op; TF32 is switched off
  for matmuls and cuDNN convolutions;
* ``fast`` — bf16 towers, on-device resize + crop + normalize, and the
  hand-written kernels: the BERT attention block and FFN block in the text
  tower; in the decode step the T5 cross-attention + FFN half-step and the
  self-attention read (the softmax partials with deferred cache writes for
  beam, the normalised read over the written cache for greedy). The kernels
  are chosen by the mode and the switches below; on CPU tensors their
  wrappers run the plain versions;
* ``turbo`` — fast mode with the static-PTQ int8 image tower
  (``models/resnet_int8``, every conv through the int8 GEMM kernel;
  ``MMDX_INT8_FUSED_BLOCKS=1,2`` runs the stride-1 blocks of those stages
  as fused int8 bottlenecks, read once at construction), the
  text tower's blocks in their W8A8 form (``MMDX_TEXT_INT8=0`` keeps them
  bf16, ``MMDX_TEXT_INT8=1`` turns them on in fast mode too, as in the JAX
  engine's TPU branch), and 1-channel batches through the centered-gray
  preprocessing into the folded gray stem. Activation scales come from
  ``bundle.metadata["int8_scales"]``, else the first batch calibrates them.

The decode-layer switches of the JAX engine, read once at construction in
fast and turbo mode (parity mode ignores them, as ``engine.py:80``, ``:154``):

* ``MMDX_KV_INT8=1`` — int8 KV cache with per-(row, head) scales, for beam
  and greedy, read by the int8 attention kernel (default off);
* ``MMDX_FUSED_LM_HEAD=1`` — the decode step returns ``LazyLogits`` and the
  selection streams the tied lm head (``ops/lm_head.py``; default off);
* ``MMDX_DEFER_KV=0`` — beam reads the written cache through the normalised
  read kernel instead of the deferred partials (default on; greedy and the
  int8 cache never defer, ``engine.py:422-427``).

In fast and turbo mode the engine's model runs the text tower with
``use_flash_attention`` on (blockwise attention at 256 tokens and more; a
configuration with ``max_len`` 512, BERT-base's own limit, buckets texts at
176 / 256 / 344 / 512) and the image tower with ``use_folded_bn`` on, as the
JAX engine's TPU branch sets them (``engine.py:87-113``): the fused bf16
bottleneck stays off in every mode.

Launch or raise, at construction: a kernel takes only the widths its tiles
were written for and never falls back to its plain version on the card, so
a CUDA engine in fast or turbo mode checks the bundle's widths against the
contract of every kernel its mode and switches enable and raises there,
naming the layer, the kernel and the switch (``runtime/contracts.py``; for
example a bundle with 16-wide heads is refused, since K1 takes heads of 64).
Parity mode and CPU engines run the plain versions and are never refused.

``MMDX_GREEDY_FLAT`` and ``MMDX_DECODE_SEGMENTS`` are TPU layout knobs and
are not ported: greedy always runs over the flat cache at nb = 1, and the
cache is one full-length buffer.

Multi-device (``mesh=``, a ("data", "model") DeviceMesh from
``parallel.mesh.make_mesh``): every rank builds the engine and calls each
entry point with the same arguments. Each data rank decodes, tokenizes and
runs only its own rows of the batch, padded to a multiple of the data degree
by repeating row 0 as the JAX engine pads (``engine.py:197-213``; fast
mode's token bucket is the whole batch's, by an ``all_reduce`` of the
longest text, and turbo's first-batch scales are the maximum over the data
ranks); the outputs are put together on every rank by ``all_reduce`` and
un-padded. The decode loop runs on each data rank's rows with no collective
between data ranks (``engine.py:628-633``). Over "model" the weights are
sharded by ``parallel/sharding.py``'s rules: in parity mode every rule
applies; in fast and turbo mode the text tower's blocks run K1 and K2 in
their tensor-parallel form, while the T5 decoder (K4 holds both of a half
step's row-parallel products in one cooperative launch; K3, rows 5-7 and
the lm head read its whole heads) and turbo's W8A8 text blocks (K6, K7
row-quantize over the whole width) stay whole on every model rank
(``runtime/contracts.tp_plan``, printed at construction). The image
tower is replicated, as the rules have it. Model ranks must take the same
beam choices: selection reads inputs an ``all_reduce`` made identical, and
the engine checks that the ids agree over "model".
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from mmdx_tpu_torch.checkpoints.bridge import TorchBundle
from mmdx_tpu_torch.config import GenerationConfig
from mmdx_tpu_torch.decode.beam_search import (beam_expand, beam_search,
                                               make_generation_kwargs)
from mmdx_tpu_torch.decode.greedy import greedy_decode
from mmdx_tpu_torch.models import resnet_int8 as ri
from mmdx_tpu_torch.runtime.contracts import check_kernel_contracts, tp_plan
from mmdx_tpu_torch.ops.preprocess import (preprocess_batch_device,
                                           preprocess_batch_device_gray,
                                           preprocess_exact)


def bucket_ladder(max_len: int) -> tuple[int, ...]:
    """Fast-mode token-length buckets below ``max_len`` (1/3, 1/2, 2/3 of it,
    rounded up to a multiple of 8); MMDX_TEXT_BUCKETS overrides, as in
    ``mmdx_tpu.runtime.engine.bucket_ladder``."""
    raw = os.environ.get("MMDX_TEXT_BUCKETS", "")
    if raw:
        return tuple(sorted({int(x) for x in raw.split(",")
                             if x.strip() and 0 < int(x) < max_len}))
    steps = {min(max_len, max(8, -(-int(max_len * f) // 8) * 8))
             for f in (1 / 3, 1 / 2, 2 / 3)}
    return tuple(s for s in sorted(steps) if s < max_len)


def resolve_device(device=None) -> torch.device:
    """The device asked for, else the first CUDA card. Without a card there
    is no quiet CPU default: a caller that wants the plain versions on the
    CPU asks for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the engine runs on a CUDA card; pass "
                           "device='cpu' to run every op's plain version on the CPU")
    return torch.device("cuda", 0)


def front_end_backends(bert_tok, t5_tok) -> dict[str, str]:
    """Which backend each host stage of a request takes: "native" (the C++
    cores of ``native/``) or "python" (their pure-Python fallbacks, with
    identical outputs): the WordPiece and unigram tokenizers and the wire
    image resize of ``io.images.wire_image_u8``."""
    from mmdx_tpu_torch import native

    def kind(flag):
        return "native" if flag else "python"

    return {"wordpiece": kind(getattr(bert_tok, "native_available", False)),
            "unigram": kind(getattr(t5_tok, "native_available", False)),
            "resize": kind(native.available())}


class InferenceEngine:
    def __init__(self, bundle: TorchBundle, mode: str = "parity",
                 canonical_size: int = 512, device=None, mesh=None):
        if mode not in ("parity", "fast", "turbo"):
            raise ValueError(f"unknown engine mode {mode!r}")
        self.mesh, self.layout = mesh, None
        if mesh is not None:
            from mmdx_tpu_torch.parallel.mesh import layout, rank_device

            if not torch.distributed.is_initialized():
                raise RuntimeError("a mesh needs a process group on every rank: build it "
                                   "with parallel.mesh.init_world and make_mesh (or run "
                                   "under torchrun or parallel.mesh.launch)")
            self.layout = layout(mesh)
            device = rank_device(device)
        self.bundle = bundle
        self.mode = mode
        self.kernels = mode in ("fast", "turbo")
        text_int8 = os.environ.get("MMDX_TEXT_INT8", "")
        self.text_int8 = text_int8 == "1" or (mode == "turbo" and text_int8 != "0")
        env = os.environ.get
        self.kv_int8 = self.kernels and env("MMDX_KV_INT8", "") == "1"
        self.fused_lm_head = self.kernels and env("MMDX_FUSED_LM_HEAD", "") == "1"
        self.defer_kv = env("MMDX_DEFER_KV", "1") != "0"
        self.int8_fused_blocks = tuple(sorted(
            {int(x) for x in env("MMDX_INT8_FUSED_BLOCKS", "").split(",") if x.strip()}
        )) if mode == "turbo" else ()
        self._qparams = None
        self.calibration_ms = None  # host time of the first-batch calibration
        self.scales_source = None  # turbo: "bundle" (persisted) or "first batch"
        self.canonical_size = canonical_size
        self.device = resolve_device(device)
        self.dtype = torch.float32 if mode == "parity" else torch.bfloat16
        if mode == "parity":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg = bundle.config
        if self.kernels:  # the JAX engine's switches (engine.py:87-113)
            cfg = dataclasses.replace(
                cfg, text=dataclasses.replace(cfg.text, use_flash_attention=True),
                image=dataclasses.replace(cfg.image, use_folded_bn=True))
        tp = self.layout.tp if self.layout else 1
        if self.kernels and self.device.type == "cuda":
            check_kernel_contracts(cfg, mode, text_int8=self.text_int8, kv_int8=self.kv_int8,
                                   fused_lm_head=self.fused_lm_head,
                                   int8_fused_blocks=self.int8_fused_blocks, tp=tp)
        model = bundle.model.with_config(cfg)
        self.whole_under_tp = []
        if tp > 1:
            from mmdx_tpu_torch.parallel.sharding import dense_specs, model_shard, shard_model_

            specs, self.whole_under_tp = tp_plan(dense_specs(model, tp), mode,
                                                 text_int8=self.text_int8)
            shard_model_(model, specs, model_shard(mesh))
        if self.layout is not None and torch.distributed.get_rank() == 0:
            lay = self.layout
            print(f"[mmdx] mesh: data {lay.dp} x model {lay.tp} "
                  f"({torch.distributed.get_backend()}), {mode} mode; whole on every "
                  "model rank: " + ("; ".join(self.whole_under_tp) or "(tp 1: every layer)"),
                  file=sys.stderr, flush=True)
        if mode == "turbo":
            # turbo never runs the bf16 backbone (the int8 tower folds from
            # bundle.model), so it stays off the card
            model.image_encoder.backbone = None
        self.model = model.to(self.device).cast_(self.dtype).eval()
        if self.text_int8:
            with torch.inference_mode():
                self.model.text_encoder.quantize_int8_()
        self.bert_tok, self.t5_tok = bundle.tokenizers()
        self.thresholds = np.asarray(bundle.thresholds, np.float32)
        self.front_end = front_end_backends(self.bert_tok, self.t5_tok)
        print("[mmdx] front end: " + ", ".join(f"{k} {v}" for k, v in self.front_end.items()),
              file=sys.stderr, flush=True)

    # ------------------------------------------------------------------
    # host-side input prep
    # ------------------------------------------------------------------
    @staticmethod
    def _decode(images) -> list[np.ndarray]:
        """uint8 ndarrays pass through; anything else (bytes, PIL images)
        goes through ``io.images``, imported only then (it needs PIL)."""
        images = list(images)
        if all(isinstance(a, np.ndarray) and a.dtype == np.uint8 for a in images):
            return images
        from mmdx_tpu_torch.io.images import decode_images

        return decode_images(images)

    def prep_images(self, images) -> np.ndarray:
        """parity: host-exact preprocessing -> [B, S, S, 3] float32;
        fast, turbo: uint8 [B, H, W, ch] (preprocessing runs on the device;
        a batch that is all 1-channel stays 1-channel)."""
        cfg = self.bundle.config.image
        arrays = self._decode(images)
        if self.mode == "parity":
            return np.stack([preprocess_exact(a, cfg.img_size, cfg.resize_size,
                                              cfg.mean, cfg.std) for a in arrays])
        # one raw shape: the device resize keeps the exact shorter-side +
        # center-crop geometry; mixed shapes are first made square on the host
        # so they stack. (The JAX engine also caps the distinct raw shapes to
        # bound XLA recompiles; eager PyTorch compiles nothing per shape.)
        if len({a.shape[:2] for a in arrays}) == 1:
            canon = [a[:, :, None] if a.ndim == 2 else a for a in arrays]
        else:
            from mmdx_tpu_torch.io.images import to_canonical_u8

            canon = [to_canonical_u8(a, self.canonical_size) for a in arrays]
        if max(c.shape[-1] for c in canon) == 3:
            canon = [np.repeat(c, 3, -1) if c.shape[-1] == 1 else c for c in canon]
        return np.stack(canon)

    def prep_texts(self, texts: list[str], fixed_len: bool = False) -> dict[str, np.ndarray]:
        """Tokenize to max_len (parity); fast mode pads to the smallest
        bucket covering the batch unless ``fixed_len`` (under a mesh, the
        longest text of every data rank's rows)."""
        max_len = self.bundle.config.text.max_len
        enc = self.bert_tok.encode_batch(texts, max_len=max_len)
        if self.mode != "parity" and not fixed_len:
            longest = int(enc["attention_mask"].sum(axis=1).max(initial=1))
            if self.layout is not None and self.layout.dp > 1:
                t = torch.tensor([longest], device=self.device)
                torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX,
                                             group=self.layout.data_group)
                longest = int(t.item())
            for bucket in bucket_ladder(max_len):
                if bucket >= longest:
                    return {k: v[:, :bucket] for k, v in enc.items()}
        return enc

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # the data axis of a mesh
    # ------------------------------------------------------------------
    def _my_rows(self, n: int) -> tuple[list[int], int]:
        """-> (the indices into an ``n``-row batch of this data rank's rows
        after padding to a multiple of the data degree by repeating row 0,
        the padded size). Without a mesh: every row."""
        if self.layout is None or self.layout.dp == 1:
            return list(range(n)), n
        from mmdx_tpu_torch.parallel.mesh import rows_of

        padded, rows = rows_of(n, self.layout.dp, self.layout.data_rank)
        return (list(range(n)) + [0] * (padded - n))[rows], padded

    def _gather(self, t: torch.Tensor, padded: int) -> torch.Tensor:
        """This data rank's rows of a ``padded``-row output -> every row, on
        every rank (a zero-filled buffer summed over "data")."""
        if self.layout is None or self.layout.dp == 1:
            return t
        from mmdx_tpu_torch.parallel.mesh import rows_of
        from mmdx_tpu_torch.parallel.sharding import gather_rows

        _, rows = rows_of(padded, self.layout.dp, self.layout.data_rank)
        return gather_rows(t, padded, rows, self.layout.data_group)

    def classify_batch(self, images, texts: list[str], pad_to: int | None = None,
                       host_outputs: bool = False):
        """-> (probs [B, 13] np.float32, z_img, z_txt).

        ``pad_to`` pads the batch (repeating the last row) with fixed-length
        tokenization, as the bucketed serving path does; ``host_outputs``
        returns z_img/z_txt as numpy f32 (the micro-batcher asks for that);
        otherwise they stay tensors on the device."""
        images, texts = list(images), list(texts)
        n0 = len(images)
        # pad_to repeats the last row; the rows this (data) rank runs, each
        # decoded and tokenized once
        rows = list(range(n0)) + [n0 - 1] * max(0, (pad_to or 0) - n0)
        mine, padded = self._my_rows(len(rows))
        sel = [rows[i] for i in mine]
        uniq = sorted(set(sel))
        pos = {j: i for i, j in enumerate(uniq)}
        take = [pos[j] for j in sel]
        imgs = self.prep_images([images[j] for j in uniq])
        tok = self.prep_texts([texts[j] for j in uniq], fixed_len=pad_to is not None)
        if take != list(range(len(uniq))):
            imgs, tok = imgs[take], {k: v[take] for k, v in tok.items()}
        tokens = tuple(self._tensor(tok[k]).long()
                       for k in ("input_ids", "attention_mask", "token_type_ids"))
        with torch.inference_mode():
            probs, z_img, z_txt = (self._gather(t, padded) for t in self.model.classify(
                self._image_embeddings(imgs), *tokens, kernels=self.kernels,
                int8=self.text_int8))
        probs = probs.cpu().numpy()[:n0]
        z_img, z_txt = z_img[:n0], z_txt[:n0]
        if host_outputs:  # numpy f32 (exact for bf16), as the batcher concatenates
            z_img, z_txt = (z.float().cpu().numpy() for z in (z_img, z_txt))
        return probs, z_img, z_txt

    def _image_embeddings(self, imgs: np.ndarray) -> torch.Tensor:
        """``prep_images`` output -> z_img [B, d_img] in the engine's dtype,
        through the engine's image tower: turbo the int8 tower (1-channel
        batches through the centered-gray preprocessing into its folded gray
        stem), else the bf16 (fast) or f32 (parity) tower; uint8 batches
        are preprocessed on the device."""
        x = self._tensor(imgs)
        cfg = self.bundle.config.image
        if self.mode == "turbo":
            qparams = self._ensure_qparams(x)
            if x.dtype == torch.uint8 and x.shape[-1] == 1:
                x = preprocess_batch_device_gray(x, cfg.img_size, cfg.resize_size,
                                                 out_dtype=self.dtype)
            elif x.dtype == torch.uint8:
                x = preprocess_batch_device(x, cfg.img_size, cfg.resize_size,
                                            cfg.mean, cfg.std, out_dtype=self.dtype)
            with torch.inference_mode():
                feats = ri.int8_backbone_apply(qparams, x, self.int8_fused_blocks)
                return self.model.image_encoder.project(feats)
        if x.dtype == torch.uint8:
            x = preprocess_batch_device(x, cfg.img_size, cfg.resize_size,
                                        cfg.mean, cfg.std, out_dtype=self.dtype)
        else:
            x = x.to(self.dtype)
        with torch.inference_mode():
            return self.model.image_encoder.encode(x)

    def classify_image_batch(self, images) -> np.ndarray:
        """Single modality: images -> the image tower's warm-up classifier
        probabilities [B, 13] f32 (BASELINE config 1, image-only CNN
        classification; ``mmdx_tpu/runtime/engine.py:562``)."""
        images = list(images)
        mine, padded = self._my_rows(len(images))
        z_img = self._image_embeddings(self.prep_images([images[i] for i in mine]))
        with torch.inference_mode():
            probs = self._gather(self.model.image_encoder.classify(z_img), padded)
        return probs.cpu().numpy()[:len(images)]

    def classify_text_batch(self, texts: list[str]) -> np.ndarray:
        """Single modality: free text -> the text tower's warm-up classifier
        probabilities [B, 13] f32 (BASELINE config 2, report-only text
        classification; ``mmdx_tpu/runtime/engine.py:570``); in fast and
        turbo mode the tower runs its kernels (K1, K2; K6, K7 in W8A8)."""
        mine, padded = self._my_rows(len(texts))
        tok = self.prep_texts([texts[i] for i in mine])
        ids, mask, tt = (self._tensor(tok[k]).long()
                         for k in ("input_ids", "attention_mask", "token_type_ids"))
        with torch.inference_mode():
            z_txt = self.model.text_encoder.encode(ids, mask, tt, self.kernels,
                                                   self.text_int8)
            probs = self._gather(self.model.text_encoder.classify(z_txt), padded)
        return probs.cpu().numpy()[:len(texts)]

    def _ensure_qparams(self, images=None) -> dict:
        """The int8 tower's qparams, built once per engine (turbo mode).

        Activation scales come from ``bundle.metadata["int8_scales"]`` (a
        bundle calibrated offline); a bundle without them, or with a site
        missing (an older site schema), calibrates on the FIRST batch: one
        f32 pass of the folded tower with TF32 off. ``images`` is that batch,
        uint8 (preprocessed here, 3-channel normalized) or preprocessed."""
        if self._qparams is not None:
            return self._qparams
        cfg = self.bundle.config.image
        t0 = time.perf_counter()
        folded = ri.folded_backbone(self.bundle.model.image_encoder.backbone,
                                    self.device)
        scales = (self.bundle.metadata or {}).get("int8_scales")
        if scales and set(ri.calibration_sites()) - set(scales):
            scales = None
        self.scales_source = "bundle" if scales else "first batch"
        if not scales:
            print("[mmdx] turbo: no persisted int8_scales in the bundle — "
                  f"calibrating from the first batch ({len(images)} image(s)); "
                  "for production scales calibrate on representative studies",
                  file=sys.stderr, flush=True)
            x = torch.as_tensor(images).to(self.device)
            if x.dtype == torch.uint8:
                x = preprocess_batch_device(x, cfg.img_size, cfg.resize_size,
                                            cfg.mean, cfg.std, out_dtype=torch.float32)
            scales = ri.calibrate_backbone(folded, x)
            if self.layout is not None and self.layout.dp > 1:
                # the whole batch's amax: the largest over the data ranks' rows
                sites = sorted(scales)
                amax = torch.tensor([scales[k] for k in sites], dtype=torch.float64,
                                    device=self.device)
                torch.distributed.all_reduce(amax, torch.distributed.ReduceOp.MAX,
                                             group=self.layout.data_group)
                scales = dict(zip(sites, amax.tolist()))
        with torch.inference_mode():
            self._qparams = ri.quantize_backbone(folded, scales, cfg.mean, cfg.std,
                                                 cfg.img_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_ms = (time.perf_counter() - t0) * 1e3
        return self._qparams

    @torch.inference_mode()
    def generate_report_ids(self, z_img, z_txt, gen: GenerationConfig | None = None,
                            greedy: bool = False) -> np.ndarray:
        """Report token ids [B, 1+max_new_tokens] (HF ``generate`` layout:
        leading decoder_start, pad/eos fill past the finish), beam search or
        greedy over the flat cache at nb = 1."""
        gen = gen or self.bundle.config.generation
        n = int(z_img.shape[0])
        mine, padded = self._my_rows(n)
        z_img, z_txt = torch.as_tensor(z_img), torch.as_tensor(z_txt)
        if self.layout is not None and self.layout.dp > 1:  # this data rank's rows
            rows = torch.as_tensor(mine)
            z_img, z_txt = z_img[rows.to(z_img.device)], z_txt[rows.to(z_txt.device)]
        z_img = z_img.to(self.device, self.dtype)
        z_txt = z_txt.to(self.device, self.dtype)
        b, nb = int(z_img.shape[0]), 1 if greedy else gen.num_beams
        lmax = 1 + gen.max_new_tokens
        prep = self.model.prepare_generation(beam_expand(z_img, nb),
                                             beam_expand(z_txt, nb), lmax, nb,
                                             kv_int8=self.kv_int8)
        cache, static_kv = prep["cache"], prep["static_kv"]
        self_bias, enc_mask = prep["self_bias"], prep["enc_mask"]
        vocab = self.bundle.config.report.vocab_size
        kw = make_generation_kwargs(gen)

        def step(tokens, pos, anc):
            return self.model.decode_step_beam(
                tokens, pos, cache, anc, static_kv, self_bias, enc_mask,
                kernels=self.kernels, defer=self.defer_kv,
                lazy_logits=self.fused_lm_head)

        if greedy:
            anc0 = torch.zeros((b, 1, lmax), dtype=torch.int64, device=self.device)
            kw = {k: v for k, v in kw.items() if k not in ("num_beams", "length_penalty",
                                                           "early_stopping")}
            seqs = greedy_decode(lambda tokens, pos: step(tokens, pos, anc0), batch=b,
                                 vocab_size=vocab, device=self.device, **kw)
        else:
            seqs, _ = beam_search(step, batch=b, vocab_size=vocab, device=self.device,
                                  **kw)
        if self.layout is not None:
            seqs = self._gather(seqs, padded)[:n]
            if self.layout.tp > 1:
                self._check_model_ranks_agree(seqs)
        return seqs.cpu().numpy()

    def _check_model_ranks_agree(self, ids: torch.Tensor) -> None:
        """Every model rank chose the same ids (their selections read inputs
        that an ``all_reduce`` made identical); raise otherwise."""
        dist = torch.distributed
        lo, hi = ids.clone(), ids.clone()
        dist.all_reduce(lo, dist.ReduceOp.MIN, group=self.layout.model_group)
        dist.all_reduce(hi, dist.ReduceOp.MAX, group=self.layout.model_group)
        if not torch.equal(lo, hi):
            rows = sorted({int(r) for r in torch.nonzero(lo != hi)[:, 0].tolist()})
            raise RuntimeError(f"model ranks chose different report ids in rows {rows}")

    def generate_reports(self, z_img, z_txt, gen: GenerationConfig | None = None,
                         greedy: bool = False) -> list[str]:
        seqs = self.generate_report_ids(z_img, z_txt, gen, greedy=greedy)
        return self.t5_tok.batch_decode(seqs, skip_special_tokens=True)

    def infer(self, image, patient_details: str, gen_kwargs: dict | None = None,
              generate: bool = True, greedy: bool = False) -> dict:
        """Single-sample inference with the reference's output contract."""
        gen = self.bundle.config.generation
        if gen_kwargs:
            gen = dataclasses.replace(gen, **gen_kwargs)
        probs, z_img, z_txt = self.classify_batch([image], [patient_details])
        report = self.generate_reports(z_img, z_txt, gen, greedy=greedy)[0] if generate else ""
        return self.result_dict(probs[0], report)

    def result_dict(self, probs_row, report_text: str) -> dict:
        return {
            "report_text": report_text,
            "disease_probs": {name: float(probs_row[j])
                              for j, name in enumerate(self.bundle.class_names)},
            "disease_vector": (probs_row >= self.thresholds).astype(int).tolist(),
            "model_version": self.bundle.version,
        }
