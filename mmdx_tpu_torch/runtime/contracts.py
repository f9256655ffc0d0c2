"""The hand-written kernels' width contracts, checked when an engine is built.

A kernel takes only the widths its tiles were written for, and its wrapper
raises on any other shape when it is called ("launch or raise": no kernel
falls back to its plain version on the card). An engine that would reach
such a kernel with a width it does not take is refused where it is built,
naming the layer, the kernel and the mode or switch that enables it, rather
than failing its first request. ``first_unmet_contract`` is a plain function
of the configuration (as the engine runs it), the engine mode and the
switches; ``InferenceEngine.__init__`` calls ``check_kernel_contracts`` for a
CUDA engine in fast or turbo mode. Parity mode, and any engine on the CPU,
run the plain versions and are never refused.

The contracts, from the wrappers:

* K1 (``ops/bert_attn.py``, the fused attention block at L <= 128) and K7
  (its int8 form, on K1's attention core): 64-wide heads;
* row 9 (``ops/flash_attention.py``, L >= ``flash_min_seq_len``): 64-wide
  heads;
* K2 and K6 (``ops/fused_ffn.py``): hidden and intermediate widths in 64s;
* K4 (``ops/t5_step.py``): 64-wide heads (d_model = heads x 64 = heads x
  d_kv), d_model and d_ff in 64s, at most 16 conditioning tokens;
* K3, rows 5 and 7 (``ops/beam_attn.py``): 64-wide heads, at most 8 beams;
* rows 10 and 11 (``ops/lm_head.py``, ``MMDX_FUSED_LM_HEAD=1``): d_model in
  64s wherever the streamed route runs (a vocabulary of 128-token chunks, at
  least two; any other vocabulary takes the dense route and is not refused);
* row 13 (``ops/int8_bottleneck.py``, ``MMDX_INT8_FUSED_BLOCKS``) and row 12
  (``ops/bottleneck.py``, ``use_fused_bottleneck``, which ``use_folded_bn``
  overrides, as every engine mode sets it): a plan of the tensor-core
  bottleneck (channels in 64s, a band that fits shared memory) for each
  fused block at the configured image size.

The int8 GEMM (K5) runs the ResNet-50 tower, whose widths no configuration
changes.

Under tensor parallelism (an engine on a mesh of model degree tp > 1) K1 and
K2 run their tensor-parallel form on the rank's shard: its heads must be
64 wide (so the heads divide over the ranks) and its share of the
intermediate width must be in 64s. A width the rules' divisibility check
sends to replication runs whole and is not refused. ``tp_plan`` names
the layers that stay whole on every model rank.
"""
from __future__ import annotations

import re

from mmdx_tpu_torch.config import DiagnosisConfig
from mmdx_tpu_torch.parallel.sharding import spec_for_path

HEAD = 64  # the attention kernels' head width


def _heads(hidden: int, heads: int) -> str | None:
    if heads <= 0 or hidden != heads * HEAD:
        return (f"64-wide heads, got width {hidden} over {heads} heads"
                f" ({hidden / max(heads, 1):g} wide)")
    return None


def _texts_lengths(config: DiagnosisConfig) -> list[int]:
    from mmdx_tpu_torch.runtime.engine import bucket_ladder

    max_len = config.text.max_len
    return sorted(set(bucket_ladder(max_len)) | {max_len})


def tp_plan(specs: dict, mode: str, *, text_int8: bool = False) -> tuple[dict, list[str]]:
    """What an engine of ``mode`` shards at model degree > 1, from the rules'
    specs of its model's kernels (JAX path -> spec,
    ``parallel.sharding.dense_specs``) -> (the specs it applies, the layers
    that stay whole on every model rank, each with the reason). The layers
    whose kernels cannot take a shard stay whole; so does a kernel whose
    width the rules' divisibility check replicates."""
    kept = {"image_encoder/": "image tower (ResNet-50: replicated by the rules)"}
    if text_int8:
        kept["text_encoder/"] = ("text encoder's W8A8 blocks (K6 and K7 row-quantize an "
                                 "intermediate whose per-row amax spans the whole width)")
    if mode != "parity":
        kept["fusion/report_model/"] = (
            "T5 decoder (K4 holds both of a half step's row-parallel products in one "
            "cooperative launch; K3, rows 5-7 and the lm head read its whole heads)")
    prefixes = tuple(kept)
    applied = {p: () if p.startswith(prefixes) else s for p, s in specs.items()}
    replicated = sorted({re.sub(r"layer\d+", "layer*", p) for p, s in applied.items()
                         if not s and spec_for_path(p) and not p.startswith(prefixes)})
    return applied, list(kept.values()) + [
        f"{p} (its width does not divide over the model ranks)" for p in replicated]


def first_unmet_contract(config: DiagnosisConfig, mode: str, *, text_int8: bool = False,
                         kv_int8: bool = False, fused_lm_head: bool = False,
                         int8_fused_blocks=(), tp: int = 1) -> str | None:
    """The first contract that the kernels ``mode`` and the switches enable
    do not meet under ``config`` (as the engine runs it) at model degree
    ``tp``, as a message that names the layer, the kernel and the switch;
    None if every one is met or the mode runs no kernel (parity)."""
    if mode not in ("fast", "turbo"):
        return None
    text, rep, img = config.text, config.report, config.image
    lengths = _texts_lengths(config)

    def unmet(layer, kernel, switch, why):
        return f"{layer}: {kernel} ({switch}) needs {why}"

    if tp > 1 and not text_int8:
        h, heads, f = text.hidden_size, text.num_heads, text.intermediate_size
        layers = f"text encoder, {text.num_layers} layers, model degree {tp}"
        if h % tp == 0 and heads % tp:
            return unmet(layers, "K1's tensor-parallel form (ops/bert_attn.py)",
                         f"{mode} mode, mesh", f"the rank's heads 64 wide, got width "
                         f"{h} over {heads} heads split {tp} ways")
        if f % tp == 0 and (f // tp) % 64:
            return unmet(layers, "K2's tensor-parallel form (ops/fused_ffn.py)",
                         f"{mode} mode, mesh", f"the rank's intermediate width in 64s, "
                         f"got {f} / {tp} = {f // tp}")

    # the text tower
    int8_text = "turbo mode / MMDX_TEXT_INT8" if text_int8 else f"{mode} mode"
    attn = ("K7 (the int8 attention block on K1's attention core, ops/bert_attn.py)"
            if text_int8 else "K1 (the fused attention block, ops/bert_attn.py)")
    block_max = min(text.fused_attn_max_seq_len, 128)
    if any(n <= block_max for n in lengths):
        why = _heads(text.hidden_size, text.num_heads)
        if why:
            return unmet(f"text encoder, {text.num_layers} layers at L <= {block_max}",
                         attn, int8_text, why)
    if text.use_flash_attention and any(n >= text.flash_min_seq_len for n in lengths):
        why = _heads(text.hidden_size, text.num_heads)
        if why:
            return unmet(f"text encoder at L >= {text.flash_min_seq_len}",
                         "row 9 (flash attention, ops/flash_attention.py)",
                         f"{mode} mode, text.max_len {text.max_len}", why)
    if text.hidden_size % 64 or text.intermediate_size % 64:
        ffn = "K6 (the W8A8 FFN block" if text_int8 else "K2 (the fused FFN block"
        return unmet(f"text encoder, {text.num_layers} layers", ffn + ", ops/fused_ffn.py)",
                     int8_text, f"widths in 64s, got hidden {text.hidden_size}, "
                     f"intermediate {text.intermediate_size}")

    # the report decoder
    v = rep.vocab_size
    if fused_lm_head and v % 128 == 0 and v >= 256 and rep.d_model % 64:
        return unmet("report decoder's tied lm head",
                     "rows 10 and 11 (the streamed lm head, ops/lm_head.py)",
                     "MMDX_FUSED_LM_HEAD=1", f"d_model in 64s, got {rep.d_model}")
    layer = f"report decoder, {rep.num_decoder_layers} layers"
    why = _heads(rep.d_model, rep.num_heads) or (
        None if rep.d_kv == HEAD else f"64-wide heads, got d_kv {rep.d_kv}")
    kk = config.fusion.n_cond_tokens
    if why is None and (rep.d_ff % 64 or not 0 < kk <= 16):
        why = (f"d_ff in 64s and 1-16 conditioning tokens, got d_ff {rep.d_ff}, "
               f"{kk} tokens")
    if why:
        return unmet(layer, "K4 (the cross-attention + FFN half step, ops/t5_step.py)",
                     f"{mode} mode", why)
    beams = config.generation.num_beams
    if not 0 < beams <= 8:
        read = ("row 7 (the int8-KV attention read" if kv_int8 else
                "K3 and row 5 (the beam attention reads")
        return unmet(layer, read + ", ops/beam_attn.py)",
                     "MMDX_KV_INT8=1" if kv_int8 else f"{mode} mode",
                     f"1-8 beams, got {beams}")

    # the image tower
    from mmdx_tpu_torch.models.resnet import RESNET50_STAGES, fused_width
    from mmdx_tpu_torch.ops.bottleneck import tc_plan

    def plan_error(stage: int, es: int) -> str | None:
        m = 64 * 2 ** (stage - 1)
        side = img.img_size // 4 // 2 ** (stage - 1)
        try:
            for cin, proj in ((4 * m, False),) + (((64, True),) if stage == 1 else ()):
                tc_plan(1, side, side, cin, m, 4 * m, es, proj)
        except ValueError as err:
            return f"a plan at {side}x{side}, M {m}: {err}"
        return None

    if mode == "turbo":
        for stage in int8_fused_blocks:
            if not 1 <= stage <= len(RESNET50_STAGES):
                return unmet("image tower", "row 13 (the fused int8 bottleneck, "
                             "ops/int8_bottleneck.py)", "MMDX_INT8_FUSED_BLOCKS",
                             f"stages 1-{len(RESNET50_STAGES)}, got {stage}")
            why = plan_error(stage, 1)
            if why:
                return unmet(f"image tower, stage {stage} stride-1 blocks",
                             "row 13 (the fused int8 bottleneck, ops/int8_bottleneck.py)",
                             "MMDX_INT8_FUSED_BLOCKS", why)
    width = fused_width(img)
    for stage in range(1, len(RESNET50_STAGES) + 1):
        if 64 * 2 ** (stage - 1) <= width:
            why = plan_error(stage, 2)
            if why:
                return unmet(f"image tower, stage {stage} stride-1 blocks",
                             "row 12 (the fused bf16 bottleneck, ops/bottleneck.py)",
                             "use_fused_bottleneck", why)
    return None


def check_kernel_contracts(config: DiagnosisConfig, mode: str, **switches) -> None:
    """Raise ValueError with ``first_unmet_contract``'s message, if any."""
    why = first_unmet_contract(config, mode, **switches)
    if why:
        raise ValueError(f"this configuration cannot run in {mode} mode on the card: {why}. "
                         "Build the engine in parity mode or on the CPU (device='cpu'), where "
                         "every layer runs its plain version")
