"""Offline batch inference CLI: a directory of studies -> JSONL, batched.

Port of ``mmdx_tpu/pipelines/batch_inference.py`` with the same flags and
the same JSONL contract. The reference can only serve one study at a time
through its Django view (reference backend/api/views.py:60-103 ->
inference_pipeline.py:150-206); this runs the batched engine directly:

  python -m mmdx_tpu_torch.pipelines.batch_inference --images DIR --out out.jsonl \\
      [--bundle B.mmdx] [--details-json MAP.json] [--mode fast|turbo|parity] \\
      [--batch 64] [--gen beam|greedy|off] [--cpu]

One JSON line per study, in sorted filename order, the reference inference()
contract plus the filename: {"image", "report_text", "disease_probs",
"disease_vector", "model_version"}. ``--details-json`` maps filename ->
patient-details text (missing entries run with empty details, like an empty
form field). The engine runs on the first CUDA card and raises without one;
``--cpu`` runs it on the CPU (every kernel's plain version).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def run(engine, paths: list[Path], details: dict[str, str], batch: int,
        gen: str, out_fh, timings=None) -> int:
    """Chunked offline inference with a one-chunk IO prefetcher.

    * decode + stage-1 shorter-side resize run on the host in one prefetch
      thread (``wire_image_u8(..., square=True)``: one wire shape for any mix
      of aspect ratios, with bit-identical preprocessing), so chunk i+1's
      decode overlaps chunk i's device work;
    * classify pads each chunk to ``batch`` (``pad_to``), which fixes the
      tokenization length as the JAX CLI does; a ragged tail chunk generates
      its reports at its own batch size (eager PyTorch compiles nothing per
      shape, so the JAX CLI's repetition of the last row is not needed).

    ``timings`` (a ``runtime.profiler.Timings``) gets one device-synchronized
    ``chunk`` scope per chunk."""
    from concurrent.futures import ThreadPoolExecutor

    from mmdx_tpu_torch.io.images import wire_image_u8
    from mmdx_tpu_torch.runtime.profiler import Timings

    timings = timings if timings is not None else Timings()
    rs = engine.bundle.config.image.resize_size
    # decode runs inline in the single prefetch task (a nested pool.map from
    # a pool task deadlocks at max_workers=1); PIL and the native resize
    # release the GIL, so one thread overlaps the device call
    pool = ThreadPoolExecutor(max_workers=1)

    def load(chunk):
        imgs = [wire_image_u8(p.read_bytes(), rs, square=True) for p in chunk]
        return imgs, [details.get(p.name, "") for p in chunk]

    chunks = [paths[i:i + batch] for i in range(0, len(paths), batch)]
    n_done = 0
    nxt = pool.submit(load, chunks[0])
    try:
        for ci, chunk in enumerate(chunks):
            images, texts = nxt.result()
            if ci + 1 < len(chunks):
                nxt = pool.submit(load, chunks[ci + 1])
            k = len(chunk)
            with timings.scope("chunk", sync=True, device=engine.device):
                probs, z_img, z_txt = engine.classify_batch(images, texts, pad_to=batch)
                reports = [""] * k
                if gen != "off":
                    reports = engine.generate_reports(z_img, z_txt, greedy=(gen == "greedy"))
            dt = timings.records["chunk"][-1]
            for j, p in enumerate(chunk):
                out_fh.write(json.dumps(
                    {"image": p.name, **engine.result_dict(probs[j], reports[j])}) + "\n")
            out_fh.flush()
            n_done += k
            print(f"[batch-infer] {n_done}/{len(paths)} ({k / dt:.1f} studies/s)",
                  file=sys.stderr, flush=True)
    finally:
        pool.shutdown(wait=True)
    return n_done


def main(argv=None, timings=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True,
                    help="directory of study images (jpg/png)")
    ap.add_argument("--out", required=True, help="output JSONL path")
    ap.add_argument("--bundle", default=None,
                    help=".mmdx or reference model_bundle.pt "
                         "(default: MMDX_BUNDLE_PATH or packaged)")
    ap.add_argument("--details-json", default=None,
                    help="JSON file mapping image filename -> patient "
                         "details text")
    ap.add_argument("--mode", default="fast",
                    choices=["parity", "fast", "turbo"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--gen", default="beam",
                    choices=["beam", "greedy", "off"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the first CUDA card)")
    args = ap.parse_args(argv)

    from mmdx_tpu_torch.pipelines.inference_pipeline import get_model_bundle
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    paths = sorted(
        p for p in Path(args.images).iterdir()
        if p.suffix.lower() in IMAGE_SUFFIXES
    )
    if not paths:
        ap.error(f"no images found under {args.images}")
    details = {}
    if args.details_json:
        details = json.loads(Path(args.details_json).read_text())

    bundle = get_model_bundle(args.bundle)
    # mixed-shape directories canonicalize near the wire size (post-resize
    # images are ~resize_size; the default 512 canonical would upscale them)
    engine = InferenceEngine(
        bundle, mode=args.mode,
        canonical_size=int(bundle.config.image.resize_size),
        device="cpu" if args.cpu else None,
    )
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with out_path.open("w") as fh:
        n = run(engine, paths, details, args.batch, args.gen, fh, timings)
    dt = time.perf_counter() - t0
    print(f"[batch-infer] wrote {n} results -> {out_path} ({dt:.1f}s)", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
