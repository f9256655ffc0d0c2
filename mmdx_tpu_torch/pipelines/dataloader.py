"""Store-backed image dataset + batched loader with background prefetch.
Copy of ``mmdx_tpu/pipelines/dataloader.py``, over the port's
``preprocess_exact`` and ``io.images.decode_image``.

Rebuilds the reference's ``CXR_ImageDataset`` + ``DataLoader(batch_size=32,
shuffle=True)`` (reference ``backend/ml/pipelines/training_pipeline.py:131-152,
826-831``) without its per-item-synchronous S3 fetch: a worker thread
prefetches and preprocesses the next batches while the device trains on the
current one (the reference blocks training on one S3 GET per image).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from mmdx_tpu_torch.io.store import open_url
from mmdx_tpu_torch.ops.preprocess import preprocess_exact


@dataclass
class CXRImageDataset:
    """(image_url, disease_vector) pairs fetched from the object store."""

    image_urls: list[str]
    labels: list[np.ndarray]
    img_size: int = 224
    resize_size: int = 256

    @classmethod
    def from_dataframe(cls, df, **kw):
        """Build from the feature-store dataframe (reference
        construct_input_label_pairs_for_image_encoder_dataset, :122-127)."""
        return cls(
            image_urls=df["image_url"].tolist(),
            labels=[np.asarray(v, np.float32)
                    for v in df["disease_classification_vector"].tolist()],
            **kw,
        )

    def __len__(self) -> int:
        assert len(self.image_urls) == len(self.labels)
        return len(self.image_urls)

    def __getitem__(self, i: int):
        from mmdx_tpu_torch.io.images import decode_image

        img = decode_image(open_url(self.image_urls[i]))
        x = preprocess_exact(img, self.img_size, self.resize_size)
        return x, self.labels[i]


class DataLoader:
    """Shuffled batched iteration with one background prefetch worker."""

    def __init__(self, dataset: CXRImageDataset, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that aborts when the consumer is gone — a consumer
            # that breaks out mid-epoch (step-budgeted training loops do)
            # must not leave this thread blocked on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    xs, ys = zip(*(self.dataset[int(i)] for i in idxs))
                    if not _put((np.stack(xs), np.stack(ys))):
                        return
            except Exception as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                _put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True, name="mmdx-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # runs on normal exhaustion AND on generator close (break/GC):
            # stop the worker and unblock any pending put
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
