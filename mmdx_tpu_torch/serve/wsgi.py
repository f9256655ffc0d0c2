"""WSGI serving app on the PyTorch engine.

Port of ``mmdx_tpu/serve/wsgi.py``: the routes, JSON contracts, micro-batcher
and server are the JAX package's own (``mmdx_tpu.serve.wsgi.DiagnosisApp``,
``mmdx_tpu.runtime.batcher``); this subclass overrides only ``_engine`` to
build the port's engine on ``device`` (the first CUDA card unless the app is
made with, say, ``device="cpu"``). ``main()`` reads the same environment variables
(``PORT``, ``MMDX_ENGINE_MODE`` = parity | fast, ``MMDX_GENERATE``,
``MMDX_GEN_MODE``, ``MMDX_BATCH_WINDOW_MS``, ``MMDX_MAX_BATCH``,
``MMDX_QUEUE_DEPTH``, ``MMDX_REQUEST_TIMEOUT_S``, ``MMDX_PREDICT_TIMEOUT_S``,
``MMDX_WARMUP``, ``MMDX_BUNDLE_PATH``). Multi-device serving
(``MMDX_SERVE_MESH``) is not ported and raises.

    python -m mmdx_tpu_torch.serve.wsgi
"""
from __future__ import annotations

import os

from mmdx_tpu.serve import wsgi as _base


class DiagnosisApp(_base.DiagnosisApp):
    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    def _engine(self):
        from mmdx_tpu_torch.pipelines.inference_pipeline import (get_engine,
                                                                  get_model_bundle)

        if self.mesh is not None or os.getenv("MMDX_SERVE_MESH", "") not in ("", "0"):
            raise NotImplementedError("multi-device serving (MMDX_SERVE_MESH) is not "
                                      "ported to PyTorch yet")
        if self._bundle is None:
            self._bundle = get_model_bundle()
        return get_engine(self._bundle, mode=self.engine_mode, device=self.device)


def make_app(**kwargs) -> DiagnosisApp:
    return DiagnosisApp(**kwargs)


def main():
    """Server: python -m mmdx_tpu_torch.serve.wsgi (env as in the module doc).
    SIGTERM/SIGINT drain the batcher before the process exits."""
    import signal
    import threading

    port = int(os.getenv("PORT", "8000"))
    app = make_app(
        engine_mode=os.getenv("MMDX_ENGINE_MODE", "parity"),
        generate_reports=os.getenv("MMDX_GENERATE", "1") == "1",
        greedy=os.getenv("MMDX_GEN_MODE", "beam") == "greedy",
        batch_window_ms=float(os.getenv("MMDX_BATCH_WINDOW_MS", "5")),
        max_batch=int(os.getenv("MMDX_MAX_BATCH", "32")),
        queue_depth=int(os.getenv("MMDX_QUEUE_DEPTH", "0")),
    )
    server = _base.make_server(
        "0.0.0.0", port, app,
        request_timeout=float(os.getenv("MMDX_REQUEST_TIMEOUT_S", "60")),
    )

    def _shutdown(signum, frame):
        print(f"[mmdx] signal {signum}: draining batcher and stopping")
        if app._batcher is not None:
            app._batcher.stop(drain=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    if os.getenv("MMDX_WARMUP", "1") != "0":
        app.warmup_async()
    print(f"[mmdx] PyTorch port serving on http://0.0.0.0:{port} "
          f"(mode={app.engine_mode}, generate={app.generate_reports})", flush=True)
    try:
        server.serve_forever()
    finally:
        if app._batcher is not None:
            app._batcher.stop(drain=True)


if __name__ == "__main__":
    main()
