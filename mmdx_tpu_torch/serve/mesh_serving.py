"""Serving on a mesh: rank 0 serves, every other rank follows.

Port of the multi-chip branch of ``mmdx_tpu/serve/wsgi.py`` (``:170-178``)
in the SPMD idiom. Under a launcher (torchrun's ``RANK``/``WORLD_SIZE``, or
``parallel.mesh.launch``) every rank builds the same engine on the mesh.
Rank 0 binds the port and runs the micro-batcher on a ``MeshLeader``: each
engine call the batcher (or the app) makes is first sent to the other ranks
by ``broadcast_object_list`` over a CPU gloo group, then made locally, so
every rank makes the same collective calls in the same order (one call at
a time: the batcher's classify and generate stages take turns). The other
ranks run ``follow(engine)``: the same calls, until the leader's stop
message.
"""
from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

# the engine's entry points that run collectives on a mesh
COLLECTIVE = ("classify_batch", "classify_image_batch", "classify_text_batch",
              "generate_report_ids", "generate_reports", "infer")


def serve_mesh_from_env(device=None):
    """The mesh ``MMDX_SERVE_MESH=<tp>`` asks for (None when unset or 0):
    the process group (``init_world``) and a ("data", "model") mesh of
    model degree tp over every rank. Raises outside a launcher: one process
    cannot drive several ranks here."""
    spec = os.getenv("MMDX_SERVE_MESH", "")
    if spec in ("", "0"):
        return None
    from mmdx_tpu_torch.parallel.mesh import init_world, make_mesh, under_launcher

    if not under_launcher():
        raise RuntimeError(
            f"MMDX_SERVE_MESH={spec} needs one process per rank: start the server "
            "under torchrun (torchrun --nproc-per-node N -m mmdx_tpu_torch.serve.wsgi) "
            "or parallel.mesh.launch")
    init_world(device)
    return make_mesh(n_model=int(spec))


def control_group():
    """A CPU (gloo) group over every rank for the control messages, whose
    waits never time out (a follower waits as long as the server idles); a
    collective call: every rank makes it at the same point."""
    from datetime import timedelta

    return dist.new_group(backend="gloo", timeout=timedelta(days=365))


def _host(x):
    """Tensors travel to the other ranks as CPU tensors."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class MeshLeader:
    """Rank 0's engine: each collective entry point is broadcast to the
    followers before it runs here, under one lock; everything else is the
    engine's."""

    def __init__(self, engine, group=None):
        self.engine, self.group = engine, group
        self._lock = threading.Lock()

    def _send(self, message) -> None:
        dist.broadcast_object_list([message], src=0, group=self.group)

    def __getattr__(self, name):
        attr = getattr(self.engine, name)
        if name not in COLLECTIVE:
            return attr

        def call(*args, **kwargs):
            with self._lock:
                self._send((name, tuple(_host(a) for a in args),
                            {k: _host(v) for k, v in kwargs.items()}))
                return attr(*args, **kwargs)

        return call

    def stop(self) -> None:
        """Release the followers (each returns from ``follow``)."""
        with self._lock:
            self._send(None)


def follower(bundle, mode: str, mesh, device=None) -> int:
    """A following rank's whole life: build the engine on the mesh (as the
    leader's app does), then ``follow`` it. -> the number of calls made."""
    from mmdx_tpu_torch.pipelines.inference_pipeline import get_engine, get_model_bundle

    engine = get_engine(bundle if bundle is not None else get_model_bundle(), mode=mode,
                        mesh=mesh, device=device)
    return follow(engine, control_group())


def follow(engine, group=None) -> int:
    """Make the leader's engine calls on this rank until its stop message.
    -> the number of calls made.

    A call that raises ends this rank with the error: it may have failed
    partway through the call's collectives, which leaves the ranks'
    collective sequences out of step for good, so no rank can serve on.
    The launcher (torchrun, or ``parallel.mesh.launch``) sees the failed
    rank and stops the others."""
    calls = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        if box[0] is None:
            return calls
        name, args, kwargs = box[0]
        getattr(engine, name)(*args, **kwargs)
        calls += 1
