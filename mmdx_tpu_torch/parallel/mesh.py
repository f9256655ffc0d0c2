"""The process group, the ("data", "model") DeviceMesh, and a launcher.

Port of ``mmdx_tpu/parallel/mesh.py`` (``:21-40``). The JAX package is
single-controller: one process reshapes all devices into a ("data",
"model") grid and GSPMD inserts the collectives. Here every rank is a
process of its own under ``torch.distributed`` and the mesh is a
``DeviceMesh`` over the world, rank ``d * n_model + m`` at data index d and
model index m (the JAX grid's row-major order). Batches are split over
"data"; tensor-parallel weight shards ride "model" (``sharding.py``).

* ``init_world(device)`` initialises the default process group, from the
  arguments or from a launcher's environment (torchrun's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). It picks NCCL when
  each rank of the host has a card of its own, and gloo when ranks share a
  card or the caller asked for the CPU; it prints the choice. NCCL
  refuses two ranks on one device, and gloo runs only ``all_reduce`` and
  ``broadcast`` on CUDA tensors, which are the only collectives the port
  uses.
* ``make_mesh(n_model)`` returns the DeviceMesh; ``layout(mesh)`` the
  rank's data and model indices, degrees and groups; ``rows_of`` the rows
  of a batch that belong to a data rank (JAX's ``data_sharded``; a leaf
  that belongs to every rank is JAX's ``replicated``).
* ``launch(fn, world, args)`` runs ``fn(*args)`` on ``world`` new processes,
  each in an initialised group, for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def under_launcher() -> bool:
    """True in a rank of torchrun or ``launch`` (or once a group exists)."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` when given, else its own card (local
    rank modulo the host's cards); without a card there is no quiet CPU
    default."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """-> (backend, why): gloo for CPU ranks and for ranks that share a
    card, NCCL when the host has a card for each of its ranks."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one card each"
    return "gloo", f"{local_world} ranks share {cards} card(s)"


def init_world(device=None, *, rank: int | None = None, world_size: int | None = None,
               store=None, timeout: float = 600.0) -> torch.device:
    """Initialise the default process group on the backend
    ``choose_backend`` picks and return the rank's device.

    ``rank``, ``world_size`` and ``store`` come from the caller (``launch``)
    or, when absent, from torchrun's environment (``env://``); ``timeout``
    bounds each collective's wait. A group that already exists is kept."""
    if rank is not None:
        os.environ.setdefault("LOCAL_RANK", str(rank))
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world_size))
    device = rank_device(device)
    if dist.is_initialized():
        return device
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    backend, why = choose_backend(device, _env_int("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"timeout": timedelta(seconds=timeout)}
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kwargs)
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    if dist.get_rank() == 0:
        print(f"[mmdx] process group: {backend}, {world} rank(s) ({why})",
              file=sys.stderr, flush=True)
    return device


def make_mesh(n_model: int = 1):
    """The ("data", "model") DeviceMesh over the world: ``n_model`` is the
    tensor-parallel degree and must divide the world size; the rest is the
    data-parallel degree."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh.init_world first "
                           "(or run under torchrun or parallel.mesh.launch)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % n_model != 0:
        raise ValueError(f"{n} devices not divisible by model parallelism {n_model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@dataclass(frozen=True)
class Layout:
    """A rank's place in the mesh: degrees, indices and the groups of its
    row ("model": the ranks holding the other shards of its weights) and of
    its column ("data": the ranks holding the other rows of a batch)."""

    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object


def layout(mesh) -> Layout:
    return Layout(dp=mesh[DATA_AXIS].size(), tp=mesh[MODEL_AXIS].size(),
                  data_rank=mesh.get_local_rank(DATA_AXIS),
                  model_rank=mesh.get_local_rank(MODEL_AXIS),
                  data_group=mesh.get_group(DATA_AXIS),
                  model_group=mesh.get_group(MODEL_AXIS))


def rows_of(n: int, dp: int, data_rank: int) -> tuple[int, slice]:
    """-> (the batch padded to a multiple of ``dp``, the slice of its rows
    that data rank ``data_rank`` holds)."""
    padded = -(-n // dp) * dp
    per = padded // dp
    return padded, slice(data_rank * per, (data_rank + 1) * per)


# ---------------------------------------------------------------------------
# launch: a world of spawned ranks
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world: int, workdir: str, fn, args, device,
               init_timeout: float, timeout: float) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    code = 0
    try:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        store.set_timeout(timedelta(seconds=init_timeout))
        init_world(device, rank=rank, world_size=world, store=store, timeout=timeout)
        out = fn(*args)
        tmp = os.path.join(workdir, f"{rank}.tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(out, fh)
        os.replace(tmp, os.path.join(workdir, f"{rank}.out"))
    except BaseException:  # noqa: BLE001 — reported to the launcher, then exit 1
        with open(os.path.join(workdir, f"{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        traceback.print_exc()
        code = 1
    finally:
        if dist.is_initialized() and code == 0:
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def launch(fn, world: int, args: tuple = (), *, device=None, init_timeout: float = 120.0,
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes (spawned), each a rank
    of a fresh process group that meets through a ``FileStore`` in a new
    temporary directory (no port, so parallel test workers never collide).
    ``device`` is each rank's device ("cpu", or None for its card; the
    backend as ``init_world`` chooses it); ``init_timeout`` bounds the
    rendezvous and ``timeout`` the whole run.

    -> the ranks' return values, by rank. Raises if any rank fails (its
    traceback in the message), exits without a result, or is still running
    at ``timeout``; the other ranks are then killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mmdx_world_") as workdir:
        procs = [ctx.Process(target=_rank_main, name=f"mmdx-rank{r}",
                             args=(r, world, workdir, fn, args, device, init_timeout,
                                   timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        problem = None
        while problem is None:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                problem = f"rank(s) {bad} failed (exit codes {[codes[r] for r in bad]})"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                hung = [r for r, c in enumerate(codes) if c is None]
                problem = f"rank(s) {hung} still running after {timeout:.0f} s"
            else:
                time.sleep(0.02)
        if problem is not None:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            errors = []
            for r in range(world):
                path = os.path.join(workdir, f"{r}.err")
                if os.path.exists(path):
                    with open(path) as fh:
                        errors.append(f"--- rank {r} ---\n{fh.read()}")
            raise RuntimeError(f"launch of {world} ranks: {problem}\n" + "\n".join(errors))
        for p in procs:
            p.join()
        results = []
        for r in range(world):
            path = os.path.join(workdir, f"{r}.out")
            if not os.path.exists(path):
                raise RuntimeError(f"launch of {world} ranks: rank {r} exited without a result")
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
        return results
