"""Rank functions of the port's multi-device tests (no jax: the ranks are
spawned processes of ``mmdx_tpu_torch.parallel.mesh.launch``).

``world(dp, tp, jobs)`` runs on every rank of a (dp, tp) world and returns
numpy results for the test process, which holds them against the JAX
package: classify and generate on the parity engine, the tensor-parallel
forms of K1 and K2 (plain versions) against the unsharded blocks, one joint
train step, the WSGI app, and the mesh's refusal of an indivisible degree.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

BATCHES = (1, 3, 5, 8)


def small_config():
    """The small configuration without dropout (JAX's and torch's random
    streams cannot match)."""
    from mmdx_tpu_torch.checkpoints import bridge

    cfg = bridge.small_config()
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, hidden_dropout=0.0),
        fusion=dataclasses.replace(cfg.fusion, dropout=0.0))


def variables():
    from mmdx_tpu_torch.checkpoints import bridge

    return bridge.random_state(small_config(), 1)


def classify_inputs(n: int = 8):
    rng = np.random.default_rng(0)
    return ([rng.integers(0, 256, (96, 96), dtype=np.uint8) for _ in range(n)],
            [f"patient {i} cough fever" for i in range(n)])


def generate_inputs(cfg, n: int = 5):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((n, cfg.fusion.d_img)).astype(np.float32),
            rng.standard_normal((n, cfg.fusion.d_txt)).astype(np.float32))


def short_generation(cfg):
    return dataclasses.replace(cfg.generation, max_new_tokens=10, min_new_tokens=4)


def joint_batch(cfg):
    from mmdx_tpu_torch.parallel.train import make_joint_batch

    batch = make_joint_batch(7, cfg, 8, report_len=8)
    batch["report_labels"][:, 6:] = -100  # a padded tail: the CE's valid count
    return batch


def train_step(mesh, dtype, batch):
    """One joint step -> (loss, the whole params, the whole first moments
    (0.1 x the clipped gradients), the whole batch statistics)."""
    from mmdx_tpu_torch.checkpoints.train_bridge import joint_vars_of
    from mmdx_tpu_torch.parallel.sharding import unshard_variables
    from mmdx_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    state = TrainState.create(variables(), small_config(), mesh, dtype=dtype)
    state, loss = make_sharded_train_step(mesh)(state, batch, 3)
    params = list(state.model.parameters())
    kept = [p.data for p in params]
    for p in params:  # the first moments in the parameters' places, for the bridge
        p.data = state.optimizer.state[p]["exp_avg"]
    mu = joint_vars_of(state.model)
    for p, data in zip(params, kept):
        p.data = data
    if mesh is not None:
        mu = unshard_variables(mu, state.specs, mesh)
    whole = state.variables(mesh)
    return {"loss": loss, "params": whole["params"], "mu": mu["params"],
            "stats": whole["batch_stats"]}


def _predict(app):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (120, 100, 3), dtype=np.uint8)).save(buf, "PNG")
    boundary = b"parallelboundary"
    body = b"\r\n".join([
        b"--" + boundary, b'Content-Disposition: form-data; name="patient_details"',
        b"", b"31 year old male, cough",
        b"--" + boundary,
        b'Content-Disposition: form-data; name="image"; filename="x.png"',
        b"Content-Type: image/png", b"", buf.getvalue(), b"--" + boundary + b"--"])
    status = {}
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/api/predict/",
               "CONTENT_TYPE": "multipart/form-data; boundary=" + boundary.decode(),
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    raw = b"".join(app(environ, lambda s, h: status.setdefault("s", s)))
    return status["s"], json.loads(raw)


def tp_blocks(mesh) -> dict:
    """K1's and K2's tensor-parallel forms (their plain versions on the
    CPU, bf16) on this rank's shard of random weights against the unsharded
    plain blocks -> the largest absolute difference of each."""
    from mmdx_tpu_torch.ops import bert_attn, fused_ffn
    from mmdx_tpu_torch.parallel.sharding import model_shard

    shard = model_shard(mesh)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    m, h, f, heads, seq = 96, 128, 256, 2, 48

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(bf)

    x = randn(m, h)
    kmask = torch.zeros(m)
    kmask[seq - 5:seq] = -1e9
    wqkv, bqkv = randn(h, 3 * h, scale=h ** -0.5), randn(3 * h, scale=0.1)
    wo, bo = randn(h, h, scale=h ** -0.5), randn(h, scale=0.1)
    wi, bi = randn(h, f, scale=h ** -0.5), randn(f, scale=0.1)
    wf = randn(f, h, scale=f ** -0.5)
    ln_s, ln_b = 1 + randn(h, scale=0.1), randn(h, scale=0.1)
    qkv_cols = torch.cat([shard.cols(h, i * h) for i in range(3)])
    rows_h, cols_f = shard.cols(h), shard.cols(f)
    attn = bert_attn.fused_attention_block(
        x, kmask, wqkv[:, qkv_cols], bqkv[qkv_cols], wo[rows_h], bo, ln_s, ln_b,
        seq_len=seq, num_heads=heads // shard.size, group=shard.group)
    attn_ref = bert_attn.fused_attention_block_plain(x, kmask, wqkv, bqkv, wo, bo, ln_s,
                                                     ln_b, seq_len=seq, num_heads=heads)
    ffn = fused_ffn.fused_ffn_ln(x, wi[:, cols_f], bi[cols_f], wf[cols_f], bo, ln_s, ln_b,
                                 group=shard.group)
    ffn_ref = fused_ffn.fused_ffn_ln_plain(x, wi, bi, wf, bo, ln_s, ln_b)
    return {"attn": float((attn.float() - attn_ref.float()).abs().max()),
            "ffn": float((ffn.float() - ffn_ref.float()).abs().max())}


def world(dp: int, tp: int, jobs: tuple) -> dict:
    """Every rank of a (dp, tp) world: the jobs asked for -> numpy results."""
    import torch.distributed as dist

    from mmdx_tpu_torch.checkpoints import bridge
    from mmdx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_model=tp)
    cfg = small_config()
    out = {}
    if "classify" in jobs or "generate" in jobs:
        from mmdx_tpu_torch.runtime.engine import InferenceEngine

        engine = InferenceEngine(bridge.bundle_from_variables(variables(), cfg),
                                 mode="parity", device="cpu", mesh=mesh)
        imgs, texts = classify_inputs()
        if "classify" in jobs:
            out["classify"] = {n: engine.classify_batch(imgs[:n], texts[:n])[0]
                               for n in BATCHES}
        if "generate" in jobs:
            zi, zt = generate_inputs(cfg)
            gen = short_generation(cfg)
            out["generate"] = {g: engine.generate_report_ids(zi, zt, gen=gen, greedy=g)
                               for g in (False, True)}
    if "kernels" in jobs:
        out["kernels"] = tp_blocks(mesh)
    if "train" in jobs:
        batch = joint_batch(cfg)
        out["train"] = {dt: train_step(mesh, getattr(torch, dt), batch)
                        for dt in ("float32", "float64")}
    if "app" in jobs:
        from mmdx_tpu_torch.serve import mesh_serving
        from mmdx_tpu_torch.serve.wsgi import make_app

        bundle = bridge.bundle_from_variables(variables(), cfg)
        gen = dict(max_new_tokens=6, min_new_tokens=1, num_beams=2)
        if dist.get_rank() == 0:
            app = make_app(bundle=bundle, engine_mode="parity", gen_overrides=gen,
                           mesh=mesh, device="cpu")
            out["app"] = _predict(app)
            app.close()
        else:
            out["app"] = ("followed", mesh_serving.follower(bundle, "parity", mesh, "cpu"))
    if "refusal" in jobs:
        try:
            make_mesh(n_model=dist.get_world_size() + 1)
        except ValueError as err:
            out["refusal"] = str(err)
    return out


def fail_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    return "done"


def hang_on_rank_0():
    import time

    import torch.distributed as dist

    while dist.get_rank() == 0:
        time.sleep(1)
    return "done"


class _EngineFailingOnRank1:
    def classify_batch(self, *args):
        import torch.distributed as dist

        if dist.get_rank() == 1:
            raise RuntimeError("engine fault on rank 1")
        return "ok"


def follower_fails():
    """Rank 0 leads one engine call that fails on rank 1 alone, then stops;
    rank 1 follows."""
    import torch.distributed as dist

    from mmdx_tpu_torch.serve.mesh_serving import MeshLeader, follow

    engine = _EngineFailingOnRank1()
    if dist.get_rank() != 0:
        return follow(engine)
    leader = MeshLeader(engine)
    leader.classify_batch([], [])
    leader.stop()
    return "led"
