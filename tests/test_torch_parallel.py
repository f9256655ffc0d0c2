"""The port's multi-device path against the JAX package, on the CPU.

The port runs SPMD: each test world is a set of spawned gloo ranks
(``parallel.mesh.launch``; rank functions in ``torch_oracles/parallel_ranks``,
which imports no jax) on a ("data", "model") DeviceMesh, while the JAX side
runs in this process on the 8 virtual CPU devices (``conftest.py``) and its
results are held against the ranks' as numpy:

* the sharding rules: ``spec_for_path`` and ``variable_shardings`` equal to
  JAX's for every leaf of the small model, the literal cases and the
  divisibility fallback of ``tests/test_sharding.py``; the specs that
  ``shard_model_`` applies to the modules equal the tree's, and a share
  that splits a head is refused;
* classify on the parity engine, worlds (1, 2) and (2, 2), within 1e-5 of
  the JAX engine on the mesh of the same shape at batches 1, 3, 5, 8;
* beam and greedy report ids, token for token, against JAX at model degree
  1 and 2 (batch 5, 10 new tokens);
* K1's and K2's tensor-parallel forms (plain versions) against the
  unsharded plain blocks;
* one joint train step at (1, 2) and (2, 2): against the port's single-rank
  step in f32, and against JAX's ``make_sharded_train_step`` on the 8-device
  mesh at model degree 2 in f64 on both sides (train-mode BatchNorm over
  stage 4's few pixels makes f32 gradients ill-conditioned,
  ``tests/test_torch_training.py``);
* the WSGI app on a (2, 2) world, the followers released at stop; the
  refusals (``MMDX_SERVE_MESH`` outside a launcher, an indivisible model
  degree, a mesh without a process group) and the launcher's (a failing or
  hung rank fails the launch, and so does a follower whose engine call
  fails).

Dropout is 0 in the configuration (JAX's and torch's random streams cannot
match). The worlds launch in a background thread while the JAX side
computes. Each test is held to 150 s by an alarm, and a watchdog ends a
worker blocked past 180 s (the module fixtures arm their own).
"""
import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_oracles import parallel_ranks as ranks

from mmdx_tpu_torch.checkpoints import train_bridge as tb
from mmdx_tpu_torch.parallel import sharding
from mmdx_tpu_torch.parallel.mesh import launch

WORLDS = {(1, 2): ("classify", "generate", "kernels", "train", "refusal"),
          (2, 2): ("classify", "generate", "kernels", "train", "app"),
          (2, 1): ("generate",)}
CLASSIFY_WORLDS = [(1, 2), (2, 2)]
PROBS_TOL = 1e-5  # the JAX sharding test's own (rtol 1e-5, atol 1e-6)
# K1 / K2 tensor-parallel forms against the unsharded plain blocks, bf16
# outputs of magnitude up to ~4: the same rounding points, f32 sums in
# another order before the LayerNorm, so an output lands at most one bf16
# ulp (2^-8 relative) off
TP_BLOCK_ATOL = 4.0 * 2.0 ** -7
# one AdamW step from the first moment: u = g / (|g| + eps) is ~sign(g),
# so an entry whose gradient is at the noise floor can flip by 2 lr; every
# other entry agrees to ordering noise
LOSS_RTOL = 1e-6
# f32 gradients (first moments) relative to a leaf's largest: the partial
# sums over ranks come in another order and travel back through the layers
# (up to 1.2e-4 seen, on the word embeddings' few nonzero rows)
MU_RTOL = 5e-4
MU_RTOL_F64 = 1e-5   # f64 against JAX: f32 rounding points inside both models
PARAM_ATOL = 1e-6
FLIP_SHARE = 1e-3    # |mu| below this share of the leaf's largest may flip sign
STATS_RTOL = 1e-5    # running statistics, relative to a leaf's largest
LRS = {"image": 1e-4, "text": 2e-5, "t5": 2e-5, "fusion_heads": 5e-4}


@contextlib.contextmanager
def watchdog(seconds: int):
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def time_guard():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 150 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(150)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module", autouse=True)
def launched():
    """The port's worlds, launched side by side from background threads
    before the JAX side computes."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(WORLDS))
    futures = {shape: pool.submit(launch, ranks.world, shape[0] * shape[1],
                                  (*shape, jobs), device="cpu", timeout=540)
               for shape, jobs in WORLDS.items()}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(launched, jax_classify, jax_generate, jax_train, single_rank):
    """The ranks' results; the JAX side and the single-rank step are
    computed first, in this process, while the worlds run."""
    with watchdog(600):
        return {shape: f.result(timeout=570) for shape, f in launched.items()}


@pytest.fixture(scope="module")
def jax_bundle(launched):
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu_torch.checkpoints import bridge

    cfg = ranks.small_config()
    tbundle = bridge.bundle_from_variables(ranks.variables(), cfg)
    return ModelBundle(config=JaxConfig.from_json(cfg.to_json()),
                       variables=jax.tree.map(jnp.asarray, ranks.variables()),
                       bert_vocab=tbundle.bert_vocab, t5_vocab=tbundle.t5_vocab,
                       class_names=tbundle.class_names, thresholds=tbundle.thresholds,
                       t5_scores=tbundle.t5_scores)


@pytest.fixture(scope="module")
def jax_classify(jax_bundle):
    """The JAX parity engine on the mesh of each world's shape."""
    from mmdx_tpu.parallel.mesh import make_mesh
    from mmdx_tpu.runtime.engine import InferenceEngine

    imgs, texts = ranks.classify_inputs()
    out = {}
    with watchdog(450):
        for dp, tp in CLASSIFY_WORLDS:
            mesh = make_mesh(n_model=tp, devices=jax.devices()[:dp * tp])
            engine = InferenceEngine(jax_bundle, mode="parity", mesh=mesh)
            out[(dp, tp)] = {n: engine.classify_batch(imgs[:n], texts[:n])[0]
                             for n in ranks.BATCHES}
    return out


@pytest.fixture(scope="module")
def jax_generate(jax_bundle):
    """Beam and greedy ids of the JAX parity engine on the 8-device mesh at
    model degree 1 and 2 (``tests/test_sharding.py:100-134``)."""
    from mmdx_tpu.parallel.mesh import make_mesh
    from mmdx_tpu.runtime.engine import InferenceEngine

    cfg = ranks.small_config()
    zi, zt = ranks.generate_inputs(cfg)
    gen = ranks.short_generation(cfg)
    out = {}
    with watchdog(450):
        for n_model in (1, 2):
            engine = InferenceEngine(jax_bundle, mode="parity",
                                     mesh=make_mesh(n_model=n_model))
            out[n_model] = {g: engine.generate_report_ids(zi, zt, gen=gen, greedy=g)
                            for g in (False, True)}
    return out


@pytest.fixture(scope="module")
def jax_train(launched):
    """One step of JAX's ``make_sharded_train_step`` in f64 on the 8-device
    mesh at model degree 2 -> (loss, params, first moments, batch stats)."""
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.models.diagnosis import MultiModalDiagnosisModel
    from mmdx_tpu.parallel.mesh import make_mesh
    from mmdx_tpu.parallel.sharding import shard_batch, shard_variables
    from mmdx_tpu.parallel.train import build_joint_optimizer, make_sharded_train_step
    from mmdx_tpu.pipelines.training_pipeline import TrainState

    cfg = ranks.small_config()
    batch = ranks.joint_batch(cfg)
    with watchdog(450), jax.enable_x64(True):
        mesh = make_mesh(n_model=2)
        model = MultiModalDiagnosisModel(config=JaxConfig.from_json(cfg.to_json()),
                                         dtype=jnp.float64)
        variables = shard_variables(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                                 ranks.variables()), mesh)
        tx = build_joint_optimizer(variables["params"])
        state = TrainState.create(variables["params"], tx, variables["batch_stats"])
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                  for k, v in batch.items()}
        jbatch = shard_batch(jbatch, mesh)
        step = make_sharded_train_step(model, tx, mesh, state, jbatch)
        new, loss = step(state, jbatch, jax.random.key(1))
        mu = {}
        for label, inner in new.opt_state[1].inner_states.items():
            adam = inner.inner_state[0]
            flat = tb.flatten(jax.tree.map(
                np.asarray, adam.mu, is_leaf=lambda x: x is None))
            mu.update({k: v for k, v in flat.items() if isinstance(v, np.ndarray)})
        return {"loss": float(loss),
                "params": tb.flatten(jax.tree.map(np.asarray, new.params)),
                "mu": mu,
                "stats": tb.flatten(jax.tree.map(np.asarray, new.batch_stats))}


@pytest.fixture(scope="module")
def single_rank(launched):
    """The port's single-rank joint step (f32 and f64) in this process."""
    cfg = ranks.small_config()
    batch = ranks.joint_batch(cfg)
    with watchdog(450):
        return {dt: ranks.train_step(None, getattr(torch, dt), batch)
                for dt in ("float32", "float64")}


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
def small_tree_shapes():
    """Every leaf of the JAX small model (``new_random_bundle(small=True)``'s
    configuration) as a shape, without initialising it."""
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.models.diagnosis import init_diagnosis_model
    from mmdx_tpu_torch.checkpoints import bridge

    cfg = JaxConfig.from_json(bridge.small_config().to_json())
    shapes = jax.eval_shape(lambda: init_diagnosis_model(jax.random.key(0), cfg)[1])
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _paths(tree) -> list[str]:
    return ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_spec_for_path_matches_jax_on_every_leaf():
    from mmdx_tpu.parallel.sharding import spec_for_path

    paths = _paths(small_tree_shapes())
    assert len(paths) > 300
    for path in paths + ["params/" + p for p in paths]:
        assert sharding.spec_for_path(path) == tuple(spec_for_path(path)), path
    assert sum(bool(sharding.spec_for_path(p)) for p in paths) == 2 * 6 + 2 * 10 + 2


def test_spec_literal_cases():
    spec = sharding.spec_for_path
    assert spec("params/text_encoder/bert/layer0/ffn_in/kernel") == (None, "model")
    assert spec("text_encoder/bert/layer3/ffn_out/kernel") == ("model", None)
    assert spec("fusion/report_model/decoder_layer0/self_attn/q/kernel") == (None, "model")
    assert spec("fusion/report_model/decoder_layer0/self_attn/o/kernel") == ("model", None)
    assert spec("fusion/cond_proj/kernel") == (None, "model")
    assert spec("image_encoder/backbone/conv_stem/kernel") == ()
    assert spec("fusion/disease_head/kernel") == ()
    assert spec("text_encoder/bert/word_embeddings/embedding") == ()


@pytest.mark.parametrize("n_model", [2, 4])
def test_variable_shardings_match_jax(n_model):
    """JAX's ``variable_shardings`` on the 8-device mesh and the port's on
    the same degrees agree leaf for leaf, the divisibility fallback
    included ((8, 7) replicates, (8, 8) splits)."""
    from mmdx_tpu.parallel.mesh import make_mesh
    from mmdx_tpu.parallel.sharding import variable_shardings

    mesh = make_mesh(n_model=n_model)
    sizes = {"data": 8 // n_model, "model": n_model}
    tree = small_tree_shapes()
    tree["ffn_in"] = {"kernel": np.zeros((8, 7), np.float32)}
    tree["extra"] = {"ffn_in": {"kernel": np.zeros((8, 8), np.float32)}}
    ours = tb.flatten(sharding.variable_shardings(tree, sizes))
    theirs = jax.tree.map(lambda s: tuple(s.spec), variable_shardings(tree, mesh))
    theirs = dict(zip(_paths(tree), jax.tree_util.tree_leaves(
        theirs, is_leaf=lambda x: isinstance(x, tuple))))
    assert {k.replace(".", "/"): v for k, v in ours.items()} == theirs
    assert ours["ffn_in.kernel"] == () and ours["extra.ffn_in.kernel"] == (None, "model")


def test_joint_batch_matches_jax():
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.parallel.train import make_joint_batch as jax_batch
    from mmdx_tpu_torch.parallel.train import make_joint_batch

    cfg = ranks.small_config()
    key = jax.random.key(3)
    ref = jax_batch(key, JaxConfig.from_json(cfg.to_json()), 4, report_len=8)
    got = make_joint_batch(int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), cfg, 4,
                           report_len=8)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# serving: classify and generate against the JAX engine on a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", CLASSIFY_WORLDS, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_classify_matches_jax_mesh(worlds, jax_classify, shape):
    for rank, out in enumerate(worlds[shape]):
        for n in ranks.BATCHES:
            got, ref = out["classify"][n], jax_classify[shape][n]
            assert got.shape == (n, 13), (rank, n)
            np.testing.assert_allclose(got, ref, rtol=PROBS_TOL, atol=PROBS_TOL,
                                       err_msg=f"rank {rank}, batch {n}")


@pytest.mark.parametrize("shape", list(WORLDS), ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_generate_matches_jax(worlds, jax_generate, shape):
    """Token for token with JAX at the same model degree, on every rank."""
    for rank, out in enumerate(worlds[shape]):
        for greedy in (False, True):
            ids = out["generate"][greedy]
            assert ids.shape == (5, 11)
            np.testing.assert_array_equal(ids, jax_generate[shape[1]][greedy],
                                          err_msg=f"rank {rank}, greedy={greedy}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_tp_blocks_match_unsharded_plain(worlds, shape):
    for out in worlds[shape]:
        assert out["kernels"]["attn"] <= TP_BLOCK_ATOL, out["kernels"]
        assert out["kernels"]["ffn"] <= TP_BLOCK_ATOL, out["kernels"]


# ---------------------------------------------------------------------------
# the joint train step
# ---------------------------------------------------------------------------
def _lr_of(key: str) -> float:
    if key.startswith("image_encoder"):
        return LRS["image"]
    if key.startswith("text_encoder"):
        return LRS["text"]
    return LRS["t5"] if key.startswith("fusion.report_model") else LRS["fusion_heads"]


def assert_step_close(got: dict, ref: dict, mu_rtol: float,
                      conditioned=lambda key: True) -> None:
    """Loss, first moments (the clipped gradients), updated parameters
    (flip-aware, see FLIP_SHARE) and batch statistics of one step. A leaf
    that is not ``conditioned`` (the image tower's in f32) is held only to
    the bound of one step's update, 2 lr."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    mu, mu_ref = tb.flatten(got["mu"]), ref["mu"]
    params = tb.flatten(got["params"])
    assert set(mu) == set(mu_ref) == set(params) == set(ref["params"])
    floor = 1e-3 * max(np.abs(v).max() for v in mu_ref.values())
    for k, v in mu_ref.items():
        diff = np.abs(params[k] - ref["params"][k])
        if not conditioned(k):
            assert diff.max() <= 2 * _lr_of(k) + PARAM_ATOL, k
            continue
        top = max(np.abs(v).max(), floor)
        assert np.abs(mu[k] - v).max() <= mu_rtol * top, k
        flip = np.abs(v) <= FLIP_SHARE * top
        assert diff[~flip].max(initial=0) <= PARAM_ATOL, k
        assert diff[flip].max(initial=0) <= 2 * _lr_of(k) + PARAM_ATOL, k
    stats = tb.flatten(got["stats"])
    assert set(stats) == set(ref["stats"])
    for k, v in ref["stats"].items():  # relative to the leaf's largest
        assert np.abs(stats[k] - v).max() <= STATS_RTOL * np.abs(v).max(), k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_train_step_matches_single_rank(worlds, single_rank, shape, dtype):
    """In f32 the image tower's gradients are ill-conditioned (train-mode
    BatchNorm, see the module note: the sums over ranks move them by up to
    15% of a leaf's largest), so there its parameters are held to one
    step's bound; f64 holds every leaf tightly."""
    ref = single_rank[dtype]
    ref = {"loss": ref["loss"], "mu": tb.flatten(ref["mu"]),
           "params": tb.flatten(ref["params"]), "stats": tb.flatten(ref["stats"])}
    f32 = dtype == "float32"
    for out in worlds[shape]:
        assert_step_close(out["train"][dtype], ref, MU_RTOL if f32 else MU_RTOL_F64,
                          lambda k: not (f32 and k.startswith("image_encoder")))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_train_step_matches_jax_sharded_f64(worlds, jax_train, shape):
    ref = {"loss": jax_train["loss"], "mu": jax_train["mu"],
           "params": jax_train["params"], "stats": jax_train["stats"]}
    for out in worlds[shape]:
        assert_step_close(out["train"]["float64"], ref, MU_RTOL_F64)


def test_single_rank_step_matches_jax_f64(single_rank, jax_train):
    ref = {"loss": jax_train["loss"], "mu": jax_train["mu"],
           "params": jax_train["params"], "stats": jax_train["stats"]}
    assert_step_close(single_rank["float64"], ref, MU_RTOL_F64)


# ---------------------------------------------------------------------------
# the app, the refusals, the launcher
# ---------------------------------------------------------------------------
def test_app_on_a_mesh(worlds):
    from mmdx_tpu_torch.config import DISEASES

    leader, *followers = [out["app"] for out in worlds[(2, 2)]]
    status, payload = leader
    assert status.startswith("200"), payload
    assert [d["name"] for d in payload["diseases"]] == DISEASES
    assert isinstance(payload["report_text"], str)
    # each follower made the leader's two engine calls, then left at stop
    assert followers == [("followed", 2)] * 3


def test_serve_mesh_needs_a_launcher(monkeypatch):
    from mmdx_tpu_torch.serve.wsgi import make_app

    monkeypatch.setenv("MMDX_SERVE_MESH", "2")
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_app(device="cpu")._engine()


def test_make_mesh_refusals(worlds):
    from mmdx_tpu_torch.parallel.mesh import make_mesh

    for out in worlds[(1, 2)]:
        assert out["refusal"] == "2 devices not divisible by model parallelism 3"
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)


def test_a_failing_follower_ends_its_rank():
    """A follower whose engine call raises exits with the error (the ranks'
    collectives would be out of step), so the launcher fails the world."""
    with pytest.raises(RuntimeError,
                       match=r"rank\(s\) \[(0, )?1\] failed(?s:.*)engine fault on rank 1"):
        launch(ranks.follower_fails, 2, device="cpu", timeout=60)


def test_launch_fails_with_a_failing_or_hung_rank():
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] failed(?s:.*)rank 1 gives up"):
        launch(ranks.fail_on_rank_1, 2, device="cpu", timeout=60)
    # rank 1 returns at once; under load both may still be starting
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0(, 1)?\] still running"):
        launch(ranks.hang_on_rank_0, 2, device="cpu", timeout=8)


def small_model():
    from mmdx_tpu_torch.models.diagnosis import DiagnosisModel

    return DiagnosisModel(ranks.small_config())


@pytest.mark.parametrize("tp", [2, 4, 3])
def test_dense_specs_match_the_tree_rules(tp):
    """The specs ``shard_model_`` applies to the modules, found by their JAX
    paths, are the tree's (``variable_shardings``) for every kernel, and
    every kernel the rules shard in the tree has a module (k and v ride
    the merged ``attn_qkv`` under q's path)."""
    tree = {k.replace(".", "/"): v for k, v in tb.flatten(sharding.variable_shardings(
        ranks.variables(), {"data": 1, "model": tp})).items()}
    specs = sharding.dense_specs(small_model(), tp)
    for path, spec in specs.items():
        assert tree["params/" + path] == spec, path
    ruled = {p[len("params/"):] for p, s in tree.items()
             if s and not re.search(r"attn_[kv]/", p)}
    assert ruled == {p for p, s in specs.items() if s}
    assert bool(ruled) == (tp != 3)  # the small widths do not divide by 3


def test_shard_model_refuses_split_heads():
    """4 heads of 16 over 8 model ranks: the width divides, the heads do
    not, and a rank cannot hold half a head."""
    model = small_model()
    with pytest.raises(ValueError, match=r"units of 16 \(heads\) cannot be split over 8"):
        sharding.shard_model_(model, sharding.dense_specs(model, 8),
                              sharding.ModelShard(None, 0, 8))


def test_contracts_under_tp():
    from mmdx_tpu_torch.config import DiagnosisConfig
    from mmdx_tpu_torch.runtime.contracts import first_unmet_contract, tp_plan

    cfg = DiagnosisConfig()  # BERT-base: 12 heads of 64, intermediate 3072
    assert first_unmet_contract(cfg, "fast", tp=2) is None
    assert first_unmet_contract(cfg, "fast", tp=4) is None
    why = first_unmet_contract(cfg, "fast", tp=8)  # 1.5 heads a rank
    assert "K1's tensor-parallel form" in why
    wide = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, intermediate_size=3136))
    assert "K2's tensor-parallel form" in first_unmet_contract(wide, "fast", tp=2)
    # widths the divisibility check replicates are not refused
    odd = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, intermediate_size=3008))
    assert first_unmet_contract(odd, "fast", tp=3) is None
    assert first_unmet_contract(wide, "parity", tp=8) is None
    # what each mode shards, and the layers it names as whole
    specs = sharding.dense_specs(small_model(), 2)
    applied, fast = tp_plan(specs, "fast")
    assert any(s.startswith("T5 decoder (K4") for s in fast)
    assert any(s.startswith("image tower") for s in fast)
    assert not any(s for p, s in applied.items() if p.startswith("fusion/report_model/"))
    assert applied["text_encoder/bert/layer0/attn_q/kernel"] == (None, "model")
    applied, parity = tp_plan(specs, "parity")
    assert applied == specs and not any(s.startswith("T5") for s in parity)
    applied, turbo = tp_plan(specs, "turbo", text_int8=True)
    assert any("W8A8" in s for s in turbo)
    assert not any(s for p, s in applied.items() if p.startswith("text_encoder/"))
    _, odd_whole = tp_plan(sharding.dense_specs(small_model(), 3), "parity")
    assert "text_encoder/bert/layer*/ffn_in/kernel (its width does not divide over the " \
        "model ranks)" in odd_whole
