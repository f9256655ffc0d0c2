"""``.mmdx`` bundles and the registry between the JAX package and the port,
on the CPU.

* the port's codec (``checkpoints/msgpack_tree.py``, msgpack with flax's
  ext-type hook) against flax's serializer: the same bytes for the same
  tree, chunked arrays included, the same tree back, and truncated or
  trailing bytes and malformed array payloads refused;
* a bundle written by JAX's ``save_bundle`` reads into the same arrays and
  header; a bundle the port writes reads back through JAX's ``load_bundle``;
  the bytes are equal where the header is (all but ``saved_at``);
* registries round-trip both ways, and the port serves an ``.mmdx`` bundle
  (``get_model_bundle``) with the probabilities of the bridge's model;
* the codec and the bundle modules import no flax (nor jax).

Bundles are small-config random weights (``bridge.random_state``), not
flax-initialised ones. Each test is held to 120 s by an alarm, and a
watchdog ends a worker blocked past 180 s.
"""
import ast
import dataclasses
import faulthandler
import json
import signal
import struct
from pathlib import Path

import jax
import numpy as np
import pytest

from mmdx_tpu_torch.checkpoints import bridge, msgpack_tree
from mmdx_tpu_torch.checkpoints import bundle as port_bundle
from mmdx_tpu_torch.checkpoints.train_bridge import flatten

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["62 year old male, cough and fever for 3 days", "chest pain"]


@pytest.fixture(autouse=True)
def time_guard():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture
def bundles(shared_bundles):
    """Shallow copies (a registry's create_model sets the version)."""
    return tuple(dataclasses.replace(b) for b in shared_bundles)


@pytest.fixture(scope="module")
def shared_bundles():
    """(port ModelBundle, JAX ModelBundle) of the same small random weights,
    with metadata."""
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig

    pb = port_bundle.new_random_bundle(seed=4, small=True)
    pb.metadata = {"int8_scales": {"input": 2.5, "stem": 1.25}, "note": "x"}
    jb = ModelBundle(
        config=JaxConfig.from_json(pb.config.to_json()), variables=pb.variables,
        bert_vocab=pb.bert_vocab, t5_vocab=pb.t5_vocab, t5_scores=pb.t5_scores,
        class_names=pb.class_names, thresholds=pb.thresholds, version=3,
        metadata=pb.metadata)
    pb.version = 3
    return pb, jb


def _images():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, (80, 72, 3), dtype=np.uint8),
            rng.integers(0, 256, (64, 64), dtype=np.uint8)]


def _split(payload: bytes):
    (hlen,) = struct.unpack("<Q", payload[8:16])
    header = json.loads(payload[16:16 + hlen])
    header.pop("saved_at")
    return header, payload[16 + hlen:]


def assert_trees_equal(a: dict, b: dict) -> None:
    fa, fb = flatten(a), flatten(b)
    assert list(fa) == list(fb) or set(fa) == set(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "b": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": np.zeros(4, np.float32)},
            "a": {"wide": rng.standard_normal((300, 70)).astype(np.float32),
                  "ints": np.arange(-5, 5, dtype=np.int32),
                  "u8": rng.integers(0, 256, (7,), dtype=np.uint8),
                  "f64": rng.standard_normal(70000),
                  "scalar": np.float32(3.5), "empty": np.zeros((0, 3), np.float32)},
        },
        "many": {str(i): np.ones((i,), np.float32) for i in range(20)},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
                 -32769, -2 ** 31 - 1],
        "f": 1.5, "t": True, "none": None, "long": "a" * 40, "longer": "b" * 300,
    }


def test_codec_matches_flax_bytes_both_ways():
    import msgpack
    from flax import serialization

    tree = _codec_tree()
    ref = msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)
    assert msgpack_tree.dumps(tree) == ref
    back = msgpack_tree.loads(ref)
    restored = serialization.msgpack_restore(msgpack_tree.dumps(tree))
    for got in (back, restored):
        assert got["ints"] == tree["ints"] and got["f"] == 1.5 and got["t"] is True
        assert got["none"] is None and got["longer"] == "b" * 300
        assert_trees_equal({k: got[k] for k in ("params", "many")},
                           {k: tree[k] for k in ("params", "many")})
    assert isinstance(back["params"]["a"]["scalar"], np.float32)


def test_codec_chunked_arrays(monkeypatch):
    from flax import serialization

    monkeypatch.setattr(msgpack_tree, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(70, dtype=np.float32).reshape(10, 7), "s": np.ones(3, np.float32)}
    ref = serialization.to_bytes(dict(tree))  # the bundle's call; chunks in place
    assert msgpack_tree.dumps(tree) == ref
    assert_trees_equal(msgpack_tree.loads(ref), tree)


def test_codec_rejects_truncated_and_trailing_bytes():
    blob = msgpack_tree.dumps({"w": np.ones(5, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_tree.loads(blob[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_tree.loads(blob + b"\x00")


def test_codec_refuses_a_malformed_array_payload():
    """An ndarray payload must be (shape, dtype, bytes) and end with its
    bytes; the arrays read are read-only views of the payload."""
    import msgpack

    def ext(*payload, tail=b""):
        return msgpack.packb({"w": msgpack.ExtType(1, msgpack.packb(payload) + tail)})

    raw = np.arange(4, dtype=np.float32).tobytes()
    back = msgpack_tree.loads(ext((4,), "float32", raw))["w"]
    np.testing.assert_array_equal(back, np.arange(4, dtype=np.float32))
    assert not back.flags.writeable
    with pytest.raises(ValueError, match="shape, dtype, bytes"):
        msgpack_tree.loads(ext((4,), "float32"))
    for bad in (ext((4,), "float32", raw, tail=b"\x00"), ext((4,), "float32", "text")):
        with pytest.raises(ValueError, match="end with its bytes"):
            msgpack_tree.loads(bad)


def test_codec_and_bundle_import_neither_flax_nor_msgpack():
    """Named for its first form: the codec now runs on msgpack, and the
    check is that no bundle module imports flax (nor jax)."""
    for name in ("msgpack_tree", "bundle", "registry", "train_state", "train_bridge"):
        tree = ast.parse((ROOT / "mmdx_tpu_torch" / "checkpoints" / f"{name}.py").read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in ("flax", "jax")], name


# ---------------------------------------------------------------------------
# bundles both ways
# ---------------------------------------------------------------------------
def test_jax_bundle_reads_into_the_port(bundles, tmp_path):
    from mmdx_tpu.checkpoints.bundle import save_bundle

    pb, jb = bundles
    path = save_bundle(jb, tmp_path / "model_bundle.mmdx", timestamped_copy=False)
    got = port_bundle.load_bundle(path)
    assert_trees_equal(got.variables, pb.variables)
    assert got.config == pb.config and got.version == 3
    assert got.bert_vocab == pb.bert_vocab and got.t5_vocab == pb.t5_vocab
    assert got.t5_scores == pb.t5_scores and got.metadata == pb.metadata
    assert got.class_names == pb.class_names and got.thresholds == pb.thresholds
    # written back by the port: the same bytes but for the save time
    again = port_bundle.save_bundle(got, tmp_path / "again.mmdx", timestamped_copy=False)
    ref_header, ref_blob = _split(path.read_bytes())
    header, blob = _split(again.read_bytes())
    assert header == ref_header and blob == ref_blob


def test_port_bundle_reads_back_through_jax(bundles, tmp_path):
    from mmdx_tpu.checkpoints.bundle import load_bundle, save_bundle

    pb, jb = bundles
    path = port_bundle.save_bundle(pb, tmp_path / "model_bundle.mmdx")
    copies = list(tmp_path.glob("model_bundle_*.mmdx"))
    assert len(copies) == 1 and copies[0].read_bytes() == path.read_bytes()
    got = load_bundle(path)
    assert_trees_equal(jax.tree.map(np.asarray, got.variables), pb.variables)
    assert got.config.to_json() == pb.config.to_json() and got.version == 3
    assert got.t5_scores == pb.t5_scores and got.metadata == pb.metadata
    ref = save_bundle(jb, tmp_path / "jax.mmdx", timestamped_copy=False)
    assert _split(ref.read_bytes())[0] == _split(path.read_bytes())[0]


def test_bad_magic_is_refused(tmp_path):
    p = tmp_path / "x.mmdx"
    p.write_bytes(b"NOTMMDX!" + bytes(16))
    with pytest.raises(ValueError, match="magic"):
        port_bundle.load_bundle(p)


def test_assemble_and_split_are_inverse(bundles):
    pb, _ = bundles
    parts = port_bundle.split_variables(pb.variables)
    assert port_bundle.assemble_variables(*parts) == pb.variables


# ---------------------------------------------------------------------------
# registries both ways, and serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_round_trip(bundles, tmp_path, writer):
    from mmdx_tpu.checkpoints.registry import LocalModelRegistry as JaxRegistry
    from mmdx_tpu_torch.checkpoints.registry import LocalModelRegistry

    pb, jb = bundles
    w_reg, w_bundle = ((JaxRegistry, jb) if writer == "jax" else (LocalModelRegistry, pb))
    r_reg = LocalModelRegistry if writer == "jax" else JaxRegistry
    w = w_reg(tmp_path / "reg")
    assert w.create_model("fusion model/T5", w_bundle, metrics={"auroc": 0.5}) == 1
    assert w.create_model("fusion model/T5", w_bundle) == 2
    r = r_reg(tmp_path / "reg")
    assert r.versions("fusion model/T5") == [1, 2]
    assert r.latest_version("fusion model/T5") == 2
    got = r.get_model("fusion model/T5", version=1)
    assert got.version == 1
    assert_trees_equal(jax.tree.map(np.asarray, got.variables), pb.variables)
    assert r.get_metrics("fusion model/T5", 1)["metrics"] == {"auroc": 0.5}
    assert r.get_metrics("fusion model/T5")["model_schema"] == {
        "input": [1, pb.config.fusion.d_img + pb.config.fusion.d_txt], "output": [1, 13]}
    for v in (1, 2):
        d = tmp_path / "reg" / "fusion_model_T5" / f"v{v}"
        assert {p.name for p in d.iterdir()} == {"bundle.mmdx", "config.json",
                                                 "metrics.json"}
    with pytest.raises(LookupError):
        r.latest_version("other")


def test_port_serves_an_mmdx_bundle(bundles, tmp_path, monkeypatch):
    """``get_model_bundle`` loads ``.mmdx`` (JAX-written here) into the same
    model the bridge builds; ``load_model_from_registry`` serves the latest
    version; ``default_bundle_path`` follows MMDX_BUNDLE_PATH."""
    from mmdx_tpu.checkpoints.bundle import save_bundle
    from mmdx_tpu_torch.checkpoints.registry import LocalModelRegistry
    from mmdx_tpu_torch.pipelines import inference_pipeline as ip
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    pb, jb = bundles
    path = save_bundle(jb, tmp_path / "model_bundle.mmdx", timestamped_copy=False)
    monkeypatch.setenv("MMDX_BUNDLE_PATH", str(path))
    assert ip.default_bundle_path() == path
    monkeypatch.delenv("MMDX_BUNDLE_PATH")
    monkeypatch.delenv("CXR_BUNDLE_PATH", raising=False)
    assert ip.default_bundle_path().parts[-3:] == ("mmdx_tpu", "model", "model_bundle.mmdx")
    served = ip.get_model_bundle(path)
    assert served.version == 3 and served.metadata == pb.metadata
    ref = bridge.variables_to_torch(pb.variables, pb.config).state_dict()
    for k, v in served.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    probs, _, _ = InferenceEngine(served, mode="parity", device="cpu").classify_batch(
        _images(), TEXTS)
    ref_probs, _, _ = InferenceEngine(pb.to_torch(), mode="parity",
                                      device="cpu").classify_batch(_images(), TEXTS)
    np.testing.assert_array_equal(probs, ref_probs)
    reg = LocalModelRegistry(tmp_path / "reg")
    reg.create_model(ip.DEFAULT_MODEL_NAME, pb)
    reg.create_model(ip.DEFAULT_MODEL_NAME, pb)
    assert ip.load_model_from_registry(reg).version == 2
    assert ip.load_model_from_registry(reg, version=1).version == 1
