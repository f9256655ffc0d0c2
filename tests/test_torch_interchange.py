"""The reference interchange on the port against the JAX package, on the CPU.

* ``bundle_to_torch`` (``model_bundle.pt``) and ``bundle_to_torch_registry_dir``
  of the same small bundle write the same state-dict keys and bit-equal
  arrays in both packages (the port's side through its ``python -m`` CLI),
  the same reference cfg, and the same ``t5_assets/spiece.model`` bytes;
* each package's importer (``bundle_from_torch``,
  ``bundle_from_torch_registry_dir``) reads either package's files into the
  same variables, bit for bit, which hold every exported leaf unchanged;
* ``spm_reader`` writes the same bytes and reads the same pieces, scores and
  types as the JAX module;
* ``bundle_from_pretrained`` grafts the same trunks as JAX from the same
  injected state dicts (whole, partial, and refused on a wrong shape), both
  starting from the same random variables;
* a registry directory without a tower is refused;
* ``get_model_bundle`` serves a ``model_bundle.pt`` with the weights the
  ``.mmdx`` route serves.

Bundles are small-config random weights (``bridge.random_state``); the JAX
``ModelBundle`` holds the same arrays. Each test is held to 120 s by an
alarm, and a watchdog ends a worker blocked past 180 s.
"""
import copy
import dataclasses
import faulthandler
import json
import signal

import numpy as np
import pytest
import torch

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.checkpoints import bundle as port_bundle
from mmdx_tpu_torch.checkpoints import torch_export as port_export
from mmdx_tpu_torch.checkpoints.train_bridge import flatten
from mmdx_tpu_torch.text import spm_reader as port_spm


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


def jax_bundle_of(pb):
    """The JAX package's ModelBundle over the port bundle's arrays."""
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig

    return ModelBundle(
        config=JaxConfig.from_json(pb.config.to_json()), variables=pb.variables,
        bert_vocab=pb.bert_vocab, t5_vocab=pb.t5_vocab, t5_scores=pb.t5_scores,
        class_names=pb.class_names, thresholds=pb.thresholds, version=pb.version,
        metadata=pb.metadata)


@pytest.fixture(scope="module")
def bundles():
    pb = port_bundle.new_random_bundle(seed=7, small=True)
    pb.version = 4
    return pb, jax_bundle_of(pb)


def assert_trees_equal(a: dict, b: dict) -> None:
    fa, fb = flatten(a), flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_subtree(got: dict, want: dict) -> None:
    """Every leaf of ``want`` is in ``got``, bit-equal (an import adds the
    inert T5 encoder and the tied lm_head alias that the export writes)."""
    fg = flatten(got)
    for k, v in flatten(want).items():
        np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(v), err_msg=k)


def assert_state_dicts_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["model_bundle.pt", "registry_dir"])
def test_exports_match_jax(bundles, tmp_path, fmt):
    from mmdx_tpu.checkpoints import torch_export as jax_export

    pb, jb = bundles
    src = port_bundle.save_bundle(pb, tmp_path / "b.mmdx", timestamped_copy=False)
    if fmt == "model_bundle.pt":
        port_export.main([str(src), str(tmp_path / "port.pt")])
        jax_export.bundle_to_torch(jb, tmp_path / "jax.pt")
        got, ref = (torch.load(tmp_path / f"{w}.pt", weights_only=False)
                    for w in ("port", "jax"))
        assert list(got) == list(ref)
        for key in ("fusion_state", "image_state", "text_state"):
            assert_state_dicts_equal(got[key], ref[key])
        for key in ("cfg", "t5_tokenizer_name", "bert_tokenizer_name", "version"):
            assert got[key] == ref[key], key
        assert got["version"] == 4
        assert not list(tmp_path.glob("*.tmp"))
    else:
        port_export.main([str(src), str(tmp_path / "port"), "--registry-dir"])
        jax_export.bundle_to_torch_registry_dir(jb, tmp_path / "jax")
        names = {"fusion_model.pt", "image_encoder.pt", "text_encoder.pt", "config.json",
                 "t5_assets"}
        for w in ("port", "jax"):
            assert {p.name for p in (tmp_path / w).iterdir()} == names
        for name in ("fusion_model.pt", "image_encoder.pt", "text_encoder.pt"):
            assert_state_dicts_equal(torch.load(tmp_path / "port" / name),
                                     torch.load(tmp_path / "jax" / name))
        for name in ("config.json", "t5_assets/spiece.model"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name


def tensors_of(tree: dict) -> dict:
    return {k: tensors_of(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("tower", ["image", "text", "fusion"])
def test_exporters_take_tensor_leaves(bundles, tower):
    """A tree of torch tensors exports as the tree of numpy arrays does."""
    pb, _ = bundles
    variables = dict(zip(("image", "text", "fusion"),
                         port_bundle.split_variables(pb.variables)))[tower]
    export = {"image": port_export.export_image_encoder,
              "text": port_export.export_text_encoder,
              "fusion": port_export.export_fusion}[tower]
    ref, got = export(variables), export(tensors_of(variables))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# import, both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["model_bundle.pt", "registry_dir"])
def test_both_importers_read_either_packages_files(bundles, tmp_path, writer, fmt):
    from mmdx_tpu.checkpoints import bundle as jax_bundle
    from mmdx_tpu.checkpoints import torch_export as jax_export

    pb, jb = bundles
    exporter = jax_export if writer == "jax" else port_export
    b = jb if writer == "jax" else pb
    layers = pb.config.report.num_layers
    if fmt == "model_bundle.pt":
        path = exporter.bundle_to_torch(b, tmp_path / "model_bundle.pt")
        got = port_bundle.bundle_from_torch(path, t5_num_layers=layers)
        ref = jax_bundle.bundle_from_torch(path, t5_num_layers=layers)
        assert got.version == ref.version == 4
    else:
        path = exporter.bundle_to_torch_registry_dir(b, tmp_path / "registry")
        got = port_bundle.bundle_from_torch_registry_dir(path, version=9,
                                                         t5_num_layers=layers)
        ref = jax_bundle.bundle_from_torch_registry_dir(path, version=9,
                                                        t5_num_layers=layers)
        assert got.version == ref.version == 9
        # the real vocab and scores rode through t5_assets/spiece.model
        assert got.t5_vocab == pb.t5_vocab
        assert got.t5_scores == {i: float(np.float32(s)) for i, s in pb.t5_scores.items()}
    assert_trees_equal(got.variables, ref.variables)
    assert_subtree(got.variables, pb.variables)
    assert json.loads(got.config.to_json()) == json.loads(ref.config.to_json())
    assert (got.bert_vocab, got.t5_vocab, got.t5_scores) == \
        (ref.bert_vocab, ref.t5_vocab, ref.t5_scores)
    assert (got.class_names, got.thresholds, got.metadata) == \
        (ref.class_names, ref.thresholds, ref.metadata)
    assert got.config.fusion == pb.config.fusion
    assert got.config.text.max_len == pb.config.text.max_len


@pytest.mark.parametrize("missing", ["image_encoder.pt", "text_encoder.pt"])
def test_registry_dir_without_a_tower_is_refused(bundles, tmp_path, missing):
    pb, _ = bundles
    d = port_export.bundle_to_torch_registry_dir(pb, tmp_path / "registry")
    (d / missing).unlink()
    with pytest.raises(ValueError, match="image_encoder.pt and text_encoder.pt"):
        port_bundle.bundle_from_torch_registry_dir(d)


def test_bundle_pt_missing_key_is_refused(bundles, tmp_path):
    pb, _ = bundles
    path = port_export.bundle_to_torch(pb, tmp_path / "model_bundle.pt")
    blob = torch.load(path, weights_only=False)
    del blob["text_state"]
    torch.save(blob, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="text_state"):
        port_bundle.bundle_from_torch(tmp_path / "bad.pt")


def test_get_model_bundle_serves_model_bundle_pt(bundles, tmp_path, monkeypatch):
    """The reference file and the ``.mmdx`` file of one bundle serve the
    same weights (the inert encoder the export adds is not served). The
    reference cfg has no depths, so the small bundle's config is put back
    on the imported bundle."""
    from mmdx_tpu_torch.pipelines import inference_pipeline as ip

    pb, _ = bundles

    def imported(path):
        return dataclasses.replace(port_bundle.bundle_from_torch(path), config=pb.config)

    monkeypatch.setattr(ip, "bundle_from_torch", imported)
    mmdx = port_bundle.save_bundle(pb, tmp_path / "b.mmdx", timestamped_copy=False)
    pt = port_export.bundle_to_torch(pb, tmp_path / "model_bundle.pt")
    a, b = ip.get_model_bundle(mmdx), ip.get_model_bundle(pt)
    assert b.version == 4 and b.metadata == {"imported_from": "torch_model_bundle"}
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    assert all("report_model.encoder" in k for k in set(sb) - set(sa))


# ---------------------------------------------------------------------------
# spiece.model
# ---------------------------------------------------------------------------
def test_spm_reader_matches_jax(tmp_path):
    from mmdx_tpu.text import spm_reader as jax_spm

    _, t5, scores = bridge.default_vocabs()
    inv = {i: t for t, i in t5.items()}
    pieces = [(inv[i], scores.get(i, 0.0)) for i in sorted(inv)]
    types = [port_spm.UNKNOWN if t == "<unk>" else port_spm.CONTROL
             if t.startswith("<") and t.endswith(">") else port_spm.NORMAL for t, _ in pieces]
    a = port_spm.write_spiece_model(pieces, tmp_path / "port.model", types=types)
    b = jax_spm.write_spiece_model(pieces, tmp_path / "jax.model", types=types)
    assert a.read_bytes() == b.read_bytes()
    got = port_spm.read_spiece_pieces(b)
    assert got == jax_spm.read_spiece_pieces(a)
    assert [g[2] for g in got] == types and len(got) == len(t5)
    assert port_spm.read_spiece_vocab(a) == jax_spm.read_spiece_vocab(a)
    # untyped pieces and an unknown field skipped on read
    c = port_spm.write_spiece_model(pieces[:5], tmp_path / "c.model")
    d = jax_spm.write_spiece_model(pieces[:5], tmp_path / "d.model")
    assert c.read_bytes() == d.read_bytes()
    extra = c.read_bytes() + b"\x10\x05"  # field 2 varint: skipped
    (tmp_path / "e.model").write_bytes(extra)
    assert port_spm.read_spiece_pieces(tmp_path / "e.model") == \
        jax_spm.read_spiece_pieces(tmp_path / "e.model")


def test_spiece_round_trip_drives_the_unigram_tokenizer(tmp_path):
    from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer

    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
              ("▁ab", -1.0), ("c", -3.0), ("▁a", -1.5), ("bc", -1.0)]
    types = [port_spm.CONTROL] * 3 + [port_spm.NORMAL] * 4
    p = port_spm.write_spiece_model(pieces, tmp_path / "spiece.model", types=types)
    got = port_spm.read_spiece_pieces(p)
    assert [(g[0], g[1]) for g in got] == [(t, pytest.approx(s)) for t, s in pieces]
    assert [g[2] for g in got] == types
    vocab, scores = port_spm.read_spiece_vocab(p)
    tok = T5StyleTokenizer(vocab=vocab, scores=scores)
    assert tok.algorithm == "unigram"
    assert tok.tokenize("abc") == ["▁a", "bc"]


# ---------------------------------------------------------------------------
# pretrained trunks
# ---------------------------------------------------------------------------
def torchvision_resnet50_sd(seed: int = 0) -> dict:
    """A state dict with torchvision resnet50's keys and shapes (fc
    included, which the importer drops)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.02)

    def bn(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(c), t(c)
        sd[f"{prefix}.running_mean"] = t(c)
        sd[f"{prefix}.running_var"] = torch.ones(c)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = t(64, 3, 7, 7)
    bn("bn1", 64)
    cin = 64
    for s, n_blocks in enumerate((3, 4, 6, 3)):
        mid, out = 64 * 2 ** s, 256 * 2 ** s
        for b in range(n_blocks):
            p = f"layer{s + 1}.{b}"
            sd[f"{p}.conv1.weight"] = t(mid, cin, 1, 1)
            bn(f"{p}.bn1", mid)
            sd[f"{p}.conv2.weight"] = t(mid, mid, 3, 3)
            bn(f"{p}.bn2", mid)
            sd[f"{p}.conv3.weight"] = t(out, mid, 1, 1)
            bn(f"{p}.bn3", out)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = t(out, cin, 1, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    sd["fc.weight"], sd["fc.bias"] = t(1000, 2048), t(1000)
    return sd


@pytest.fixture(scope="module")
def trunks():
    """(resnet, bert, t5) state dicts in the torchvision and HF layouts at the
    small config's widths, from other random weights than the base bundle's."""
    other = bridge.random_state(bridge.small_config(), seed=5)["params"]
    tensors = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # noqa: E731
    bert = tensors(port_export.export_hf_bert(other["text_encoder"]["bert"]))
    t5 = tensors(port_export.export_hf_t5(other["fusion"]["report_model"]))
    return torchvision_resnet50_sd(), bert, t5


@pytest.mark.parametrize("case", ["all", "partial", "refused"])
def test_bundle_from_pretrained_matches_jax(trunks, monkeypatch, case):
    from mmdx_tpu.checkpoints import pretrained as jax_pretrained
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu_torch.checkpoints import pretrained as port_pretrained

    config = bridge.small_config()

    def jax_base(seed=0, config=None):
        """The JAX graft starts from the port's random variables (a flax
        init would differ, and the trunks replace them anyway)."""
        pb = port_bundle.new_random_bundle(seed=seed, config=bridge.small_config())
        return dataclasses.replace(jax_bundle_of(pb), config=config,
                                   variables=copy.deepcopy(pb.variables))

    monkeypatch.setattr(jax_pretrained, "new_random_bundle", jax_base)
    resnet, bert, t5 = trunks
    if case == "all":
        kw = dict(resnet=resnet, bert=bert, t5=t5)
    elif case == "partial":  # one tower, under BertForPreTraining's prefix
        kw = dict(bert={f"bert.{k}": v for k, v in bert.items()})
    else:
        kw = dict(bert=dict(bert, **{"embeddings.word_embeddings.weight":
                                     torch.zeros(17, config.text.hidden_size)}))
    if case == "refused":
        with pytest.raises(ValueError, match="word_embeddings") as got:
            port_pretrained.bundle_from_pretrained(config=config, **kw)
        with pytest.raises(ValueError) as ref:
            jax_pretrained.bundle_from_pretrained(
                config=JaxConfig.from_json(config.to_json()), **kw)
        assert str(got.value) == str(ref.value)
        return
    got = port_pretrained.bundle_from_pretrained(config=config, seed=3, **kw)
    ref = jax_pretrained.bundle_from_pretrained(
        config=JaxConfig.from_json(config.to_json()), seed=3, **kw)
    assert_trees_equal(got.variables, ref.variables)
    assert got.metadata == ref.metadata
    base = port_bundle.new_random_bundle(seed=3, config=config).variables["params"]
    p = got.variables["params"]
    # the heads stay fresh; the grafted trunks are the checkpoint's
    np.testing.assert_array_equal(p["fusion"]["disease_head"]["kernel"],
                                  base["fusion"]["disease_head"]["kernel"])
    np.testing.assert_array_equal(p["text_encoder"]["bert"]["layer1"]["ffn_in"]["kernel"],
                                  bert["encoder.layer.1.intermediate.dense.weight"].numpy().T)
    if case == "all":
        assert got.metadata["pretrained"] == {"image_backbone": "pretrained",
                                              "text_backbone": "pretrained",
                                              "report_model": "pretrained"}
        np.testing.assert_array_equal(
            p["image_encoder"]["backbone"]["conv_stem"]["kernel"],
            np.transpose(resnet["conv1.weight"].numpy(), (2, 3, 1, 0)))
        np.testing.assert_array_equal(p["fusion"]["report_model"]["shared"]["embedding"],
                                      t5["shared.weight"].numpy())
    else:
        assert got.metadata["pretrained"] == {"text_backbone": "pretrained"}
        np.testing.assert_array_equal(p["fusion"]["report_model"]["shared"]["embedding"],
                                      base["fusion"]["report_model"]["shared"]["embedding"])


def test_load_checkpoint_formats(tmp_path, trunks):
    from safetensors.numpy import save_file

    from mmdx_tpu_torch.checkpoints.pretrained import _detect_prefix, load_checkpoint

    _, bert, _ = trunks
    torch.save({"state_dict": bert}, tmp_path / "bert.bin")
    sd = load_checkpoint(tmp_path / "bert.bin")
    assert isinstance(sd["embeddings.word_embeddings.weight"], np.ndarray)
    save_file({k: v.numpy() for k, v in bert.items()}, str(tmp_path / "bert.safetensors"))
    sd2 = load_checkpoint(tmp_path / "bert.safetensors")
    np.testing.assert_array_equal(sd2["embeddings.word_embeddings.weight"],
                                  bert["embeddings.word_embeddings.weight"].numpy())
    assert _detect_prefix({f"encoder.{k}": v for k, v in bert.items()},
                          "embeddings.word_embeddings.weight",
                          ("", "bert.", "encoder.")) == "encoder."
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing.pth")
