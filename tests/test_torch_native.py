"""The port's C++ host cores (``mmdx_tpu_torch/native``) against the JAX
package's and against the port's pure-Python paths, on the CPU.

* the fixed-point resize: bit-equal to ``mmdx_tpu.native.resize_u8``, to PIL
  and to the port's ``resize_u8_exact`` at the shapes of
  ``tests/test_native_resize.py``; ``wire_image_u8`` takes it, and its
  output does not depend on which backend resized;
* the WordPiece and unigram tokenizers: identical to both JAX natives and
  to the port's Python tokenizers on the texts of
  ``tests/test_native_wordpiece.py`` and ``tests/test_native_unigram.py``;
  ``TorchBundle.tokenizers()`` returns the native ones, staged through the
  same content-addressed vocab files as the JAX bundle;
* the build: a hash-keyed library under ``mmdx_tpu_torch/_build``; a library
  that cannot be built leaves every stage on its Python path, and the
  engine's log line says so.

Each test is held to 120 s by an alarm, and a watchdog ends a worker
blocked past 180 s, so that a hang fails one test.
"""
import faulthandler
import signal

import numpy as np
import pytest
from PIL import Image

from mmdx_tpu_torch import native
from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.ops.resize import resize_u8_exact, shorter_side_target
from mmdx_tpu_torch.text.native_unigram import NativeT5Tokenizer
from mmdx_tpu_torch.text.native_wordpiece import NativeWordPieceTokenizer
from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer
from mmdx_tpu_torch.text.wordpiece import WordPieceTokenizer

BERT_VOCAB = bridge.ASSETS / "bert_vocab.txt"

WORDPIECE_TEXTS = [  # tests/test_native_wordpiece.py
    "31 year old male PA view , smoking history of 40 pack years, hypertension",
    "78 year old female PA view , low grade fever, cough, shortness of breath",
    "67M, smoker; dyspnea; CHF history.",
    "",
    "UNKNOWNWORDXYZQ!! multiple   spaces",
    "Patient presente une toux naive cafe",
    "Présente une toux naïve café",
]
UNIGRAM_TEXTS = [  # tests/test_native_unigram.py
    "",
    "No acute cardiopulmonary abnormality.",
    "Heart size is within normal limits, lungs are clear.",
    "62 year old male PA view, smoking history of 30 pack years",
    "bilateral pleural effusions with atelectasis???",
    "UPPER Case And MiXeD   whitespace\t\ttabs",
    "unicode: café naïve — em-dash … ellipsis ΩΩΩ",
    "q%$#@!* zz xqj zzz",
    "a" * 300,
]
RESIZE_CASES = [  # tests/test_native_resize.py
    ((512, 512), (256, 256)),
    ((512, 512, 3), (256, 256)),
    ((300, 487), (256, 416)),
    ((487, 300, 3), (416, 256)),
    ((100, 700), (256, 1792)),
    ((256, 256), (256, 256)),
    ((40, 30, 3), (17, 13)),
]


@pytest.fixture(autouse=True)
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog thread ends the process at 180 s if its main thread is blocked
    in native code, where the alarm cannot run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def test_library_builds_into_the_hash_keyed_build_dir():
    assert native.available() and native.build_error() is None
    path = native.library_path()
    assert path.is_file() and path.parent == bridge.Path(native.__file__).parents[1] / "_build"
    assert path.name == f"libmmdx_native_{native.source_hash()}.so"
    assert native.build() == path  # built once, then reused


def test_sources_are_the_jax_packages_unchanged():
    from mmdx_tpu import native as jax_native

    jax_dir = bridge.Path(jax_native.__file__).parent
    for src in native.SOURCES:
        assert src.read_bytes() == (jax_dir / src.name).read_bytes(), src.name


@pytest.mark.parametrize("shape,out", RESIZE_CASES)
def test_native_resize_matches_jax_pil_and_replica(shape, out):
    from mmdx_tpu import native as jax_native

    img = np.random.default_rng(sum(shape) + sum(out)).integers(0, 256, shape, dtype=np.uint8)
    oh, ow = out
    calls = native.resize_u8.calls
    got = native.resize_u8(img, oh, ow)
    assert native.resize_u8.calls == calls + 1
    assert got is not None and got.shape == (oh, ow) + shape[2:]
    np.testing.assert_array_equal(got, resize_u8_exact(img, oh, ow))
    ref = jax_native.resize_u8(img, oh, ow)
    assert ref is not None
    np.testing.assert_array_equal(got, ref)
    pil = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR), np.uint8)
    np.testing.assert_array_equal(got.reshape(pil.shape), pil)


@pytest.mark.parametrize("shape", [(480, 640), (600, 480, 3)])
def test_wire_image_takes_the_native_resize_with_the_pil_result(shape, monkeypatch):
    from mmdx_tpu.io.images import wire_image_u8 as jax_wire
    from mmdx_tpu_torch.io.images import wire_image_u8

    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    calls = native.resize_u8.calls
    wired = wire_image_u8(img, 256, square=True)
    assert native.resize_u8.calls == calls + 1
    np.testing.assert_array_equal(wired, jax_wire(img, 256, square=True))
    nh, nw = shorter_side_target(*shape[:2], 256)
    ref = resize_u8_exact(img, nh, nw)
    top, left = int(round((nh - 256) / 2.0)), int(round((nw - 256) / 2.0))
    np.testing.assert_array_equal(wired, ref[top:top + 256, left:left + 256])
    monkeypatch.setattr(native, "resize_u8", lambda *a: None)  # the PIL path
    np.testing.assert_array_equal(wire_image_u8(img, 256, square=True), wired)


def test_native_wordpiece_matches_jax_native_and_python():
    from mmdx_tpu.text.native_wordpiece import NativeWordPieceTokenizer as JaxNative

    tok = NativeWordPieceTokenizer(BERT_VOCAB)
    assert tok.native_available
    py, jax_tok = WordPieceTokenizer(BERT_VOCAB), JaxNative(str(BERT_VOCAB))
    for text in WORDPIECE_TEXTS:
        assert tok.encode(text, 96) == py.encode(text, 96) == jax_tok.encode(text, 96), text
    a, b, c = (t.encode_batch(WORDPIECE_TEXTS, 64) for t in (tok, py, jax_tok))
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], c[key])


@pytest.fixture(scope="module")
def unigram():
    from mmdx_tpu.text.native_unigram import NativeT5Tokenizer as JaxNative

    _, vocab, scores = bridge.default_vocabs()
    lines = [f"{t}\t{scores.get(i, 0.0)}" for t, i in sorted(vocab.items(), key=lambda kv: kv[1])]
    path = bridge.staged_vocab_file("t5", lines)
    return (NativeT5Tokenizer(path), T5StyleTokenizer(vocab=vocab, scores=scores),
            JaxNative(path))


def test_native_unigram_matches_jax_native_and_python(unigram):
    tok, py, jax_tok = unigram
    assert tok.native_available and jax_tok.native_available
    for text in UNIGRAM_TEXTS:
        assert tok.encode(text) == py.encode(text) == jax_tok.encode(text), text
        assert tok.encode(text, max_length=16) == py.encode(text, max_length=16)
    a, b, c = (t.encode_batch(UNIGRAM_TEXTS, max_length=32) for t in unigram)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], c[key])
    assert tok.decode(b["input_ids"][3]) == py.decode(b["input_ids"][3])


def test_bundle_tokenizers_are_the_native_ones():
    from mmdx_tpu.checkpoints.bundle import _staged_vocab_file

    bert, t5, scores = bridge.default_vocabs()
    tb = bridge.TorchBundle(config=None, model=None, bert_vocab=bert, t5_vocab=t5,
                            class_names=[], thresholds=[], t5_scores=scores)
    wp, ug = tb.tokenizers()
    assert isinstance(wp, NativeWordPieceTokenizer) and wp.native_available
    assert isinstance(ug, NativeT5Tokenizer) and ug.native_available
    py_wp, py_ug = WordPieceTokenizer(vocab=bert), T5StyleTokenizer(vocab=t5, scores=scores)
    for text in WORDPIECE_TEXTS:
        assert wp.encode(text, 32) == py_wp.encode(text, 32)
    for text in UNIGRAM_TEXTS:
        assert ug.encode(text) == py_ug.encode(text)
    lines = [t for t, _ in sorted(bert.items(), key=lambda kv: kv[1])]
    assert bridge.staged_vocab_file("bert", lines) == _staged_vocab_file("bert", lines)


def test_unscored_vocab_takes_the_python_unigram():
    bert, t5, _ = bridge.default_vocabs()
    tb = bridge.TorchBundle(config=None, model=None, bert_vocab=bert, t5_vocab=t5,
                            class_names=[], thresholds=[], t5_scores=None)
    _, ug = tb.tokenizers()
    assert type(ug) is T5StyleTokenizer and ug.algorithm == "greedy"


def test_without_the_library_every_stage_falls_back_to_python(monkeypatch):
    from mmdx_tpu_torch.runtime.engine import front_end_backends

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no compiler")
    assert not native.available() and native.build_error() == "no compiler"
    assert native.resize_u8(np.zeros((8, 8), np.uint8), 4, 4) is None
    bert, t5, scores = bridge.default_vocabs()
    tb = bridge.TorchBundle(config=None, model=None, bert_vocab=bert, t5_vocab=t5,
                            class_names=[], thresholds=[], t5_scores=scores)
    wp, ug = tb.tokenizers()
    assert type(wp) is WordPieceTokenizer and type(ug) is T5StyleTokenizer
    assert front_end_backends(wp, ug) == {"wordpiece": "python", "unigram": "python",
                                          "resize": "python"}


def test_engine_logs_its_front_end_backends(capsys):
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    tb = bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg)
    engine = InferenceEngine(tb, mode="parity", device="cpu")
    assert engine.front_end == {"wordpiece": "native", "unigram": "native",
                                "resize": "native"}
    assert "[mmdx] front end: wordpiece native, unigram native, resize native" in \
        capsys.readouterr().err
