"""The port's operations utilities on the CPU, against the JAX package where
it has the same function:

* ``utils.pytree``: ``count_params`` and ``tree_paths`` equal the JAX ones on
  one tree (dict keys walked in sorted order, None no leaf), and work on an
  ``nn.Module``; ``cast_floating`` casts only floating leaves;
* ``utils.dataframe.print_clean_df`` prints what the JAX one prints;
* ``runtime.profiler``: ``Timings.summary`` has the JAX module's keys, and a
  CPU ``device_trace`` writes a Chrome trace holding an ``annotate`` span;
* ``text.vocab_builder``: the same corpus, piece lists, scores, fallback
  WordPiece vocab and files as the JAX module (the ``tokenizers`` trainer's
  vocab is of the same size and layout: it differs between two calls).

Each test is held to 120 s by an alarm, and a watchdog ends a worker blocked
past 180 s.
"""
import builtins
import faulthandler
import json
import signal

import numpy as np
import pytest
import torch

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.runtime import profiler
from mmdx_tpu_torch.utils import cast_floating, count_params, tree_paths


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


@pytest.fixture(scope="module")
def variables():
    return bridge.random_state(bridge.small_config(), seed=1)


def test_tree_utils_match_jax(variables):
    from mmdx_tpu.utils import pytree as jax_pytree

    tree = {"z": variables, "a": [np.zeros((2, 3), np.float32), {"k": np.ones(4)}],
            "none": None, "m": {"b": np.arange(5, dtype=np.int32), "a": np.float32(2.0)}}
    assert count_params(tree) == jax_pytree.count_params(tree)
    assert tree_paths(tree) == jax_pytree.tree_paths(tree)
    assert tree_paths(tree)[:3] == ["a/0", "a/1/k", "m/a"]
    model = bridge.variables_to_torch(variables, bridge.small_config())
    assert count_params(model) == sum(p.numel() for p in model.parameters()) > 0
    names = tree_paths(model)
    assert names[0] == next(model.named_parameters())[0].replace(".", "/")
    assert len(names) == len(list(model.parameters()))


def test_cast_floating(variables):
    tree = {"w": np.ones((2, 2), np.float32), "i": np.arange(3), "t": torch.ones(3),
            "ti": torch.arange(3), "n": [np.zeros(2, np.float64)]}
    half = cast_floating(tree, np.float16)
    assert half["w"].dtype == np.float16 and half["n"][0].dtype == np.float16
    assert half["i"].dtype == tree["i"].dtype and half["ti"].dtype == torch.int64
    bf = cast_floating(tree)
    assert bf["w"].dtype == torch.bfloat16 and bf["t"].dtype == torch.bfloat16
    assert bf["i"] is tree["i"] and tree["w"].dtype == np.float32
    model = cast_floating(torch.nn.Linear(3, 2))
    assert model.weight.dtype == torch.bfloat16


def test_print_clean_df_matches_jax():
    import pandas as pd

    from mmdx_tpu.utils.dataframe import print_clean_df as jax_print
    from mmdx_tpu_torch.utils.dataframe import print_clean_df

    df = pd.DataFrame({"url": [f"s3://bucket/{'x' * 60}/{i}.jpg" for i in range(12)],
                       "n": list(range(12))})
    got, ref = [], []
    print_clean_df(df, num_rows=5, printer=got.append)
    jax_print(df, num_rows=5, printer=ref.append)
    assert got == ref and "..." in got[0]


def test_timings_summary_keys_match_jax():
    from mmdx_tpu.runtime.profiler import Timings as JaxTimings

    port, ref = profiler.Timings(), JaxTimings()
    for timings in (port, ref):
        for _ in range(3):
            with timings.scope("step", sync=True):
                sum(range(1000))
    with port.scope("cpu", sync=True, device="cpu"):
        torch.ones(4).sum()
    summary = port.summary()
    assert set(summary) == {"step", "cpu"}
    assert set(summary["step"]) == set(ref.summary()["step"]) == {
        "count", "total_s", "mean_ms", "p50_ms", "max_ms"}
    assert summary["step"]["count"] == 3 and summary["cpu"]["count"] == 1


def test_device_trace_on_the_cpu_holds_an_annotate_span(tmp_path):
    with profiler.device_trace(tmp_path / "trace") as prof:
        with profiler.annotate("mmdx/batch_chunk"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "mmdx/batch_chunk" in names and "aten::matmul" in names
    assert "mmdx/batch_chunk" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# vocab builder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpora():
    from mmdx_tpu.text import vocab_builder as jax_vb
    from mmdx_tpu_torch.text import vocab_builder as port_vb

    return port_vb, jax_vb, port_vb.default_medical_corpus(n_synthetic=60, seed=3)


def test_vocab_builder_corpus_and_t5_pieces_match_jax(corpora, tmp_path):
    port_vb, jax_vb, corpus = corpora
    assert corpus == jax_vb.default_medical_corpus(n_synthetic=60, seed=3)
    pieces = port_vb.build_t5_vocab(corpus, vocab_size=400, num_extra_ids=10)
    assert pieces == jax_vb.build_t5_vocab(corpus, vocab_size=400, num_extra_ids=10)
    assert pieces[:3] == ["<pad>", "</s>", "<unk>"] and pieces[-1] == "<extra_id_9>"
    scored = port_vb.score_t5_vocab(pieces, corpus[:80], em_iters=2)
    assert scored == jax_vb.score_t5_vocab(pieces, corpus[:80], em_iters=2)
    a = port_vb.write_vocab(scored, tmp_path / "port.txt")
    b = jax_vb.write_vocab(scored, tmp_path / "jax.txt")
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("trainer", ["tokenizers", "fallback"])
def test_wordpiece_vocab_matches_jax(corpora, monkeypatch, trainer):
    port_vb, jax_vb, corpus = corpora
    if trainer == "fallback":
        real = builtins.__import__

        def no_tokenizers(name, *a, **kw):
            if name == "tokenizers":
                raise ImportError("No module named 'tokenizers'")
            return real(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    else:
        pytest.importorskip("tokenizers")
    got = port_vb.build_wordpiece_vocab(corpus, vocab_size=300)
    ref = jax_vb.build_wordpiece_vocab(corpus, vocab_size=300)
    assert got[:5] == ref[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert len(got) == len(set(got)) == len(ref)
    if trainer == "fallback":
        assert got == ref
    # the tokenizers trainer orders (and picks among) equally frequent
    # pieces differently from one call to the next, in either package
