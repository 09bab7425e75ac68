"""The port's text data plane against the JAX package's, on the CPU.

``sparknet_tpu_torch.data.text`` is a copy of ``sparknet_tpu.data.text``
(local corpora only): the same corpus bytes, the same documents and
windows BIT-IDENTICAL to the JAX sampler's for every (seed, worker,
iter), and the same cursor checks.
"""

import numpy as np
import pytest

from sparknet_tpu.data import text as jtext
from sparknet_tpu_torch.data import text as ttext

T, B = 32, 4


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    ttext.write_synthetic_corpus(str(d), num_docs=4, words_per_doc=200, seed=0)
    return ttext.load_corpus(str(d))


def test_synthetic_corpus_and_loading_match_jax(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    pa = ttext.write_synthetic_corpus(str(a), num_docs=3, seed=5)
    pb = jtext.write_synthetic_corpus(str(b), num_docs=3, seed=5)
    assert [p.rsplit("/", 1)[1] for p in pa] == [p.rsplit("/", 1)[1] for p in pb]
    for x, y in zip(pa, pb):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()
    assert ttext.load_corpus(str(a)) == jtext.load_corpus(str(b))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("worker", [0, 1, 5])
def test_windows_are_bit_identical_to_jax(docs, seed, worker):
    tj = jtext.TextWindowSampler(docs, T, B, seed=seed, worker=worker)
    tt = ttext.TextWindowSampler(docs, T, B, seed=seed, worker=worker)
    for it in (0, 1, 7, 1000):
        want, got = tj.window_at(it), tt.window_at(it)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    for r in (0, 4):
        want, got = tj.window_for_round(r, 3), tt.window_for_round(r, 3)
        for k in ("tokens", "targets"):
            assert got[k].shape == (3, B, T)
            np.testing.assert_array_equal(got[k], want[k])
    # the dp fan-out shares the stream and draws the worker's windows
    sib_t, sib_j = tt.for_worker(worker + 1), tj.for_worker(worker + 1)
    assert sib_t.stream is tt.stream
    np.testing.assert_array_equal(sib_t.window_at(2)["tokens"],
                                  sib_j.window_at(2)["tokens"])
    assert tt.cursor_for_iter(9) == tj.cursor_for_iter(9)
    for it in (0, 5):
        np.testing.assert_array_equal(
            ttext._draw(seed, worker, it, 1000, 6),
            jtext._draw(seed, worker, it, 1000, 6),
        )


def test_targets_are_tokens_shifted_by_one(docs):
    w = ttext.TextWindowSampler(docs, T, B, seed=1).window_at(3)
    np.testing.assert_array_equal(w["tokens"][:, 1:], w["targets"][:, :-1])


def test_cursor_mismatches_raise(docs):
    s = ttext.TextWindowSampler(docs, T, B, seed=0)
    cur = s.cursor_for_iter(7)
    s.verify_cursor(cur)
    with pytest.raises(ValueError, match="seq_len"):
        ttext.TextWindowSampler(docs, 16, B).verify_cursor(cur)
    with pytest.raises(ValueError, match="seed"):
        ttext.TextWindowSampler(docs, T, B, seed=9).verify_cursor(cur)
    with pytest.raises(ValueError, match="stream_bytes"):
        ttext.TextWindowSampler(docs[:2], T, B).verify_cursor(cur)
    with pytest.raises(ValueError, match="batch_size"):
        ttext.TextWindowSampler(docs, T, B + 1).verify_cursor(cur)


def test_tokenizer_matches_jax():
    for s in ("hello world", "sparknet éµ", b"\x00\xff"):
        np.testing.assert_array_equal(ttext.ByteTokenizer.encode(s),
                                      jtext.ByteTokenizer.encode(s))
    ids = ttext.ByteTokenizer.encode("sparknet éµ")
    assert ttext.ByteTokenizer.decode(ids) == jtext.ByteTokenizer.decode(ids)
    assert ttext.ByteTokenizer.vocab_size == 256


def test_loading_refuses_what_it_cannot_take(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttext.load_corpus(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no .txt objects"):
        ttext.load_corpus("file://" + str(tmp_path),
                          cache_dir=str(tmp_path / "cache"))
    with pytest.raises(ValueError, match="seq_len"):
        ttext.TextWindowSampler([b"tiny"], 128, 2)
    with pytest.raises(ValueError, match="empty"):
        ttext.TextWindowSampler([], 8, 2)
