"""The port's text package against the JAX package's: the analyzer's
tokens, the word counts (K1 with one class and the vocabulary as its
bins), text Naive Bayes' counts, model file and predictions, and the
exact int64 counts past one launch."""

import numpy as np
import pytest
import torch

from avenir_tpu.text import analyzer as JA
from avenir_tpu.text import text_bayes as JT
from avenir_tpu.text import word_count as JW

from avenir_tpu_torch import interop
from avenir_tpu_torch.ops import histogram as H
from avenir_tpu_torch.text import analyzer as TA
from avenir_tpu_torch.text import text_bayes as TT
from avenir_tpu_torch.text import word_count as TW

torch.set_num_threads(2)

CORPUS = [
    "O'Neil bought 42 shares of U.S.A. steel, didn't he?",
    "The price is a bargain -- and THE bargain is not theirs.",
    "e-mail me at x_1@example.com by 3.14pm or 10.30",
    "'quoted' ...dots... trailing. 'apostrophe' rock'n'roll",
    "", "   ", "the and of to with",
    "Ünïcode café naïve résumé 2nd 1st",
]


@pytest.mark.parametrize("text", CORPUS)
@pytest.mark.parametrize("stop,min_len", [(None, 1), ((), 1), (None, 3)])
def test_analyzer_tokens_equal(text, stop, min_len):
    kw = {} if stop is None else {"stop_words": stop}
    want = JA.StandardAnalyzer(min_length=min_len, **kw).tokenize(text)
    got = TA.StandardAnalyzer(min_length=min_len, **kw).tokenize(text)
    assert got == want
    assert TA.tokenize(text) == JA.tokenize(text)


def _docs(n, vocab, seed, n_classes=2, max_len=60):
    """``[text, class]`` rows: class-skewed word frequencies over a
    vocabulary of ``vocab`` words, a few stop words and OOV-prone
    digits among them."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab)]
                     + ["the", "and", "of", "o'neil", "u.s.a", "42"])
    rows = []
    for _ in range(n):
        c = int(rng.integers(n_classes))
        rank = (np.arange(len(words)) + c * (len(words) // n_classes)) \
            % len(words)
        p = 1.0 / (1.0 + rank)
        rows.append([" ".join(rng.choice(words, int(rng.integers(0, max_len)),
                                         p=p / p.sum())), f"c{c}"])
    return rows


def test_word_counts_equal():
    texts = [r[0] for r in _docs(300, 200, seed=3)] + CORPUS
    assert TW.count_words(texts, device="cpu") == JW.count_words(texts)
    assert TW.count_words([], device="cpu") == JW.count_words([]) == {}
    assert TW.count_words(["", "the and of"], device="cpu") == {}


@pytest.mark.parametrize("ordinal,delim", [(-1, ","), (1, ","), (0, "\t")])
def test_word_count_lines_equal(ordinal, delim):
    rows = [[str(i), r[0], r[1]] for i, r in enumerate(_docs(200, 150, 4))]
    rows += [["x", "spam spam ham", "c0"], ["y", "ham eggs", "c1"]]
    want = JW.word_count_lines(rows, text_field_ordinal=ordinal,
                               delim_out=delim)
    got = TW.word_count_lines(rows, text_field_ordinal=ordinal,
                              delim_out=delim, device="cpu")
    assert got == want and want


@pytest.mark.parametrize("n,vocab,n_classes,seed", [
    (400, 300, 2, 5), (250, 80, 3, 6), (60, 2000, 2, 7)])
def test_train_counts_and_model_file(tmp_path, n, vocab, n_classes, seed):
    rows = _docs(n, vocab, seed, n_classes)
    jm, jmet = JT.train(rows)
    tm, tmet = TT.train(rows, device="cpu")
    assert tmet.to_json() == jmet.to_json()
    assert tm.class_values == jm.class_values and tm.vocab == jm.vocab
    np.testing.assert_array_equal(tm.class_counts.numpy(),
                                  np.asarray(jm.class_counts))
    np.testing.assert_array_equal(tm.token_counts.numpy(),
                                  np.asarray(jm.token_counts))
    JT.save_model(jm, str(tmp_path / "j.txt"))
    TT.save_model(tm, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "t.txt").read_bytes()


@pytest.fixture(scope="module")
def trained():
    rows = _docs(600, 400, seed=8)
    return rows, JT.train(rows)[0]


@pytest.mark.parametrize("laplace", [1.0, 0.5, 0.0])
def test_predict_labels_and_scores_equal(trained, laplace):
    """The JAX model carried over by ``interop``: labels equal, scores bit
    for bit (the tolerance of the contract, rtol 1e-6, is checked too)."""
    rows, jm = trained
    tm = interop.text_bayes_model_from_jax(
        jm.class_values, jm.vocab, np.asarray(jm.class_counts),
        np.asarray(jm.token_counts), device="cpu")
    texts = [r[0] for r in rows[:400]] + CORPUS
    truth = [r[1] for r in rows[:400]] + ["c0"] * len(CORPUS)
    jl, js, jcm = JT.predict(jm, texts, laplace=laplace, truth=truth)
    tl, ts, tcm = TT.predict(tm, texts, laplace=laplace, truth=truth)
    assert tl == jl
    finite = np.isfinite(js)
    np.testing.assert_allclose(ts[finite], js[finite], rtol=1e-6)
    np.testing.assert_array_equal(ts, js)
    assert tcm.report().to_json() == jcm.report().to_json()


@pytest.mark.parametrize("texts", [
    ["", "the and of", "   "],                       # no token at all
    ["zzz qqq", "unknownword 99999", "w0 zzz"],       # all or partly OOV
])
def test_no_token_and_oov_documents(trained, texts):
    _, jm = trained
    tm = interop.text_bayes_model_from_jax(
        jm.class_values, jm.vocab, np.asarray(jm.class_counts),
        np.asarray(jm.token_counts), device="cpu")
    jl, js, _ = JT.predict(jm, texts)
    tl, ts, _ = TT.predict(tm, texts)
    assert tl == jl
    np.testing.assert_array_equal(ts, js)


def test_degenerate_train_without_tokens(tmp_path):
    rows = [["", "a"], ["the of", "b"], ["and", "a"]]
    jm, jmet = JT.train(rows)
    tm, tmet = TT.train(rows, device="cpu")
    assert tmet.to_json() == jmet.to_json()
    np.testing.assert_array_equal(tm.token_counts.numpy(),
                                  np.asarray(jm.token_counts))
    JT.save_model(jm, str(tmp_path / "j.txt"))
    TT.save_model(tm, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "t.txt").read_bytes()


def test_model_files_cross_both_ways(trained, tmp_path):
    rows, jm = trained
    tm, _ = TT.train(rows, device="cpu")
    JT.save_model(jm, str(tmp_path / "j.txt"))
    TT.save_model(tm, str(tmp_path / "t.txt"))
    t_of_j = TT.load_model(str(tmp_path / "j.txt"), device="cpu")
    j_of_t = JT.load_model(str(tmp_path / "t.txt"))
    texts = [r[0] for r in rows[:200]]
    jl, js, _ = JT.predict(j_of_t, texts)
    tl, ts, _ = TT.predict(t_of_j, texts)
    assert tl == jl
    np.testing.assert_array_equal(ts, js)
    TT.save_model(t_of_j, str(tmp_path / "t2.txt"))
    JT.save_model(j_of_t, str(tmp_path / "j2.txt"))
    assert (tmp_path / "t2.txt").read_bytes() == \
        (tmp_path / "j2.txt").read_bytes()


def test_exact_counts_across_launches(monkeypatch):
    """K1's launches are cut at MAX_LAUNCH_ROWS rows and summed in int64:
    the counts equal one bincount, whatever the cut."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-2, 70, 10_001).astype(np.int32)
    labels = rng.integers(-1, 4, 10_001).astype(np.int32)
    ok = (ids >= 0) & (ids < 64) & (labels >= 0) & (labels < 3)
    want = np.bincount((labels * 64 + ids)[ok], minlength=3 * 64) \
        .reshape(3, 64)
    for cut in (1 << 24, 4096, 999):
        monkeypatch.setattr(H, "MAX_LAUNCH_ROWS", cut)
        got = H.class_bin_counts_exact(torch.from_numpy(ids),
                                       torch.from_numpy(labels), 3, 64)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_counts_stay_exact_past_f32_integers():
    """One token 2^24 + 1 times: two launches of at most 2^24 rows, each
    exact in f32, summed in int64 (f32 would round the count to 2^24)."""
    n = (1 << 24) + 1
    ids = torch.zeros(n, dtype=torch.int32)
    got = H.class_bin_counts_exact(ids, torch.zeros_like(ids), 1, 2)
    assert got.tolist() == [[n, 0]]
    assert float(np.float32(n)) != n
