"""The port's Markov chain (``avenir_tpu_torch/models/markov.py``, its
counts through K4's plain version here) against the JAX package's, on
the same seeded sequences: models equal cell for cell (and file for
file), classifier labels equal and log odds within ``ODDS_RTOL``; plus
the numpy copies the slice carries (``utils/tables``, ``iter_csv_rows``,
the sequence generators) and the two Markov verbs through both CLIs."""

import json

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG
from avenir_tpu.models import markov as JM
from avenir_tpu.utils import dataset as JD
from avenir_tpu.utils import tables as JT

from avenir_tpu_torch import interop
from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.datagen import generators as TG
from avenir_tpu_torch.models import markov as TM
from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.utils import dataset as TD
from avenir_tpu_torch.utils import tables as TT

torch.set_num_threads(2)

#: the log odds are f32 sums over time: the JAX package's is an XLA
#: reduction, whose order torch does not promise, so each sum is held
#: within ODDS_RTOL of its value, or of the sum of its terms' magnitudes
#: where the terms cancel
ODDS_RTOL = 1e-6

STATES = TM.XACTION_STATES
_rng = np.random.default_rng(16)
PLANTED = {"churn": _rng.dirichlet(np.ones(9) * 0.7, size=9),
           "loyal": _rng.dirichlet(np.ones(9) * 0.7, size=9)}


def _labeled(n_each=150, min_len=5, max_len=30):
    """Class-conditional sequences of the email-marketing states: rows
    ``id, label, s1, s2, ...``."""
    rows = []
    for k, (label, mat) in enumerate(PLANTED.items()):
        for rid, seq in JG.markov_sequences(n_each, STATES, mat, min_len,
                                            max_len, seed=40 + k):
            rows.append([f"{label[0]}{rid}", label] + seq)
    order = np.random.default_rng(3).permutation(len(rows))
    return [rows[i] for i in order]


def _assert_models_equal(j, t):
    assert j.states == t.states and j.scale == t.scale
    assert (j.trans is None) == (t.trans is None)
    if j.trans is not None:
        assert j.trans.dtype == t.trans.dtype
        np.testing.assert_array_equal(j.trans, t.trans)
    assert (j.class_trans is None) == (t.class_trans is None)
    if j.class_trans is not None:
        assert list(j.class_trans) == list(t.class_trans)
        for label in j.class_trans:
            assert j.class_trans[label].dtype == t.class_trans[label].dtype
            np.testing.assert_array_equal(j.class_trans[label],
                                          t.class_trans[label])


def _assert_odds_close(j_odds, t_odds, terms):
    """``terms`` [B, n] the f32 terms of each sum."""
    bound = ODDS_RTOL * np.maximum(np.abs(j_odds),
                                   np.abs(terms).astype(np.float64).sum(1))
    assert np.all(np.abs(t_odds.astype(np.float64) - j_odds) <= bound)


def _terms(model, seqs, labels):
    m0 = np.maximum(model.class_trans[labels[0]], 1e-12)
    m1 = np.maximum(model.class_trans[labels[1]], 1e-12)
    ratio = np.log(m0 / m1).astype(np.float32)
    batch, lengths = TM.encode_sequences(seqs, model.states, "cpu")
    batch, lengths = batch.numpy(), lengths.numpy()
    mask = np.arange(batch.shape[1] - 1)[None, :] + 1 < lengths[:, None]
    return ratio[batch[:, :-1], batch[:, 1:]] * mask


# --------------------------------------------------------------------------
# the numpy copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_laplace_and_scale_matches(scale, dtype):
    counts = np.random.default_rng(scale).integers(0, 40, (3, 5, 6))
    counts[0, 1] = 0
    counts = counts.astype(dtype)
    j = JT.laplace_and_scale(counts, scale)
    t = TT.laplace_and_scale(counts, scale)
    assert j.dtype == t.dtype
    np.testing.assert_array_equal(j, t)


def test_labeled_matrix_matches():
    rows, cols = ["a", "b", "c"], ["x", "y"]
    values = np.asarray([[3.0, 0.0], [1.0, 2.0], [0.0, 0.0]])
    out = []
    for mod in (JT, TT):
        m = mod.LabeledMatrix(rows, cols, values.copy())
        m.add("b", "y", 2)
        m.laplace_correct().row_normalize(scale=100)
        lines = m.serialize_rows(as_int=True)
        back = mod.LabeledMatrix.from_lines(rows, cols, lines)
        out.append((lines, back.values, back.get("a", "y")))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


@pytest.mark.parametrize("window", [None, (0, 37), (37, 150), (150, 10_000)])
def test_iter_csv_rows_matches(tmp_path, window):
    path = tmp_path / "rows.csv"
    path.write_bytes(b"a, b,c\r\n\nd,e\nfff,g,h,i\n" * 9 + b"j,k")
    assert (list(TD.iter_csv_rows(str(path), ",", byte_window=window))
            == list(JD.iter_csv_rows(str(path), ",", byte_window=window)))


def test_generators_match():
    mat = PLANTED["churn"]
    assert (TG.markov_sequences(40, STATES, mat, 3, 12, seed=5)
            == JG.markov_sequences(40, STATES, mat, 3, 12, seed=5))
    args = (30, TG.LOYALTY_STATES, TG.LOYALTY_OBSERVATIONS,
            TG.LOYALTY_TRANS, TG.LOYALTY_EMIT, TG.LOYALTY_INITIAL)
    assert TG.hmm_tagged_rows(*args, seed=7) == JG.hmm_tagged_rows(*args,
                                                                   seed=7)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def test_encode_sequences_matches():
    rows = _labeled(20)
    seqs = [r[2:] for r in rows] + [[]]
    jb, jl = JM.encode_sequences(seqs, STATES)
    tb, tl = TM.encode_sequences(seqs, STATES, "cpu")
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())


@pytest.mark.parametrize("scale", [1000, 1])
@pytest.mark.parametrize("conditional", [False, True])
def test_train_matches_jax(scale, conditional):
    rows = _labeled()
    seqs = [r[2:] for r in rows]
    labels = [r[1] for r in rows] if conditional else None
    _assert_models_equal(
        JM.train(seqs, STATES, class_labels=labels, scale=scale),
        TM.train(seqs, STATES, class_labels=labels, scale=scale,
                 device="cpu"))


def _write_rows(path, rows):
    path.write_text("".join(",".join(r) + "\n" for r in rows))
    return str(path)


@pytest.mark.parametrize("chunk_rows", [7, 1000])
@pytest.mark.parametrize("conditional", [False, True])
def test_train_streamed_matches_jax(tmp_path, chunk_rows, conditional):
    path = _write_rows(tmp_path / "seq.csv", _labeled())
    kwargs = dict(skip_fields=1, scale=1000, chunk_rows=chunk_rows,
                  class_label_ord=1 if conditional else -1)
    if not conditional:
        kwargs["skip_fields"] = 2
    _assert_models_equal(
        JM.train_streamed(path, STATES, ",", **kwargs),
        TM.train_streamed(path, STATES, ",", device="cpu", **kwargs))


@pytest.fixture
def small_launches(monkeypatch):
    """K4 launches of at most 100 transitions, each one recorded with its
    operands; the counts go through K4's plain version here."""
    calls = []
    wrapped = histogram.pair_counts

    def pair_counts(a, b, n_a, n_b, weights=None):
        out = wrapped(a, b, n_a, n_b, weights)
        calls.append((a.clone(), b.clone(), n_a, n_b, out))
        return out

    monkeypatch.setattr(TM, "MAX_LAUNCH_TRANSITIONS", 100)
    monkeypatch.setattr(histogram, "pair_counts", pair_counts)
    return calls


def test_counts_are_exact_across_launches(small_launches):
    """Rows cut into launches of at most 100 transitions: each launch
    holds fewer, the ids are class·S + src and dst with -1 past a row's
    length, and the int64 sum equals one bincount of every transition."""
    rows = _labeled(40)
    seqs, lengths = TM.encode_sequences([r[2:] for r in rows], STATES, "cpu")
    cids = torch.tensor([r[1] == "loyal" for r in rows], dtype=torch.int32)
    counts = TM._bigram_counts(seqs, lengths, cids, 9, 2)
    assert counts.dtype == torch.int64
    n_trans = int((lengths - 1).clamp(min=0).sum())
    assert len(small_launches) >= n_trans // 100 + 1
    for a, b, n_a, n_b, out in small_launches:
        assert (n_a, n_b) == (18, 9)
        assert int((a >= 0).sum()) <= 100
        assert a.dtype == b.dtype == torch.int32
    s = seqs.long()
    src, dst = s[:, :-1], s[:, 1:]
    live = torch.arange(src.shape[1])[None, :] + 1 < lengths[:, None]
    flat = ((cids.long()[:, None] * 9 + src) * 9 + dst)[live]
    np.testing.assert_array_equal(
        counts.reshape(-1).numpy(), torch.bincount(flat, minlength=162))


def test_launch_cut_keeps_models_equal(tmp_path, small_launches):
    """In memory and streamed, with launches and chunks of at most 100
    transitions, the models equal the JAX package's (which counts the
    whole batch, or each 1000-row chunk, in one product)."""
    rows = _labeled()
    seqs, labels = [r[2:] for r in rows], [r[1] for r in rows]
    _assert_models_equal(JM.train(seqs, STATES, class_labels=labels),
                         TM.train(seqs, STATES, class_labels=labels,
                                  device="cpu"))
    path = _write_rows(tmp_path / "seq.csv", rows)
    _assert_models_equal(
        JM.train_streamed(path, STATES, ",", skip_fields=1,
                          class_label_ord=1, chunk_rows=1000),
        TM.train_streamed(path, STATES, ",", skip_fields=1,
                          class_label_ord=1, chunk_rows=1000, device="cpu"))
    assert len(small_launches) > 2 * sum(len(s) - 1 for s in seqs) // 100


def test_counts_past_f32_integers_stay_exact():
    """16,820,000 transitions in one cell (past 2^24, where f32 integers
    end): two K4 launches, an exact int64 count, and the model normalized
    from it in float64 (the JAX package's f32 product rounds this cell)."""
    seqs = torch.zeros((580_000, 30), dtype=torch.int32)
    lengths = torch.full((580_000,), 30, dtype=torch.int32)
    assert TM._launch_rows(lengths) == [(0, 578_524), (578_524, 580_000)]
    counts = TM._bigram_counts(seqs, lengths, None, 9, 1)
    assert int(counts[0, 0, 0]) == 580_000 * 29 > 1 << 24
    model = TM.train_encoded(seqs, lengths, STATES, scale=1)
    want = TT.laplace_and_scale(counts[0].numpy().astype(np.float64), 1)
    assert model.trans.dtype == np.float64
    np.testing.assert_array_equal(model.trans, want)


def test_a_row_past_the_launch_envelope_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(TM, "MAX_LAUNCH_TRANSITIONS", 10)
    long_row = [STATES[i % 9] for i in range(12)]
    seqs, lengths = TM.encode_sequences([long_row], STATES, "cpu")
    with pytest.raises(ValueError, match="transitions exceeds"):
        TM._bigram_counts(seqs, lengths, None, 9, 1)
    path = _write_rows(tmp_path / "long.csv", [["x"] + long_row])
    with pytest.raises(ValueError, match="transitions exceeds"):
        TM.train_streamed(path, STATES, ",", skip_fields=1, device="cpu")


# --------------------------------------------------------------------------
# the wire format, classify, next states
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,output_states,conditional", [
    (1000, True, True), (1, False, True), (1000, False, False),
    (1, True, False)])
def test_model_files_byte_identical(tmp_path, scale, output_states,
                                    conditional):
    rows = _labeled(60)
    seqs = [r[2:] for r in rows]
    labels = [r[1] for r in rows] if conditional else None
    model = JM.train(seqs, STATES, class_labels=labels, scale=scale)
    JM.save_model(model, str(tmp_path / "j.txt"), output_states)
    TM.save_model(TM.train(seqs, STATES, class_labels=labels, scale=scale,
                           device="cpu"), str(tmp_path / "t.txt"),
                  output_states)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt") \
        .read_bytes()
    if output_states:
        _assert_models_equal(
            JM.load_model(str(tmp_path / "j.txt"), conditional, scale),
            TM.load_model(str(tmp_path / "t.txt"), conditional, scale))


@pytest.mark.parametrize("max_len", [12, 30, 45])
def test_classify_matches_jax(max_len):
    """Labels equal, log odds within ODDS_RTOL (f32 sums over up to 44
    steps)."""
    rows = _labeled(120, max_len=max_len)
    seqs, labels = [r[2:] for r in rows], [r[1] for r in rows]
    jmodel = JM.train(seqs, STATES, class_labels=labels)
    tmodel = interop.markov_model_from_numpy(
        jmodel.states, jmodel.scale, class_trans=jmodel.class_trans)
    j_pred, j_odds = JM.classify(jmodel, seqs, ("churn", "loyal"))
    t_pred, t_odds = TM.classify(tmodel, seqs, ("churn", "loyal"),
                                 device="cpu")
    assert t_odds.dtype == np.float32
    np.testing.assert_array_equal(j_pred, t_pred)
    _assert_odds_close(np.asarray(j_odds, np.float64), t_odds,
                       _terms(jmodel, seqs, ("churn", "loyal")))
    assert (t_pred == np.asarray(labels)).mean() > 0.9
    j_cm = JM.validate(j_pred, labels, ["churn", "loyal"], "churn")
    t_cm = TM.validate(t_pred, labels, ["churn", "loyal"], "churn")
    assert j_cm.report().to_json() == t_cm.report().to_json()


@pytest.mark.parametrize("n", [3, 15, 16, 24, 29, 32])
def test_row_sum_order(n):
    """``_row_sum`` adds in the order its docstring states: in sequence
    below 16 terms, eight lanes folded in halves and the rest in sequence
    from 16 on (numpy, term by term, in f32)."""
    vals = np.random.default_rng(n).normal(size=(500, n)).astype(np.float32)
    want = np.zeros(500, np.float32)
    if n < 16:
        for t in range(n):
            want = want + vals[:, t]
    else:
        whole = n // 8 * 8
        lanes = np.zeros((500, 8), np.float32)
        for v in range(0, whole, 8):
            lanes = lanes + vals[:, v:v + 8]
        lanes = lanes[:, :4] + lanes[:, 4:]
        lanes = lanes[:, :2] + lanes[:, 2:]
        want = lanes[:, 0] + lanes[:, 1]
        for t in range(whole, n):
            want = want + vals[:, t]
    np.testing.assert_array_equal(TM._row_sum(torch.from_numpy(vals))
                                  .numpy(), want)


def test_classify_needs_a_class_model():
    model = TM.MarkovModel(states=STATES, scale=1, trans=np.eye(9))
    with pytest.raises(ValueError, match="class-label-based"):
        TM.classify(model, [["SL", "SE"]], ("a", "b"), device="cpu")


def test_transaction_states_and_next_states_match():
    hist = [(0, 100), (10, 200), (50, 210), (120, 100), (121, 100),
            (200, 95)]
    assert TM.transaction_states(hist) == JM.transaction_states(hist)
    trans = np.random.default_rng(2).integers(0, 5, (9, 9)).astype(float)
    trans[3] = 2.0                                     # a tied row
    jmodel = JM.MarkovModel(states=STATES, scale=1, trans=trans)
    tmodel = interop.markov_model_from_numpy(STATES, 1, trans=trans)
    assert (TM.next_states(tmodel, STATES, device="cpu")
            == JM.next_states(jmodel, STATES))
    with pytest.raises(ValueError, match="global model"):
        TM.next_states(TM.MarkovModel(STATES, 1, class_trans={}), ["SL"],
                       device="cpu")


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.train([["SL", "SE"]], STATES)


# --------------------------------------------------------------------------
# the two verbs through both CLIs
# --------------------------------------------------------------------------

def _props(path, **kv):
    path.write_text("".join(f"{k}={v}\n" for k, v in kv.items()))
    return str(path)


@pytest.mark.parametrize("extra", [
    [],
    ["-D", "trans.prob.scale=1", "-D", "output.states=false"],
    ["-D", "class.label.field.ord=-1", "-D", "skip.field.count=2"],
    ["-D", "streaming.train=true", "-D", "stream.chunk.rows=64"],
    ["-D", "streaming.train=true", "-D", "stream.chunk.rows=5000",
     "-D", "class.labels=churn,loyal"]],
    ids=["class", "scale1-nostates", "global", "streamed64",
         "streamed5000"])
def test_markov_verbs_match_the_jax_cli(tmp_path, capsys, extra):
    """MarkovStateTransitionModel's file byte-identical; then
    MarkovModelClassifier (validation mode) on held-out rows: ids, truth
    and predicted labels and the Validation JSON byte-identical, the log
    odds within ODDS_RTOL."""
    rows = _labeled(300)
    train = _write_rows(tmp_path / "train.csv", rows[:400])
    test = _write_rows(tmp_path / "test.csv", rows[400:])
    props = _props(tmp_path / "m.properties", **{
        "field.delim.regex": ",", "model.states": ",".join(STATES),
        "skip.field.count": "1", "class.label.field.ord": "1",
        "class.labels": "churn,loyal", "validation.mode": "true"})
    outs = {}
    for tag, run, flags in (("j", jmain, []),
                            ("t", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"model_{tag}.txt")
        run(["MarkovStateTransitionModel", train, model, "--conf", props]
            + extra + flags)
        assert capsys.readouterr().out == ""
        if "class.label.field.ord=-1" in extra or "output.states=false" \
                in extra:
            outs[tag] = None
            continue
        run(["MarkovModelClassifier", test, str(tmp_path / f"pred_{tag}"),
             "--conf", props, "-D", f"mm.model.path={model}"] + flags)
        outs[tag] = capsys.readouterr().out
    assert ((tmp_path / "model_j.txt").read_bytes()
            == (tmp_path / "model_t.txt").read_bytes())
    if outs["t"] is None:
        return
    assert outs["j"] == outs["t"]
    assert json.loads(outs["t"])["Validation.Accuracy"] > 0.9
    j_lines = (tmp_path / "pred_j").read_text().splitlines()
    t_lines = (tmp_path / "pred_t").read_text().splitlines()
    assert len(j_lines) == len(t_lines) == 200
    j_fields = [line.split(",") for line in j_lines]
    t_fields = [line.split(",") for line in t_lines]
    assert [f[:3] for f in j_fields] == [f[:3] for f in t_fields]
    model = TM.load_model(str(tmp_path / "model_t.txt"), True)
    _assert_odds_close(np.asarray([float(f[3]) for f in j_fields]),
                       np.asarray([float(f[3]) for f in t_fields]),
                       _terms(model, [r[2:] for r in rows[400:]],
                              ("churn", "loyal")))
