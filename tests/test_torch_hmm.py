"""The port's hidden Markov model (``avenir_tpu_torch/models/hmm.py``,
``ops/scanops.py``) against the JAX package's, on the same seeded
sequences: Viterbi paths and scores bit for bit (ragged lengths and
planted ties included), the tagged builders' models cell for cell,
Baum-Welch within ``LL_RTOL`` (the log-likelihood history, every
iteration) and ``PARAM_ATOL`` (the log-parameters after 10 iterations)
in both E-step forms and both EM paths, checkpoints resumed across the two
packages, and the two HMM verbs through both CLIs."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.models import hmm as JH
from avenir_tpu.ops import scanops as JS

from avenir_tpu_torch import interop
from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.datagen import generators as TG
from avenir_tpu_torch.models import hmm as TH
from avenir_tpu_torch.ops import scanops as TS

torch.set_num_threads(2)

#: XLA's CPU exp and log are not torch's, and the associative E-step
#: combines in another order than JAX's odd-even scan
LL_RTOL = 1e-5
PARAM_ATOL = 1e-4

LOYALTY = (TG.LOYALTY_STATES, TG.LOYALTY_OBSERVATIONS, TG.LOYALTY_TRANS,
           TG.LOYALTY_EMIT, TG.LOYALTY_INITIAL)


def _loyalty_model(cls=TH.HmmModel):
    states, obs, trans, emit, init = LOYALTY
    return cls(states=states, observations=obs, trans=trans, emit=emit,
               initial=init, scale=1)


def _obs_rows(n, lo=1, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    obs = TG.LOYALTY_OBSERVATIONS
    return [[obs[i] for i in rng.integers(0, len(obs), rng.integers(lo, hi))]
            for _ in range(n)]


def _logs(model):
    li, lt, le = JH._log_params(model)
    return (li, lt, le), tuple(torch.from_numpy(np.array(a))
                               for a in (li, lt, le))


# --------------------------------------------------------------------------
# semiring products, scans, Viterbi
# --------------------------------------------------------------------------

def test_semiring_products_match():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(4, 3, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(TS.maxplus(ta, tb).numpy(),
                                  np.asarray(JS.maxplus(a, b)))
    np.testing.assert_allclose(TS.lseplus(ta, tb).numpy(),
                               np.asarray(JS.lseplus(a, b)), rtol=1e-6)
    eye = TS.maxplus_eye(3)
    np.testing.assert_array_equal(eye.numpy(), np.asarray(JS.maxplus_eye(3)))
    np.testing.assert_array_equal(TS.maxplus(ta, eye).numpy(), a)
    np.testing.assert_allclose(TS.lseplus(ta, TS.lseplus_eye(3)).numpy(), a,
                               rtol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [1, 2, 7, 16, 33])
def test_associative_scan_matches_lax(reverse, t_len):
    """Max-plus products of integer-valued matrices are exact in any
    association, so the port's scan equals ``lax.associative_scan``
    element for element, in both directions."""
    m = np.random.default_rng(t_len).integers(-20, 20, (t_len, 3, 3)) \
        .astype(np.float32)
    want = np.asarray(lax.associative_scan(JS.maxplus, jnp.asarray(m),
                                           reverse=reverse))
    got = TS.associative_scan(TS.maxplus, torch.from_numpy(m),
                              reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)
    got = TS.associative_scan(TS.maxplus, torch.from_numpy(m)[None], dim=1,
                              reverse=reverse)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_viterbi_batch_matches_bit_for_bit():
    """Ragged lengths from 1 to 39 over the loyalty model: every path
    and every score equal."""
    (jli, jlt, jle), (tli, tlt, tle) = _logs(_loyalty_model(JH.HmmModel))
    rows = _obs_rows(400)
    batch, lengths = JH._encode_padded_batch(rows, TG.LOYALTY_OBSERVATIONS)
    jp, js = JS.viterbi_batch(jli, jlt, jle, jnp.asarray(batch),
                              jnp.asarray(lengths))
    tp, ts = TS.viterbi_batch(tli, tlt, tle, torch.from_numpy(batch),
                              torch.from_numpy(lengths))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", ["uniform-row", "uniform-model",
                                  "tied-emissions"])
def test_viterbi_ties_take_the_first_state(case):
    """Planted ties: a uniform transition row, a wholly uniform model,
    and two states with equal emissions — every argmax takes the first
    maximum, as JAX's does."""
    states, obs, trans, emit, init = (list(x) if isinstance(x, list)
                                      else np.array(x) for x in LOYALTY)
    if case == "uniform-row":
        trans[1] = 1.0 / 3
    elif case == "uniform-model":
        trans[:] = 1.0 / 3
        emit[:] = 1.0 / 9
        init[:] = 1.0 / 3
    else:
        emit[2] = emit[0]
        trans[:, 2] = trans[:, 0]
    jmodel = JH.HmmModel(states, obs, trans, emit, init)
    tmodel = interop.hmm_model_from_numpy(states, obs, trans, emit, init)
    rows = _obs_rows(200, seed=4)
    for reverse in (True, False):
        assert (TH.predict_states(tmodel, rows, reverse, device="cpu")
                == JH.predict_states(jmodel, rows, reverse))


def test_viterbi_path_and_associative_scores():
    (jli, jlt, jle), (tli, tlt, tle) = _logs(_loyalty_model(JH.HmmModel))
    obs = np.random.default_rng(1).integers(0, 9, 64).astype(np.int32)
    jp, js = JS.viterbi_path(jli, jlt, jle, jnp.asarray(obs))
    tp, ts = TS.viterbi_path(tli, tlt, tle, torch.from_numpy(obs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert float(ts) == float(js)
    ja = JS.viterbi_scores_associative(jli, jlt, jle, jnp.asarray(obs))
    ta = TS.viterbi_scores_associative(tli, tlt, tle, torch.from_numpy(obs))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
    assert float(ta.max()) == pytest.approx(float(ts), rel=1e-5)


@pytest.mark.parametrize("scale", [1, 1000])
def test_predict_states_matches(scale):
    model = _loyalty_model()
    if scale > 1:
        model.trans = np.rint(model.trans * scale)
        model.emit = np.rint(model.emit * scale)
        model.initial = np.rint(model.initial * scale)
        model.scale = scale
    jmodel = JH.HmmModel(model.states, model.observations, model.trans,
                         model.emit, model.initial, scale)
    rows = _obs_rows(300, seed=2)
    assert (TH.predict_states(model, rows, device="cpu")
            == JH.predict_states(jmodel, rows))
    with pytest.raises(ValueError, match="observation vocabulary"):
        TH.predict_states(model, [["SL", "XX"]], device="cpu")


# --------------------------------------------------------------------------
# the tagged builders and the wire format
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1, 1000])
def test_fully_tagged_matches(scale):
    rows = TG.hmm_tagged_rows(200, *LOYALTY, seed=3)
    args = (TG.LOYALTY_STATES, TG.LOYALTY_OBSERVATIONS)
    j = JH.train_fully_tagged(rows, *args, scale=scale, skip_field_count=1)
    t = TH.train_fully_tagged(rows, *args, scale=scale, skip_field_count=1)
    for name in ("trans", "emit", "initial"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    if scale == 1:
        np.testing.assert_allclose(t.trans, TG.LOYALTY_TRANS, atol=0.05)


@pytest.mark.parametrize("window", [[1], [3, 2, 1]])
def test_partially_tagged_matches(window):
    rng = np.random.default_rng(5)
    tokens = ["o1", "o2", "o3", "S", "T"]
    rows = [[tokens[i] for i in rng.integers(0, 5, rng.integers(1, 15))]
            for _ in range(120)]
    args = (["S", "T"], ["o1", "o2", "o3"], window)
    j = JH.train_partially_tagged(rows, *args, scale=1000)
    t = TH.train_partially_tagged(rows, *args, scale=1000)
    for name in ("trans", "emit", "initial"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))


@pytest.mark.parametrize("scale", [1, 1000])
def test_model_files_byte_identical(tmp_path, scale):
    rows = TG.hmm_tagged_rows(100, *LOYALTY, seed=6)
    args = (TG.LOYALTY_STATES, TG.LOYALTY_OBSERVATIONS)
    JH.save_model(JH.train_fully_tagged(rows, *args, scale=scale,
                                        skip_field_count=1),
                  str(tmp_path / "j.txt"))
    TH.save_model(TH.train_fully_tagged(rows, *args, scale=scale,
                                        skip_field_count=1),
                  str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt") \
        .read_bytes()
    j = JH.load_model(str(tmp_path / "j.txt"), scale)
    t = TH.load_model(str(tmp_path / "t.txt"), scale)
    assert (j.states, j.observations) == (t.states, t.observations)
    np.testing.assert_array_equal(j.emit, t.emit)


# --------------------------------------------------------------------------
# Baum-Welch
# --------------------------------------------------------------------------

#: the sequences of most Baum-Welch cases: one batch shape, so that the
#: JAX package compiles each of its kernels once for the file
BW_SEQS = 120


def _planted(n_seqs, lo=15, hi=30, seed=3):
    """Sequences of a 2-state, 4-symbol HMM (the JAX package's test
    fixture)."""
    rng = np.random.default_rng(seed)
    a = np.array([[0.9, 0.1], [0.2, 0.8]])
    b = np.array([[0.45, 0.45, 0.05, 0.05], [0.05, 0.05, 0.45, 0.45]])
    names = ["a", "b", "c", "d"]
    rows = []
    for _ in range(n_seqs):
        s = rng.choice(2, p=[0.6, 0.4])
        seq = []
        for _ in range(int(rng.integers(lo, hi))):
            seq.append(names[rng.choice(4, p=b[s])])
            s = rng.choice(2, p=a[s])
        rows.append(seq)
    return rows, names


def _assert_bw_close(j, t):
    (jm, jll), (tm, tll) = j, t
    assert len(jll) == len(tll)
    np.testing.assert_allclose(tll, jll, rtol=LL_RTOL)
    for name in ("trans", "emit", "initial"):
        np.testing.assert_allclose(np.log(getattr(tm, name)),
                                   np.log(getattr(jm, name)), rtol=0,
                                   atol=PARAM_ATOL)
    assert tm.states == jm.states


def test_em_iteration_forms_agree():
    """One EM iteration: the port's associative and sequential E-steps
    against each other and against the JAX package's (the sequential
    form reached by tiling the batch past B·S = 65,536 with weight-0
    copies, as the JAX package's test does)."""
    rng = np.random.default_rng(2)
    bsz, t_len, s, o_n = 12, 9, 3, 4
    obs = rng.integers(0, o_n, (bsz, t_len)).astype(np.int32)
    lengths = rng.integers(1, t_len + 1, bsz).astype(np.int32)

    def rls(shape):
        m = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1])
        return np.log(m).astype(np.float32)
    params = rls((s,)), rls((s, s)), rls((s, o_n))
    reps = (65536 // s) // bsz + 1
    w = np.ones(bsz, np.float32)
    w_big = np.concatenate([w, np.zeros(bsz * (reps - 1), np.float32)])
    out = {}
    for form, (o, n, ww) in (("assoc", (obs, lengths, w)),
                             ("seq", (np.tile(obs, (reps, 1)),
                                      np.tile(lengths, reps), w_big))):
        j = jax.jit(JH._bw_em_iter(jnp.asarray(o), jnp.asarray(n),
                                   jnp.asarray(ww),
                                   jnp.asarray(1e-4, jnp.float32), s, o_n))(
            tuple(jnp.asarray(p) for p in params), None)
        t = TH._bw_em_iter(torch.from_numpy(o), torch.from_numpy(n),
                           torch.from_numpy(ww), torch.tensor(1e-4), s, o_n)(
            *(torch.from_numpy(p) for p in params))
        out[form] = t
        np.testing.assert_allclose(float(t[1]), float(j[1]), rtol=LL_RTOL)
        for a, b in zip(t[0], j[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL)
    np.testing.assert_allclose(float(out["assoc"][1]), float(out["seq"][1]),
                               rtol=LL_RTOL)
    for a, b in zip(out["assoc"][0], out["seq"][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("n_states", [1, 2, 3])
def test_baum_welch_matches_associative_form(n_states):
    """``BW_SEQS`` sequences (the associative E-step), 10 iterations,
    the single-dispatch path."""
    rows, names = _planted(BW_SEQS)
    kwargs = dict(n_iters=10, seed=1)
    _assert_bw_close(JH.train_baum_welch(rows, names, n_states, **kwargs),
                     TH.train_baum_welch(rows, names, n_states,
                                         device="cpu", **kwargs))


def test_baum_welch_matches_sequential_form():
    """32,800 short sequences, 2 states: B·S > 65,536 takes the
    sequential E-step in both packages."""
    rng = np.random.default_rng(1)
    names = list("abcd")
    rows = [[names[i] for i in rng.integers(0, 4, rng.integers(2, 5))]
            for _ in range(32_800)]
    _assert_bw_close(JH.train_baum_welch(rows, names, 2, n_iters=10,
                                         seed=1),
                     TH.train_baum_welch(rows, names, 2, n_iters=10, seed=1,
                                         device="cpu"))


@pytest.mark.parametrize("scale", [1, 1000])
def test_baum_welch_chunked_path_matches(tmp_path, scale):
    """The checkpointing path (chunks of 4, the last clamped): the same
    LL history and model as the JAX package's, and as the port's own
    single-dispatch path."""
    rows, names = _planted(BW_SEQS)
    kwargs = dict(n_iters=10, seed=2, chunk_size=4, scale=scale)
    j = JH.train_baum_welch(rows, names, 2, checkpoint_path=str(
        tmp_path / "j.npz"), **kwargs)
    t = TH.train_baum_welch(rows, names, 2, checkpoint_path=str(
        tmp_path / "t.npz"), device="cpu", **kwargs)
    assert len(t[1]) == 10
    if scale > 1:
        np.testing.assert_allclose(t[0].trans, j[0].trans, atol=1)
        np.testing.assert_allclose(t[1], j[1], rtol=LL_RTOL)
    else:
        _assert_bw_close(j, t)
    w = TH.train_baum_welch(rows, names, 2, n_iters=10, seed=2, scale=scale,
                            device="cpu")
    np.testing.assert_array_equal(w[1], t[1])
    np.testing.assert_array_equal(w[0].trans, t[0].trans)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_convergence_stop_matches(tmp_path, checkpointed):
    """``ll_rel_tol``: the same number of iterations run and the same
    converged flag as the JAX package, on both paths."""
    rows, names = _planted(BW_SEQS)
    kwargs = dict(n_iters=200, seed=1, ll_rel_tol=1e-4, chunk_size=4)
    paths = {side: (str(tmp_path / f"{side}.npz") if checkpointed else None)
             for side in "jt"}
    _, jll = JH.train_baum_welch(rows, names, 2,
                                 checkpoint_path=paths["j"], **kwargs)
    _, tll = TH.train_baum_welch(rows, names, 2, checkpoint_path=paths["t"],
                                 device="cpu", **kwargs)
    assert len(tll) == len(jll) < 200
    np.testing.assert_allclose(tll, jll, rtol=LL_RTOL)
    assert (TH.ll_converged(tll.tolist(), 1e-4)
            == JH.ll_converged(jll.tolist(), 1e-4) is True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """One package runs a chunk and writes its checkpoint; the other
    resumes it to 10 iterations and matches an uninterrupted run."""
    rows, names = _planted(BW_SEQS)
    ck = str(tmp_path / "bw.npz")
    first, second = ((JH, {}), (TH, {"device": "cpu"}))
    if writer == "torch":
        first, second = second, first
    first[0].train_baum_welch(rows, names, 2, n_iters=4, seed=3,
                              chunk_size=4, checkpoint_path=ck, **first[1])
    with np.load(ck) as saved:
        assert sorted(saved.files) == ["data_fp", "le", "li", "ll", "lt"]
        assert len(saved["ll"]) == 4 and saved["lt"].dtype == np.float32
    resumed = second[0].train_baum_welch(rows, names, 2, n_iters=10, seed=3,
                                         chunk_size=4, checkpoint_path=ck,
                                         **second[1])
    with np.load(ck) as saved:
        assert len(saved["ll"]) == 10
    _assert_bw_close(JH.train_baum_welch(rows, names, 2, n_iters=10, seed=3),
                     resumed)


def test_port_resume_equals_uninterrupted(tmp_path):
    """The port stopped after a chunk and resumed gives the bits of its
    uninterrupted run; a finished checkpoint reruns idempotently; another
    configuration's checkpoint is ignored with a warning."""
    rows, names = _planted(BW_SEQS)
    ck = str(tmp_path / "bw.npz")
    kwargs = dict(seed=3, chunk_size=4, device="cpu")
    m_full, ll_full = TH.train_baum_welch(
        rows, names, 2, n_iters=10, checkpoint_path=str(tmp_path / "u.npz"),
        **kwargs)
    TH.train_baum_welch(rows, names, 2, n_iters=4, checkpoint_path=ck,
                        **kwargs)
    for _ in range(2):
        m_b, ll_b = TH.train_baum_welch(rows, names, 2, n_iters=10,
                                        checkpoint_path=ck, **kwargs)
        np.testing.assert_array_equal(ll_b, ll_full)
        np.testing.assert_array_equal(m_b.emit, m_full.emit)
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        m_d, ll_d = TH.train_baum_welch(rows, names, 3, n_iters=5,
                                        checkpoint_path=ck, **kwargs)
    assert m_d.trans.shape == (3, 3) and len(ll_d) == 5


def test_fingerprint_is_the_jax_packages():
    rows, names = _planted(10)
    batch, lengths = JH._encode_padded_batch(rows, names)
    import hashlib
    fp = hashlib.sha256()
    for part in (batch.tobytes(), lengths.tobytes(), repr(names).encode(),
                 b"2"):
        fp.update(part)
    assert TH.data_fingerprint(batch, lengths, names, 2) == fp.hexdigest()


def test_baum_welch_refusals():
    with pytest.raises(ValueError, match="zero-length"):
        TH.train_baum_welch([["a", "b"], []], ["a", "b"], 2, n_iters=2,
                            device="cpu")
    with pytest.raises(ValueError, match="smoothing"):
        TH.train_baum_welch([["a"]], ["a"], 1, smoothing=0, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP queue A, 'Multi-device "
                                         "layer'"):
        TH.train_baum_welch([["a"]], ["a"], 1, mesh=object(), device="cpu")
    for fn in (TH.score_long, TH.predict_states_long):
        with pytest.raises(ValueError, match="Multi-device layer"):
            fn(_loyalty_model(), ["SL"], mesh=object())


# --------------------------------------------------------------------------
# the two verbs through both CLIs
# --------------------------------------------------------------------------

def _write(path, rows):
    path.write_text("".join(",".join(r) + "\n" for r in rows))
    return str(path)


def _run_both(capsys, args):
    out = {}
    for tag, run, flags in (("j", jmain, []),
                            ("t", tmain, ["--device", "cpu"])):
        run([a.replace("{tag}", tag) for a in args] + flags)
        out[tag] = capsys.readouterr().out
    return out


@pytest.mark.parametrize("mode", ["tagged", "partial", "tagged-scale1"])
def test_hmm_verbs_match_the_jax_cli(tmp_path, capsys, mode):
    """HiddenMarkovModelBuilder (tagged or partially tagged) and then
    ViterbiStatePredictor on the observations: model and path files
    byte-identical."""
    tagged = TG.hmm_tagged_rows(300, *LOYALTY, seed=9)
    if mode == "partial":
        rows = [[r[0]] + [t.split(":")[1] if i % 5 == 0 else t.split(":")[0]
                          for i, t in enumerate(r[1:])] for r in tagged]
        rows = [r[1:] for r in rows]
    else:
        rows = tagged
    data = _write(tmp_path / "train.csv", rows)
    test = _write(tmp_path / "obs.csv",
                  [[r[0]] + [t.split(":")[0] for t in r[1:]]
                   for r in tagged[:100]])
    props = tmp_path / "h.properties"
    props.write_text(
        "field.delim.regex=,\n"
        f"model.states={','.join(TG.LOYALTY_STATES)}\n"
        f"model.observations={','.join(TG.LOYALTY_OBSERVATIONS)}\n"
        + ("skip.field.count=1\n" if mode != "partial" else
           "partially.tagged=true\nwindow.function=3,2,1\n")
        + ("trans.prob.scale=1\n" if mode == "tagged-scale1" else ""))
    out = _run_both(capsys, ["HiddenMarkovModelBuilder", data,
                             str(tmp_path / "model_{tag}.txt"), "--conf",
                             str(props)])
    assert out["j"] == out["t"] == ""
    assert ((tmp_path / "model_j.txt").read_bytes()
            == (tmp_path / "model_t.txt").read_bytes())
    out = _run_both(capsys, ["ViterbiStatePredictor", test,
                             str(tmp_path / "paths_{tag}.txt"), "--conf",
                             str(props), "-D",
                             f"hmm.model.path={tmp_path / 'model_j.txt'}"])
    assert out["j"] == out["t"]
    assert ((tmp_path / "paths_j.txt").read_bytes()
            == (tmp_path / "paths_t.txt").read_bytes())
    assert len((tmp_path / "paths_t.txt").read_text().splitlines()) == 100


def _assert_model_files_close(a, b):
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    assert la[:2] == lb[:2] and len(la) == len(lb)
    for x, y in zip(la[2:], lb[2:]):
        np.testing.assert_allclose(np.log([float(v) for v in y.split(",")]),
                                   np.log([float(v) for v in x.split(",")]),
                                   rtol=0, atol=2 * PARAM_ATOL)


@pytest.mark.parametrize("extra", [
    [],
    ["-D", "checkpoint.file.path={dir}/ck_{tag}.npz",
     "-D", "iteration.chunk.size=4"],
    ["-D", "convergence.threshold=1e-4", "-D", "num.iterations=200"]],
    ids=["while", "checkpointed", "converging"])
def test_untagged_builder_matches_the_jax_cli(tmp_path, capsys, extra):
    """``training.mode=untagged``: the BaumWelch JSON line's iterations
    and converged flag equal, its log-likelihood within LL_RTOL, the
    model files' states and observations equal and their (float)
    probabilities within PARAM_ATOL in log space, once more rounded by
    the file's six digits."""
    rows, names = _planted(BW_SEQS)
    data = _write(tmp_path / "obs.csv", [r + [""] for r in rows])
    props = tmp_path / "u.properties"
    props.write_text("field.delim.regex=,\ntraining.mode=untagged\n"
                     "num.states=2\nnum.iterations=10\nrandom.seed=1\n"
                     "trans.prob.scale=1\n")
    out = _run_both(capsys, ["HiddenMarkovModelBuilder", data,
                             str(tmp_path / "model_{tag}.txt"), "--conf",
                             str(props)]
                    + [e.replace("{dir}", str(tmp_path)) for e in extra])
    j, t = json.loads(out["j"]), json.loads(out["t"])
    assert list(j) == list(t) == ["BaumWelch.LogLikelihood",
                                  "BaumWelch.Iterations",
                                  "BaumWelch.Converged"]
    assert t["BaumWelch.Iterations"] == j["BaumWelch.Iterations"]
    assert t["BaumWelch.Converged"] == j["BaumWelch.Converged"]
    assert t["BaumWelch.LogLikelihood"] == pytest.approx(
        j["BaumWelch.LogLikelihood"], rel=LL_RTOL)
    _assert_model_files_close(tmp_path / "model_j.txt",
                              tmp_path / "model_t.txt")
