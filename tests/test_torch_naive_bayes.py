"""The port's Naive Bayes against the JAX package: counts, the model file
byte for byte, cross-loading, predictions and the interop carrier."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.models import naive_bayes as jnb

from avenir_tpu_torch import interop
from avenir_tpu_torch.models import naive_bayes as tnb

from _torch_parity import tables

torch.set_num_threads(2)

_FIELDS = ("class_counts", "post_counts", "prior_counts", "cont_count",
           "cont_sum", "cont_sumsq")


def _trained(name, seed=21):
    j_train, j_test, t_train, t_test = tables(name, 1500, 400, seed=seed)
    j_model, j_meta, j_metrics = jnb.train(j_train)
    t_model, t_meta, t_metrics = tnb.train(t_train)
    return (j_train, j_test, t_train, t_test, j_model, j_meta, t_model,
            t_meta, j_metrics, t_metrics)


def _cont_lines(path):
    """(mean, std) fields of the continuous lines, and the other lines."""
    cont, other = [], []
    for line in open(path).read().splitlines():
        items = line.split(",")
        if len(items) == 5:
            cont.append((items[:3], int(items[3]), int(items[4])))
        else:
            other.append(line)
    return cont, other


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_train_counts_and_meta(name):
    (_, _, _, _, j_model, j_meta, t_model, t_meta, j_metrics,
     t_metrics) = _trained(name)
    assert vars(j_meta) == vars(t_meta)
    assert j_metrics.to_json() == t_metrics.to_json()
    for f in ("class_counts", "post_counts", "prior_counts", "cont_count"):
        assert np.array_equal(np.asarray(getattr(j_model, f)),
                              getattr(t_model, f).numpy()), f
    for f in ("cont_sum", "cont_sumsq"):
        # f32 sums of 1500 terms in another order
        np.testing.assert_allclose(getattr(t_model, f).numpy(),
                                   np.asarray(getattr(j_model, f)),
                                   rtol=2e-6)


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_model_file_byte_identical(name, tmp_path):
    (_, _, _, _, j_model, j_meta, t_model, t_meta, _, _) = _trained(name)
    jnb.save_model(j_model, j_meta, str(tmp_path / "j.txt"))
    tnb.save_model(t_model, t_meta, str(tmp_path / "t.txt"))
    j_bytes = (tmp_path / "j.txt").read_bytes()
    t_bytes = (tmp_path / "t.txt").read_bytes()
    if name == "churn":
        assert j_bytes == t_bytes       # integer counts only
        return
    # continuous features: mean and stddev are rounded from f32 moments
    # summed in another order, so a value sitting on .5 could round either
    # way; allow 1 there, require every other byte equal
    j_cont, j_other = _cont_lines(tmp_path / "j.txt")
    t_cont, t_other = _cont_lines(tmp_path / "t.txt")
    assert j_other == t_other and len(j_cont) == len(t_cont) > 0
    for (jk, jm, js), (tk, tm, ts) in zip(j_cont, t_cont):
        assert jk == tk and abs(jm - tm) <= 1 and abs(js - ts) <= 1


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_each_package_loads_the_others_model(name, tmp_path):
    (_, j_test, _, t_test, j_model, j_meta, t_model, t_meta, _,
     _) = _trained(name)
    jnb.save_model(j_model, j_meta, str(tmp_path / "j.txt"))
    tnb.save_model(t_model, t_meta, str(tmp_path / "t.txt"))
    from_j = tnb.load_model(str(tmp_path / "j.txt"), t_meta, device="cpu")
    from_t = jnb.load_model(str(tmp_path / "t.txt"), j_meta)
    own_t = tnb.load_model(str(tmp_path / "t.txt"), t_meta, device="cpu")
    own_j = jnb.load_model(str(tmp_path / "j.txt"), j_meta)
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(from_j, f).numpy(),
                                   np.asarray(getattr(own_j, f)), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(getattr(from_t, f)),
                                   getattr(own_t, f).numpy(), rtol=1e-6)
    # re-saving the loaded model reproduces the file
    tnb.save_model(from_j, t_meta, str(tmp_path / "again.txt"))
    if name == "churn":
        assert ((tmp_path / "again.txt").read_bytes()
                == (tmp_path / "j.txt").read_bytes())


def _assert_predictions_agree(jp, tp, continuous=False):
    assert np.array_equal(jp.predicted, tp.predicted)
    # floor(exp(.)*100) can sit on an integer boundary. Gaussian densities
    # push it far above 100, and there it carries the log-space error below
    diff = np.abs(jp.class_percent.astype(np.int64) - tp.class_percent)
    rel = 3e-4 if continuous else 0.0
    assert np.all(diff <= np.maximum(1, rel * np.abs(tp.class_percent)))
    for t, j in ((tp.feature_post, jp.feature_post),
                 (tp.feature_prior, jp.feature_prior)):
        j = np.asarray(j)
        if continuous:
            # the Gaussian moments are f32 sums in another order (rtol 2e-6,
            # test_train_counts_and_meta); a sum of 9 log-densities of
            # magnitude ~50 carries that as ~1e-4 absolute, at most 4.1e-6
            # relative (seeds 5, 7, 11, 21), so compare the logs. On the
            # same model the predictions are bit for bit
            # (test_predict_bit_identical_on_the_jax_model)
            with np.errstate(divide="ignore"):
                np.testing.assert_allclose(np.log(t), np.log(j), rtol=5e-6,
                                           atol=0)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5)


@pytest.mark.parametrize("name,laplace", [("churn", 0.0), ("churn", 1.0),
                                          ("elearn", 0.0)])
def test_predict_agrees(name, laplace):
    (_, j_test, _, t_test, j_model, j_meta, t_model, t_meta, _,
     _) = _trained(name)
    jp = jnb.predict(j_model, j_meta, j_test, laplace=laplace)
    tp = tnb.predict(t_model, t_meta, t_test, laplace=laplace)
    _assert_predictions_agree(jp, tp, continuous=name == "elearn")
    assert (jnb.validate(jp, j_test).report().to_json()
            == tnb.validate(tp, t_test).report().to_json())


def test_cost_arbitration_and_diff_threshold():
    (_, j_test, _, t_test, j_model, j_meta, t_model, t_meta, _,
     _) = _trained("churn", seed=22)
    kw = dict(laplace=1.0, predicting_classes=("open", "closed"),
              class_cost=(3, 1))
    jp, tp = (jnb.predict(j_model, j_meta, j_test, **kw),
              tnb.predict(t_model, t_meta, t_test, **kw))
    assert np.array_equal(jp.predicted, tp.predicted)
    jp = jnb.predict(j_model, j_meta, j_test, class_prob_diff_threshold=10)
    tp = tnb.predict(t_model, t_meta, t_test, class_prob_diff_threshold=10)
    assert np.array_equal(jp.ambiguous, tp.ambiguous)


def test_weighted_train_matches():
    j_train, _, t_train, _ = tables("churn", 800, 1, seed=23)
    w = (np.random.default_rng(1).random(800) < 0.5).astype(np.float32)
    j_model, _, _ = jnb.train(j_train, jnp.asarray(w))
    t_model, _, _ = tnb.train(t_train, torch.from_numpy(w))
    for f in ("class_counts", "post_counts", "prior_counts"):
        assert np.array_equal(np.asarray(getattr(j_model, f)),
                              getattr(t_model, f).numpy()), f


def _assert_bit_identical(jp, tp):
    for f in ("class_percent", "predicted", "prob", "feature_post",
              "feature_prior"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              np.asarray(getattr(tp, f))), f


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_model_carried_through_interop_predicts_the_same(name):
    (_, j_test, _, t_test, j_model, j_meta, _, t_meta, _, _) = _trained(name)
    arrays = {f: np.asarray(getattr(j_model, f)) for f in _FIELDS}
    carried = interop.bayes_model_from_numpy(arrays, device="cpu")
    jp = jnb.predict(j_model, j_meta, j_test, laplace=1.0)
    tp = tnb.predict(carried, t_meta, t_test, laplace=1.0)
    _assert_predictions_agree(jp, tp, continuous=name == "elearn")
    _assert_bit_identical(jp, tp)


@pytest.mark.parametrize("name,laplace,seed", [
    ("elearn", 0.0, 21), ("elearn", 0.0, 5), ("elearn", 1.0, 7),
    ("churn", 0.0, 21), ("churn", 1.0, 5)])
def test_predict_bit_identical_on_the_jax_model(name, laplace, seed):
    """On the same model the port's predictor equals the JAX package's
    jitted one bit for bit (ROADMAP C9, repaired): XLA's log and exp, the
    fused square-and-subtract of the log-density, float64 square roots,
    the feature sums in XLA's order, divisions by tensors."""
    j_train, j_test, _, t_test = tables(name, 1500, 400, seed=seed)
    j_model, j_meta, _ = jnb.train(j_train)
    carried = interop.bayes_model_from_numpy(
        {f: np.asarray(getattr(j_model, f)) for f in _FIELDS}, device="cpu")
    _assert_bit_identical(jnb.predict(j_model, j_meta, j_test,
                                      laplace=laplace),
                          tnb.predict(carried, j_meta, t_test,
                                      laplace=laplace))


def test_percent_saturates_as_xla_converts():
    """A posterior past 2^31/100 percent saturates to INT32_MAX as XLA's
    conversion does (a plain cast of inf differs between CPU and GPU)."""
    x = torch.tensor([1e30, float("inf"), -1.0, float("nan"), 250.7])
    assert tnb._to_int32(x).tolist() == [2 ** 31 - 1, 2 ** 31 - 1, -1, 0,
                                         250]
