"""The port's KNN classification against the JAX package's exact mode,
the chunked feed, and the config gate."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.models import knn as jknn
from avenir_tpu.models import naive_bayes as jnb

from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.models import naive_bayes as tnb

from _torch_parity import exact_metrics, near_tie_rows, tables

torch.set_num_threads(2)


def _feature_post(j_train, t_train):
    j_model, j_meta, _ = jnb.train(j_train)
    t_model, t_meta, _ = tnb.train(t_train)
    return (jnp.asarray(jnb.predict(j_model, j_meta, j_train,
                                    laplace=1.0).feature_post),
            torch.from_numpy(tnb.predict(t_model, t_meta, t_train,
                                         laplace=1.0).feature_post))


def _allowed_differences(t_train, t_test, jp, tp, k):
    """Rows where the two packages may classify differently: a near-tie at
    the k boundary (either neighbor is as good), a neighbor distance on a
    rounding boundary (scaled ints within 1), or a near-tie of the top two
    class votes (float weights summed in another order)."""
    tr_num, tr_cat, _ = tknn._split_features(t_train)
    te_num, te_cat, _ = tknn._split_features(t_test)
    np_ = (lambda a: None if a is None else a.numpy())  # noqa: E731
    ties = near_tie_rows(exact_metrics(np_(te_num), np_(tr_num),
                                       np_(te_cat), np_(tr_cat)), k)
    dist_moved = np.any(jp.neighbor_dist != tp.neighbor_dist, axis=1)
    votes = np.sort(np.asarray(jp.class_votes), axis=1)
    vote_tie = (votes[:, -1] - votes[:, -2]) <= 1e-4 * np.abs(votes[:, -1])
    return ties | dist_moved | vote_tie


@pytest.mark.parametrize("name", ["elearn", "churn"])
@pytest.mark.parametrize("kernel", ["none", "linearMultiplicative",
                                    "linearAdditive", "gaussian"])
@pytest.mark.parametrize("weighted", [False, True])
def test_classify_matches_jax_exact(name, kernel, weighted):
    j_train, j_test, t_train, t_test = tables(name, 2000, 400, seed=31)
    cfg = dict(top_match_count=5, kernel_function=kernel, kernel_param=150,
               class_cond_weighted=weighted)
    j_post, t_post = (_feature_post(j_train, t_train) if weighted
                      else (None, None))
    jp = jknn.classify(j_train, j_test, jknn.KnnConfig(mode="exact", **cfg),
                       feature_post=j_post)
    tp = tknn.classify(t_train, t_test, tknn.KnnConfig(**cfg),
                       feature_post=t_post)
    assert tp.neighbor_idx.shape == (400, 5)
    assert np.abs(tp.neighbor_dist.astype(np.int64)
                  - np.asarray(jp.neighbor_dist)).max() <= 1
    differ = jp.predicted != tp.predicted
    allowed = _allowed_differences(t_train, t_test, jp, tp, 5)
    assert not np.any(differ & ~allowed), np.nonzero(differ & ~allowed)
    assert differ.sum() < 0.01 * len(differ)
    if not differ.any():
        positive = "fail" if name == "elearn" else "closed"
        assert (jknn.validate(jp, j_test, positive).report().to_json()
                == tknn.validate(tp, t_test, positive).report().to_json())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["elearn", "churn"])
def test_chunked_feed_equals_unchunked(name, fused):
    _, _, t_train, t_test = tables(name, 1500, 450, seed=32)
    whole = tknn.classify(t_train, t_test, tknn.KnnConfig())
    chunked = tknn.classify(t_train, t_test, tknn.KnnConfig(
        feed_chunk_rows=64, fused=fused))
    assert np.array_equal(whole.neighbor_idx, chunked.neighbor_idx)
    assert np.array_equal(whole.neighbor_dist, chunked.neighbor_dist)
    assert np.array_equal(whole.class_votes, chunked.class_votes)
    assert np.array_equal(whole.predicted, chunked.predicted)


@pytest.mark.parametrize("algorithm,mode", [("manhattan", "fast"),
                                            ("euclidean", "exact")])
def test_plain_paths_match_jax(algorithm, mode):
    """Outside the kernel family (manhattan, exact mode) the plain blocked
    top-k serves; still the JAX package's answers."""
    j_train, j_test, t_train, t_test = tables("elearn", 1200, 300, seed=33)
    jp = jknn.classify(j_train, j_test, jknn.KnnConfig(
        algorithm=algorithm, mode="exact"))
    tp = tknn.classify(t_train, t_test, tknn.KnnConfig(
        algorithm=algorithm, mode=mode, block_size=500))
    differ = jp.predicted != tp.predicted
    assert differ.sum() < 0.01 * len(differ)
    assert np.abs(tp.neighbor_dist.astype(np.int64)
                  - np.asarray(jp.neighbor_dist)).max() <= 1


def test_decision_threshold_and_class_probs():
    j_train, j_test, t_train, t_test = tables("elearn", 1000, 200, seed=34)
    kw = dict(decision_threshold=0.5, positive_class="fail")
    jp = jknn.classify(j_train, j_test, jknn.KnnConfig(mode="exact", **kw))
    tp = tknn.classify(t_train, t_test, tknn.KnnConfig(**kw))
    same = np.all(jp.neighbor_idx == tp.neighbor_idx, axis=1)
    assert same.mean() > 0.95
    assert np.array_equal(jp.predicted[same], tp.predicted[same])
    assert np.array_equal(jp.class_prob[same], tp.class_prob[same])
    with pytest.raises(ValueError, match="decision threshold"):
        tknn.classify(t_train, t_test, tknn.KnnConfig(decision_threshold=0.5))


@pytest.mark.parametrize("field,value,match", [
    ("top_match_count", 0, "top.match.count"),
    ("mode", "approx", "knn.mode"),
    ("algorithm", "cosine", "distAlgorithm")])
def test_validate_config_names_the_key(field, value, match):
    cfg = dataclasses.replace(tknn.KnnConfig(), **{field: value})
    with pytest.raises(ValueError, match=match):
        tknn.validate_config(cfg)
