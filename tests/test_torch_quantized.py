"""The port's quantized candidate pass + exact f32 re-rank against the JAX
package's (``avenir_tpu.ops.quantized``), on the CPU: the same numpy-seeded
inputs through both.

int8 must be byte-identical (integer metrics, unique (metric, id) keys,
the re-rank summed as XLA's CPU backend sums it); bf16 is held by the
near-tie rule (its f32 sums may take another order), and both by the
recall bounds of ``tests/test_quantized.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu.ops import quantized as JQ
from avenir_tpu.ops.distance import pairwise_topk as jax_pairwise_topk

from avenir_tpu_torch.ops import quantized as TQ

torch.set_num_threads(2)

MIN_RECALL = 0.985
MIN_VOTE_AGREEMENT = 0.99


def _mixed_magnitudes(rng, m, n, d=8):
    scales = np.float32(10.0) ** rng.integers(-3, 4, d).astype(np.float32)
    x = rng.random((m, d), dtype=np.float32) * scales
    y = rng.random((n, d), dtype=np.float32) * scales
    return x, y


def _constant_columns(rng, m, n, d=8):
    x = rng.random((m, d), dtype=np.float32)
    y = rng.random((n, d), dtype=np.float32)
    x[:, 2] = y[:, 2] = 0.37
    x[:, 5] = y[:, 5] = 0.0
    return x, y


def _near_ties(rng, m, n, d=8):
    x = rng.random((m, d), dtype=np.float32)
    y = np.empty((n, d), dtype=np.float32)
    for i in range(n):
        y[i] = x[i % m] + rng.normal(0, 1e-3, d).astype(np.float32)
    return x, y


ADVERSARIAL = {"mixed_magnitudes": _mixed_magnitudes,
               "constant_columns": _constant_columns,
               "near_ties": _near_ties}


def _f64_truth(x, y, k):
    dd = ((x[:, None, :].astype(np.float64)
           - y[None].astype(np.float64)) ** 2).sum(-1)
    m, n = dd.shape
    order = np.lexsort((np.broadcast_to(np.arange(n), (m, n)), dd), axis=1)
    return dd, order[:, :min(k, n)]


def _recall(truth, ids):
    return float(np.mean([len(set(t.tolist()) & set(q.tolist())) / len(t)
                          for t, q in zip(truth, ids)]))


def _both(x_num, y_num, x_cat=None, y_cat=None, **kw):
    """(JAX (dist, ids), port (dist, ids)) as numpy arrays."""
    j = JQ.quantized_topk(*(None if a is None else jnp.asarray(a)
                            for a in (x_num, y_num, x_cat, y_cat)), **kw)
    t = TQ.quantized_topk(x_num, y_num, x_cat, y_cat, device="cpu", **kw)
    return tuple(map(np.asarray, j)), tuple(a.numpy() for a in t)


def _near_tie_rows(dd, k, rtol=1e-5):
    part = np.sort(dd, axis=1)
    if part.shape[1] <= k:
        return np.zeros(dd.shape[0], bool)
    # any two of the first k + 1 metrics within rtol: the f32 order of
    # either may differ
    head = part[:, :k + 1]
    gaps = np.diff(head, axis=1)
    return np.any(gaps <= rtol * np.maximum(head[:, 1:], 1e-12), axis=1)


def _seed(case, qdtype, n):
    return 1000 * sorted(ADVERSARIAL).index(case) + 100 * (qdtype == "bf16") \
        + n


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
@pytest.mark.parametrize("n", [1, 3, 7, 13, 64, 256])
def test_adversarial_parity_matrix(case, qdtype, n):
    """int8: ids and scaled distances byte-identical to JAX. bf16: rows
    may differ only where two of the k + 1 nearest rows are near-ties, by
    at most 1 in a scaled int. Both hold the recall and vote bounds of the
    JAX matrix against the float64 truth."""
    rng = np.random.default_rng(_seed(case, qdtype, n))
    x, y = ADVERSARIAL[case](rng, 24, n)
    oversample = 8 if (qdtype == "bf16" and case == "mixed_magnitudes") \
        else 4
    (dj, ij), (dt, it) = _both(x, y, k=5, qdtype=qdtype,
                               oversample=oversample, block_size=256)
    assert it.shape == ij.shape == (24, min(5, n))
    assert it.dtype == np.int32 and dt.dtype == np.int32
    dd, truth = _f64_truth(x, y, 5)
    if qdtype == "int8":
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
    else:
        differ = np.any(it != ij, axis=1)
        assert not np.any(differ & ~_near_tie_rows(dd, 5))
        assert np.abs(dt.astype(np.int64) - dj).max(initial=0) <= 1
    assert _recall(truth, it) >= MIN_RECALL
    labels = (y[:, 0] > np.median(y[:, 0])).astype(np.int64)
    vote = lambda idx: (labels[idx].mean(axis=1) > 0.5)  # noqa: E731
    assert float((vote(truth) == vote(it)).mean()) >= MIN_VOTE_AGREEMENT


@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_k_sweep_pow2_sizes(k):
    rng = np.random.default_rng(11 + k)
    x, y = _mixed_magnitudes(rng, 32, 128)
    (dj, ij), (dt, it) = _both(x, y, k=k, qdtype="int8", block_size=64)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert _recall(_f64_truth(x, y, k)[1], it) >= MIN_RECALL


def test_mixed_categorical_features():
    """One-hot categoricals ride the same contraction: byte-identical to
    JAX, and within the bounds of the exact path."""
    rng = np.random.default_rng(17)
    m, n, n_bins = 24, 200, 5
    x_num = rng.random((m, 4), dtype=np.float32)
    y_num = rng.random((n, 4), dtype=np.float32)
    x_cat = rng.integers(0, n_bins, (m, 3)).astype(np.int32)
    y_cat = rng.integers(0, n_bins, (n, 3)).astype(np.int32)
    (dj, ij), (dt, it) = _both(x_num, y_num, x_cat, y_cat, k=5,
                               n_cat_bins=n_bins, block_size=64)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    de, ie = map(np.asarray, jax_pairwise_topk(
        jnp.asarray(x_num), jnp.asarray(y_num), jnp.asarray(x_cat),
        jnp.asarray(y_cat), k=5, n_cat_bins=n_bins, mode="exact"))
    assert _recall(ie, it) >= MIN_RECALL
    for r in range(m):
        exact = dict(zip(ie[r].tolist(), de[r].tolist()))
        for i, d in zip(it[r].tolist(), dt[r].tolist()):
            assert i not in exact or abs(d - exact[i]) <= 1


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="manhattan"), "euclidean"),
    (dict(qdtype="fp4"), "qdtype"),
    (dict(oversample=0), "oversample")])
def test_rejects_invalid_config(kw, match):
    x, y = np.ones((4, 3), np.float32), np.ones((8, 3), np.float32)
    with pytest.raises(ValueError, match=match):
        JQ.quantized_topk(jnp.asarray(x), jnp.asarray(y), k=2, **kw)
    with pytest.raises(ValueError, match=match):
        TQ.quantized_topk(x, y, k=2, device="cpu", **kw)


def test_oversample_widens_candidates():
    """At oversample 1 a near-tie spectrum can miss true neighbors; the
    default 4 recovers them. Each equals JAX's."""
    rng = np.random.default_rng(23)
    x, y = _near_ties(rng, 8, 96)
    truth = _f64_truth(x, y, 5)[1]
    recalls = []
    for oversample in (1, 4):
        (dj, ij), (dt, it) = _both(x, y, k=5, oversample=oversample)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
        recalls.append(_recall(truth, it))
    assert recalls[1] >= MIN_RECALL and recalls[1] >= recalls[0]


@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
def test_candidate_set_does_not_depend_on_blocks(qdtype):
    """The running top-k′ keeps the k′ smallest (metric, id) keys however
    the train rows are cut, as JAX's stable ``lax.top_k`` merge does."""
    rng = np.random.default_rng(29)
    x, y = _near_ties(rng, 16, 300)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = np.asarray(JQ._candidate_topk(jnp.asarray(x), jnp.asarray(y),
                                         20, 64, qdtype))
    for block in (7, 64, 300, 4096):
        got = TQ._candidate_topk(xt, yt, 20, block, qdtype).numpy()
        np.testing.assert_array_equal(got, want)


def test_order_key_orders_pairs_lexicographically():
    rng = np.random.default_rng(31)
    metric = rng.choice(np.float32([-3.5, -1e-30, 0.0, 1e-30, 2.0, 2.0,
                                    3.4e38, -2.5e7]), (5, 40))
    ids = np.stack([rng.permutation(40) for _ in range(5)]).astype(np.int32)
    keys = TQ.order_key(torch.from_numpy(metric), torch.from_numpy(ids))
    got = torch.sort(keys, dim=1).indices.numpy()
    want = np.stack([np.lexsort((i, m)) for m, i in zip(metric, ids)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TQ.key_ids(keys).numpy(), ids)


def test_int8_cross_is_exact_past_the_f32_range():
    """2,100 features at ±127: partial sums pass 2²⁴, so the product runs
    1,024 features at a time, each exact, summed in int32."""
    rng = np.random.default_rng(37)
    a = rng.integers(-127, 128, (5, 2100)).astype(np.int8)
    b = rng.integers(-127, 128, (2100, 6)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = TQ.int8_cross(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 3, 9, 19, 25])
def test_metrics_match_jax(d):
    """Scale, int8 codes, the candidate metrics and the exact re-rank
    metric against the JAX functions on the same operands, compiled as
    every JAX caller runs them (eager JAX sums the re-rank another way)."""
    rng = np.random.default_rng(41 + d)
    x, y = _mixed_magnitudes(rng, 12, 30, d)
    rows = rng.integers(0, 30, (12, 7))          # 7 candidates a query

    @jax.jit
    def jax_side(x, y, rows):
        jx, jy = JQ._quantize_int8(x, y)
        return (jx, jy, JQ._candidate_metric(jx, jy, "int8"),
                JQ.gathered_candidate_metric(jx, jy[rows], "int8"),
                JQ.gathered_candidate_metric(x, y[rows], "bf16"),
                JQ.exact_candidate_metric(x, y[rows], d))

    want = [np.asarray(a) for a in jax_side(x, y, rows)]
    xt, yt, rt = torch.from_numpy(x), torch.from_numpy(y), \
        torch.from_numpy(rows)
    tx, ty = TQ._quantize_int8(xt, yt)
    got = [tx, ty, TQ._candidate_metric(tx, ty, "int8"),
           TQ.gathered_candidate_metric(tx, ty[rt], "int8"),
           TQ.gathered_candidate_metric(xt, yt[rt], "bf16"),
           TQ.exact_candidate_metric(xt, yt[rt], d)]
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:       # bf16: f32 sums in another order
            np.testing.assert_allclose(
                g.numpy(), w, rtol=1e-5,
                atol=1e-5 * float(np.abs(y).max()) ** 2)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device"):
        TQ.quantized_topk(x, x, k=2)
