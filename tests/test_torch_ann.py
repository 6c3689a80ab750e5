"""The port's single-device IVF index (``avenir_tpu_torch.ops.ivf``) and the
``knn.ann`` / ``knn.quantized`` branches of its KNN model, against the JAX
package on the CPU: the same numpy-seeded inputs through both.

- The query path on one index: the JAX-built index carried across with
  ``interop.ivf_index_from_numpy`` answers as JAX's ``ann_topk`` does.
- The clustering: bit-identical to JAX's on integer-valued data (every
  metric and sum exact); on well-separated clusters the same lists, the
  centroids within 1e-5 (XLA and torch sum f32 products in other orders).
- Full probing equals the port's own ``quantized_topk`` exactly (int8).
- K1's plain version at the IVF shape (one class, one feature, nlist bins)
  equals the one-hot counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.models import knn as jknn
from avenir_tpu.ops import histogram as jhist
from avenir_tpu.ops import ivf as JI
from avenir_tpu.parallel import pipeline as jpipe

from avenir_tpu_torch import interop
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.ops import cuda_histogram, ivf as TI
from avenir_tpu_torch.ops import quantized as TQ
from avenir_tpu_torch.parallel import pipeline as tpipe

torch.set_num_threads(2)

MIN_RECALL = 0.985


def _adversarial(case, rng, m, n, d=8):
    x = rng.random((m, d), dtype=np.float32)
    if case == "mixed_magnitudes":
        scales = np.float32(10.0) ** rng.integers(-3, 4, d).astype(
            np.float32)
        return x * scales, rng.random((n, d), dtype=np.float32) * scales
    if case == "constant_columns":
        y = rng.random((n, d), dtype=np.float32)
        x[:, 2] = y[:, 2] = 0.37
        x[:, 5] = y[:, 5] = 0.0
        return x, y
    noise = rng.normal(0, 1e-3, (n, d)).astype(np.float32)
    return x, x[np.arange(n) % m] + noise                  # near ties


CASES = ("constant_columns", "mixed_magnitudes", "near_ties")


def _f64_truth(x, y, k):
    dd = ((x[:, None, :].astype(np.float64)
           - y[None].astype(np.float64)) ** 2).sum(-1)
    m, n = dd.shape
    order = np.lexsort((np.broadcast_to(np.arange(n), (m, n)), dd), axis=1)
    return order[:, :min(k, n)]


def _recall(truth, ids):
    return float(np.mean([len(set(t.tolist()) & set(q.tolist())) / len(t)
                          for t, q in zip(truth, ids)]))


_FIELDS = ("centroids", "cent_valid", "flat", "qflat", "gids", "offsets",
           "lengths", "amax", "nlist", "probe_pad", "n_real", "n_attrs",
           "n_cat_bins", "seed")


def _carried(jindex):
    """The JAX index as the port's, through ``interop``."""
    return interop.ivf_index_from_numpy(
        {f: np.asarray(getattr(jindex, f)) for f in _FIELDS}, device="cpu")


def _assert_same_index(jindex, tindex, centroid_atol=0.0):
    for f in ("gids", "offsets", "lengths", "flat", "qflat", "cent_valid",
              "amax"):
        np.testing.assert_array_equal(getattr(tindex, f).numpy(),
                                      np.asarray(getattr(jindex, f)), f)
    for f in ("nlist", "probe_pad", "n_real", "n_attrs", "n_cat_bins"):
        assert getattr(tindex, f) == getattr(jindex, f), f
    np.testing.assert_allclose(tindex.centroids.numpy(),
                               np.asarray(jindex.centroids), rtol=0,
                               atol=centroid_atol)


def _jax_ann(jindex, x, x_cat=None, **kw):
    return tuple(map(np.asarray, JI.ann_topk(
        jindex, jnp.asarray(x), None if x_cat is None else
        jnp.asarray(x_cat), **kw)))


def _torch_ann(tindex, x, x_cat=None, **kw):
    return tuple(a.numpy() for a in TI.ann_topk(tindex, x, x_cat, **kw))


# ---------------------------------------------------------------------------
# the query path on the JAX index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_probe", [1, 0, 64])
def test_ann_topk_on_the_jax_index_equals_jax(case, n_probe):
    """int8 at a sparse probe, the default and full probing: ids and
    scaled distances byte-identical to JAX's ``ann_topk``."""
    rng = np.random.default_rng(100 + CASES.index(case))
    x, y = _adversarial(case, rng, 24, 512)
    jindex = JI.build_ivf(jnp.asarray(y), nlist=64, seed=0)
    tindex = _carried(jindex)
    dj, ij = _jax_ann(jindex, x, k=5, n_probe=n_probe)
    dt, it = _torch_ann(tindex, x, k=5, n_probe=n_probe)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


def test_ann_topk_bf16_on_the_jax_index():
    """bf16 sums carry no bit claim (JAX): ids equal but for near-tie
    rows, scaled ints within 1."""
    rng = np.random.default_rng(107)
    x, y = _adversarial("constant_columns", rng, 24, 512)
    jindex = JI.build_ivf(jnp.asarray(y), nlist=16, seed=0)
    dj, ij = _jax_ann(jindex, x, k=5, n_probe=4, qdtype="bf16")
    dt, it = _torch_ann(_carried(jindex), x, k=5, n_probe=4, qdtype="bf16")
    assert np.mean(np.all(it == ij, axis=1)) >= 0.95
    assert np.abs(dt.astype(np.int64) - dj).max() <= 1
    truth = _f64_truth(x, y, 5)
    assert abs(_recall(truth, it) - _recall(truth, ij)) <= 0.02


def test_out_of_range_chunk_takes_the_requantized_table():
    """Queries beyond the train magnitudes re-quantize the table at the
    joint scale: still JAX's answer, and still full-probe parity."""
    rng = np.random.default_rng(75)
    y = rng.random((256, 6), dtype=np.float32)
    x = rng.random((16, 6), dtype=np.float32) * 3.0
    jindex = JI.build_ivf(jnp.asarray(y), nlist=8, seed=0)
    dt, it = _torch_ann(_carried(jindex), x, k=5, n_probe=8)
    dj, ij = _jax_ann(jindex, x, k=5, n_probe=8)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    dq, iq = TQ.quantized_topk(x, y, k=5, device="cpu")
    np.testing.assert_array_equal(it, iq.numpy())
    np.testing.assert_array_equal(dt, dq.numpy())


# ---------------------------------------------------------------------------
# the clustering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_bit_identical_on_integer_data(seed):
    """Integer features: every Lloyd metric and sum is exact, so the
    centroids, lists and int8 table equal JAX's bit for bit."""
    rng = np.random.default_rng(200 + seed)
    y = rng.integers(0, 8, (512, 6)).astype(np.float32)
    kw = dict(nlist=8, n_iters=15, seed=seed)
    jindex = JI.build_ivf(jnp.asarray(y), **kw)
    tindex = TI.build_ivf(y, device="cpu", **kw)
    _assert_same_index(jindex, tindex)
    x = rng.integers(0, 8, (16, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        np.stack(_torch_ann(tindex, x, k=5, n_probe=2)),
        np.stack(_jax_ann(jindex, x, k=5, n_probe=2)))


def test_kmeans_on_well_separated_clusters():
    """12 clusters of spread 0.05 at distinct corners of a hypercube of
    side 4: the same lists as JAX, centroids within 1e-5."""
    rng = np.random.default_rng(211)
    corners = rng.permutation(64)[:12]
    centers = np.array([[(c >> b) & 1 for b in range(6)] for c in corners],
                       np.float32) * 4
    y = (centers[rng.integers(0, 12, 800)]
         + rng.normal(0, 0.05, (800, 6))).astype(np.float32)
    jindex = JI.build_ivf(jnp.asarray(y), nlist=12, seed=3)
    tindex = TI.build_ivf(y, nlist=12, seed=3, device="cpu")
    _assert_same_index(jindex, tindex, centroid_atol=1e-5)


def test_seeding_equals_jax():
    rng = np.random.default_rng(213)
    y = rng.random((300, 5), dtype=np.float32)
    for seed in (0, 9):
        np.testing.assert_array_equal(
            TI._seed_centroids(y, 16, np.random.default_rng(seed)),
            JI._seed_centroids(y, 16, np.random.default_rng(seed)))


def test_same_seed_same_index_different_seed_differs():
    rng = np.random.default_rng(33)
    y = rng.random((512, 6), dtype=np.float32)
    a = TI.build_ivf(y, nlist=8, seed=4, device="cpu")
    b = TI.build_ivf(y, nlist=8, seed=4, device="cpu")
    for f in ("centroids", "gids", "flat", "qflat"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    c = TI.build_ivf(y, nlist=8, seed=5, device="cpu")
    assert not torch.equal(a.centroids, c.centroids)


def test_lists_agree_with_returned_centroids():
    rng = np.random.default_rng(63)
    y = rng.random((600, 6), dtype=np.float32)
    index = TI.build_ivf(y, nlist=12, n_iters=3, seed=0, device="cpu")
    cents = index.centroids.numpy().astype(np.float64)
    want = np.argmin(((y[:, None, :].astype(np.float64)
                       - cents[None]) ** 2).sum(-1), axis=1)
    gids, offsets, lengths = (getattr(index, f).numpy()
                              for f in ("gids", "offsets", "lengths"))
    filed = np.full(600, -1)
    for li in range(index.nlist):
        filed[gids[offsets[li]:offsets[li] + lengths[li]]] = li
    np.testing.assert_array_equal(filed, want)


def test_zero_lloyd_iters_is_pure_seeding():
    rng = np.random.default_rng(65)
    y = rng.random((256, 5), dtype=np.float32)
    index = TI.build_ivf(y, nlist=8, n_iters=0, seed=2, device="cpu")
    _, i = TI.ann_topk(index, y[:8], k=3, n_probe=8)
    assert np.all(i[:, 0].numpy() == np.arange(8))


@pytest.mark.parametrize("n,nlist", [(4096, 16), (20_011, 1024)])
def test_k1_plain_at_the_ivf_shape_counts_the_lists(n, nlist):
    """K1's plain version at IVF's shape ([N, 1] bins = list ids, one
    class, nlist bins) equals the one-hot counts and the JAX histogram;
    the Lloyd step's counts are those."""
    rng = np.random.default_rng(n)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    assign[: nlist // 2] = 0                     # a heavy list
    got = cuda_histogram.class_feature_bin_counts_plain(
        torch.from_numpy(assign).reshape(n, 1),
        torch.zeros(n, dtype=torch.int32), 1, nlist).reshape(nlist)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(assign).long(),
                                         nlist).sum(0).to(torch.float32)
    assert torch.equal(got, onehot)
    assert torch.equal(TI._list_counts(torch.from_numpy(assign), nlist),
                       got)
    # assign_counts: the nearest centroid of each row and the list counts
    y = rng.integers(0, 8, (n, 3)).astype(np.float32)
    cents = rng.integers(0, 8, (nlist, 3)).astype(np.float32)
    ta, tc = TI.assign_counts(torch.from_numpy(y), torch.from_numpy(cents))
    ja, jc = JI.assign_counts(jnp.asarray(y), jnp.asarray(cents))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want = jhist.class_feature_bin_counts(
        jnp.asarray(assign)[:, None], jnp.zeros(n, jnp.int32), n_classes=1,
        n_bins=nlist).reshape(nlist)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lloyd_step_counts_through_k1(monkeypatch):
    """Every Lloyd step counts its lists with one call of K1's wrapper."""
    calls = []
    fn = cuda_histogram.class_feature_bin_counts

    def spy(bins, labels, n_classes, n_bins, weights=None):
        calls.append((tuple(bins.shape), n_classes, n_bins))
        return fn(bins, labels, n_classes, n_bins, weights)

    monkeypatch.setattr(cuda_histogram, "class_feature_bin_counts", spy)
    rng = np.random.default_rng(67)
    y = rng.random((700, 4), dtype=np.float32)
    TI.build_ivf(y, nlist=9, n_iters=4, device="cpu")
    assert 1 <= len(calls) <= 4
    assert set(calls) == {((700, 1), 1, 9)}


@pytest.mark.parametrize("n", [0, 7, 512, 513, 5000])
def test_bucket_rows_and_pad_rows_match_jax(n):
    for floor in (8, 512):
        assert tpipe.bucket_rows(n, floor) == jpipe.bucket_rows(n, floor)
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    b = tpipe.bucket_rows(n)
    np.testing.assert_array_equal(tpipe.pad_rows(a, b), jpipe.pad_rows(a, b))
    if n:
        with pytest.raises(ValueError, match="exceeds"):
            tpipe.pad_rows(a, n - 1)


# ---------------------------------------------------------------------------
# full probing is the quantized brute force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_full_probe_equals_quantized_exactly(case):
    rng = np.random.default_rng(7 + CASES.index(case))
    x, y = _adversarial(case, rng, 24, 192)
    index = TI.build_ivf(y, seed=0, device="cpu")
    da, ia = TI.ann_topk(index, x, k=5, n_probe=index.nlist)
    dq, iq = TQ.quantized_topk(x, y, k=5, device="cpu")
    assert torch.equal(ia, iq) and torch.equal(da, dq)


def test_full_probe_parity_with_categoricals():
    rng = np.random.default_rng(17)
    m, n, n_bins = 16, 300, 5
    x_num = rng.random((m, 4), dtype=np.float32)
    y_num = rng.random((n, 4), dtype=np.float32)
    x_cat = rng.integers(0, n_bins, (m, 3)).astype(np.int32)
    y_cat = rng.integers(0, n_bins, (n, 3)).astype(np.int32)
    index = TI.build_ivf(y_num, y_cat, n_cat_bins=n_bins, nlist=8, seed=0,
                         device="cpu")
    da, ia = TI.ann_topk(index, x_num, x_cat, k=5, n_probe=8)
    dq, iq = TQ.quantized_topk(x_num, y_num, x_cat, y_cat, k=5,
                               n_cat_bins=n_bins, device="cpu")
    assert torch.equal(ia, iq) and torch.equal(da, dq)
    jindex = JI.build_ivf(jnp.asarray(y_num), jnp.asarray(y_cat),
                          n_cat_bins=n_bins, nlist=8, seed=0)
    dj, ij = _jax_ann(jindex, x_num, x_cat, k=5, n_probe=8)
    np.testing.assert_array_equal(ia.numpy(), ij)
    np.testing.assert_array_equal(da.numpy(), dj)


# ---------------------------------------------------------------------------
# edges: empty lists, k > N, sparse probes
# ---------------------------------------------------------------------------

def test_nlist_exceeding_rows_yields_empty_lists():
    rng = np.random.default_rng(9)
    y = rng.random((40, 6), dtype=np.float32)
    x = rng.random((12, 6), dtype=np.float32)
    index = TI.build_ivf(y, nlist=64, n_iters=6, seed=0, device="cpu")
    lengths = index.lengths.numpy()
    assert index.nlist == 64 and int(lengths.sum()) == 40
    assert int((lengths == 0).sum()) >= 64 - 40
    _, i = TI.ann_topk(index, x, k=5, n_probe=64)
    assert np.all((i.numpy() >= 0) & (i.numpy() < 40))
    assert _recall(_f64_truth(x, y, 5), i.numpy()) >= MIN_RECALL


def test_k_exceeding_rows_clamps_and_sparse_probes_give_sentinels():
    rng = np.random.default_rng(11)
    y = rng.random((3, 4), dtype=np.float32)
    x = rng.random((6, 4), dtype=np.float32)
    index = TI.build_ivf(y, nlist=2, n_iters=4, seed=0, device="cpu")
    _, i = TI.ann_topk(index, x, k=5, n_probe=2)
    assert i.shape == (6, 3)
    assert np.all(np.sort(i.numpy(), axis=1) == np.arange(3)[None, :])
    # 64 rows in 32 lists, one probed, k = 8: short lists leave (INT_BIG,
    # -1) slots, where JAX leaves them
    y = rng.random((64, 4), dtype=np.float32)
    x = rng.random((12, 4), dtype=np.float32)
    jindex = JI.build_ivf(jnp.asarray(y), nlist=32, seed=0)
    dt, it = _torch_ann(_carried(jindex), x, k=8, n_probe=1)
    dj, ij = _jax_ann(jindex, x, k=8, n_probe=1)
    assert np.any(it < 0)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert np.all((dt == TQ.INT_BIG) == (it < 0))


def test_empty_train_refused():
    with pytest.raises(ValueError, match="empty train"):
        TI.build_ivf(np.zeros((0, 4), np.float32), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(n_probe=9), "n_probe"), (dict(qdtype="fp4"), "qdtype"),
    (dict(oversample=0), "oversample")])
def test_ann_topk_rejects_bad_arguments(kw, match):
    y = np.random.default_rng(5).random((64, 3), dtype=np.float32)
    index = TI.build_ivf(y, nlist=8, device="cpu")
    with pytest.raises(ValueError, match=match):
        TI.ann_topk(index, y[:2], k=2, **kw)


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device"):
        TI.build_ivf(np.ones((8, 2), np.float32))


# ---------------------------------------------------------------------------
# the model: classify, the feed, the cache, the config gate
# ---------------------------------------------------------------------------

_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "a", "ordinal": 1, "dataType": "double", "min": 0, "max": 100,
     "feature": True},
    {"name": "b", "ordinal": 2, "dataType": "double", "min": 0, "max": 100,
     "feature": True},
    {"name": "c", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["u", "v", "w"], "feature": True},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["no", "yes"]}]}


def _tables(seed, n_train=600, n_test=40):
    """(JAX train, JAX test, port train, port test) from the same rows."""
    from avenir_tpu.utils.dataset import Featurizer as JF
    from avenir_tpu.utils.schema import FeatureSchema as JS
    from avenir_tpu_torch.utils.dataset import Featurizer as TF
    from avenir_tpu_torch.utils.schema import FeatureSchema as TS
    rng = np.random.default_rng(seed)

    def rows(prefix, count):
        return [[f"{prefix}{i}", f"{rng.random() * 100:.3f}",
                 f"{rng.random() * 100:.3f}", "uvw"[rng.integers(3)],
                 ["no", "yes"][rng.integers(2)]] for i in range(count)]
    train, test = rows("r", n_train), rows("t", n_test)
    jf = JF(JS.from_json(_SCHEMA)).fit(train)
    tf = TF(TS.from_json(_SCHEMA), device="cpu").fit(train)
    return (jf.transform(train), jf.transform(test), tf.transform(train),
            tf.transform(test))


def _classify_both(seed, jcfg, tcfg, **kw):
    jtr, jte, ttr, tte = _tables(seed, **kw)
    return (jknn.classify(jtr, jte, jcfg), tknn.classify(ttr, tte, tcfg))


def _same_prediction(jp, tp):
    np.testing.assert_array_equal(tp.neighbor_idx, np.asarray(jp.neighbor_idx))
    np.testing.assert_array_equal(tp.neighbor_dist,
                                  np.asarray(jp.neighbor_dist))
    np.testing.assert_array_equal(tp.predicted, jp.predicted)
    np.testing.assert_array_equal(tp.class_votes, jp.class_votes)
    np.testing.assert_array_equal(tp.class_prob, jp.class_prob)


@pytest.mark.parametrize("kw", [
    dict(quantized=True), dict(ann=True),
    dict(ann=True, ann_nlist=16, ann_nprobe=2, ann_iters=3, ann_seed=7),
    dict(ann=True, feed_chunk_rows=16),
    dict(quantized=True, feed_chunk_rows=16,
         kernel_function="linearMultiplicative")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in sorted(kw.items())))
def test_classify_matches_jax(kw):
    jp, tp = _classify_both(55, jknn.KnnConfig(**kw), tknn.KnnConfig(**kw))
    _same_prediction(jp, tp)


def test_sparse_probe_sentinels_masked_in_classify():
    """Fewer than k neighbors: (-1) slots weigh 0 in the vote, as in JAX;
    a query with none at all is refused, as in JAX."""
    kw = dict(ann=True, ann_nlist=32, ann_nprobe=1, top_match_count=8)
    jtr, jte, ttr, tte = _tables(67, n_train=64, n_test=12)
    _, i = tknn.neighbors(ttr, tte, tknn.KnnConfig(**kw))
    i = i.numpy()
    assert np.any(i < 0) and np.all((i >= 0) | (i == -1))
    if np.any(~np.any(i >= 0, axis=1)):
        with pytest.raises(ValueError, match="no neighbors at all"):
            tknn.classify(ttr, tte, tknn.KnnConfig(**kw))
    else:
        _same_prediction(jknn.classify(jtr, jte, jknn.KnnConfig(**kw)),
                         tknn.classify(ttr, tte, tknn.KnnConfig(**kw)))


def test_all_empty_probe_classification_refused(monkeypatch):
    """A query whose probed lists were all empty has no neighbor: both
    packages refuse to classify it (no sound vote) rather than vote for
    class 0 with zero weights."""
    jtr, jte, ttr, tte = _tables(71, n_train=16, n_test=4)
    ids = np.array([[3, -1, -1], [-1, -1, -1], [1, 2, -1], [0, 1, 2]],
                   np.int32)
    dist = np.where(ids >= 0, 100, TQ.INT_BIG).astype(np.int32)
    monkeypatch.setattr(tknn, "neighbors", lambda *a: (
        torch.from_numpy(dist), torch.from_numpy(ids)))
    monkeypatch.setattr(jknn, "neighbors", lambda *a: (
        jnp.asarray(dist), jnp.asarray(ids)))
    kw = dict(ann=True, top_match_count=3)
    for knn, tables in ((tknn, (ttr, tte)), (jknn, (jtr, jte))):
        with pytest.raises(ValueError, match="no neighbors at all"):
            knn.classify(*tables, knn.KnnConfig(**kw))
    keep = [0, 2, 3]
    dist, ids = dist[keep], ids[keep]     # the stand-ins return these now
    tp = tknn.classify(ttr, tte, tknn.KnnConfig(**kw))
    jp = jknn.classify(jtr, jte, jknn.KnnConfig(**kw))
    _same_prediction(jp, tp)


def test_feed_equals_one_shot_and_full_probe_equals_quantized():
    _, _, ttr, tte = _tables(57)
    base = tknn.classify(ttr, tte, tknn.KnnConfig(ann=True))
    fed = tknn.classify(ttr, tte, tknn.KnnConfig(ann=True,
                                                 feed_chunk_rows=7))
    for f in ("neighbor_idx", "neighbor_dist", "predicted", "class_votes"):
        np.testing.assert_array_equal(getattr(fed, f), getattr(base, f))
    nlist = TI.default_nlist(ttr.n_rows)
    full = tknn.classify(ttr, tte, tknn.KnnConfig(
        ann=True, ann_nlist=nlist, ann_nprobe=nlist))
    quant = tknn.classify(ttr, tte, tknn.KnnConfig(quantized=True))
    for f in ("neighbor_idx", "neighbor_dist", "predicted", "class_votes"):
        np.testing.assert_array_equal(getattr(full, f), getattr(quant, f))


def test_index_cache_reused_across_test_tables():
    _, _, ttr, tte = _tables(59)
    cfg = tknn.KnnConfig(ann=True)
    tknn._ANN_INDEX_CACHE.clear()
    tknn.classify(ttr, tte, cfg)
    (first,) = [v[1] for v in tknn._ANN_INDEX_CACHE.values()]
    tknn.classify(ttr, tte, cfg)
    (second,) = [v[1] for v in tknn._ANN_INDEX_CACHE.values()]
    assert first is second
    tknn.classify(ttr, tte, dataclasses.replace(cfg, ann_seed=1))
    (third,) = [v[1] for v in tknn._ANN_INDEX_CACHE.values()]
    assert third is not first


# the single-device rows of tests/test_ann.py's mode matrix
INVALID_CONFIGS = [
    (dict(ann=True, algorithm="manhattan"), "knn.ann supports euclidean"),
    (dict(quantized=True, algorithm="manhattan"),
     "knn.quantized supports euclidean"),
    (dict(ann=True, quantized=True), "knn.ann and knn.quantized conflict"),
    (dict(ann=True, mode="exact"), "knn.mode=exact"),
    (dict(ann=True, ann_nlist=4, ann_nprobe=9), "cannot exceed"),
    (dict(ann=True, ann_nlist=-1), "knn.ann.nlist"),
    (dict(ann=True, ann_nprobe=-2), "knn.ann.nprobe"),
    (dict(ann=True, ann_iters=-1), "knn.ann.iters"),
    (dict(ann_nlist=8), "knn.ann=false"),
    (dict(ann_nprobe=4), "knn.ann=false"),
    (dict(ann=True, quantized_dtype="fp4"), "knn.quantized.dtype"),
    (dict(quantized=True, quantized_dtype="int4"), "knn.quantized.dtype"),
    (dict(ann=True, quantized_oversample=0), "knn.quantized.oversample"),
    (dict(quantized=True, quantized_oversample=-3),
     "knn.quantized.oversample"),
    (dict(mode="fastest"), "knn.mode"),
    (dict(algorithm="cosine"), "distAlgorithm"),
    (dict(top_match_count=0), "top.match.count"),
]

VALID_CONFIGS = [
    dict(), dict(mode="exact"), dict(ann=True),
    dict(ann=True, ann_nlist=16, ann_nprobe=16), dict(ann=True, fused=True),
    dict(quantized=True), dict(quantized=True, quantized_dtype="bf16"),
]


@pytest.mark.parametrize("kw,match", INVALID_CONFIGS,
                         ids=[str(sorted(kw.items()))
                              for kw, _ in INVALID_CONFIGS])
def test_invalid_config_matrix(kw, match):
    """The port refuses what JAX refuses, with JAX's message."""
    with pytest.raises(ValueError, match=match):
        tknn.validate_config(tknn.KnnConfig(**kw))
    with pytest.raises(ValueError, match=match):
        jknn.validate_config(jknn.KnnConfig(**kw))


@pytest.mark.parametrize("kw", VALID_CONFIGS,
                         ids=[str(sorted(kw.items())) for kw in VALID_CONFIGS])
def test_valid_config_matrix(kw):
    tknn.validate_config(tknn.KnnConfig(**kw))


def test_neighbors_validates_before_touching_tables():
    with pytest.raises(ValueError, match="conflict"):
        tknn.neighbors(None, None, tknn.KnnConfig(ann=True, quantized=True))
