"""The port's full distance matrix, neighbor-record replay and KNN
regression against the JAX package's: ``pairwise_full`` (euclidean and
manhattan on numeric, categorical and mixed schemas), ``block_distance``,
``classify_from_neighbors`` (its bounded heaps and tie order) and
``regress`` in its four methods, with the ``knn.ann`` refusal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from avenir_tpu.datagen import generators as JG
from avenir_tpu.models import knn as JK
from avenir_tpu.ops import distance as JD

from avenir_tpu_torch.models import knn as TK
from avenir_tpu_torch.ops import distance as TD

from _torch_parity import featurizers, fixture, tables

torch.set_num_threads(2)

#: an int cell of pairwise_full may differ from the JAX package's only
#: where the port's scaled distance lies this close to a rounding boundary
#: (XLA's CPU dot picks its summation order by shape)
BOUNDARY = 1e-4


def _split(table, jax_side):
    """(numeric, categorical, bins) of a table of either package, as
    numpy."""
    if jax_side:
        num, cat, bins = JK._split_features(table)
    else:
        num, cat, bins = TK._split_features(table)
    return (None if num is None else np.asarray(num),
            None if cat is None else np.asarray(cat), bins)


def _hosp_tables(n_train, n_test, seed=13):
    rows = JG.hosp_readmit_rows(n_train + n_test, seed=seed)
    jfz, tfz = featurizers(JG._HOSP_SCHEMA_JSON, rows[:n_train])
    return (jfz.transform(rows[n_train:]), jfz.transform(rows[:n_train]),
            tfz.transform(rows[n_train:]), tfz.transform(rows[:n_train]))


_OPERANDS: dict = {}


def _operands(name):
    """(jax (x_num, y_num, x_cat, y_cat, bins), the port's) of a fixture,
    built once."""
    if name not in _OPERANDS:
        if name == "hosp":
            jx, jy, tx, ty = _hosp_tables(700, 150)
        else:
            jy, jx, ty, tx = tables(name, 700, 150, seed=17)
        out = []
        for x, y, jax_side in ((jx, jy, True), (tx, ty, False)):
            xn, xc, bins = _split(x, jax_side)
            yn, yc, _ = _split(y, jax_side)
            out.append((xn, yn, xc, yc, bins))
        _OPERANDS[name] = tuple(out)
    return _OPERANDS[name]


# elearn is all numeric, churn all categorical, hospital mixed
_PARTS = [("elearn", "all"), ("churn", "all"), ("hosp", "all"),
          ("hosp", "numeric"), ("hosp", "categorical")]


def _torch(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("algorithm", ["euclidean", "manhattan"])
@pytest.mark.parametrize("name,part", _PARTS)
def test_pairwise_full_equals_jax(name, part, algorithm):
    """The scaled ints equal the jitted JAX matrix. XLA's CPU dot picks
    its summation order by shape, so a cell may differ; it must then lie
    within BOUNDARY of a rounding boundary and differ by 1, and such cells
    are counted and bounded (none on these fixtures when written)."""
    (xn, yn, xc, yc, bins), (txn, tyn, txc, tyc, tbins) = _operands(name)
    assert bins == tbins
    if part == "numeric":
        xc = yc = txc = tyc = None
    elif part == "categorical":
        xn = yn = txn = tyn = None
    want = np.asarray(JD.pairwise_full(
        None if xn is None else jnp.asarray(xn),
        None if yn is None else jnp.asarray(yn),
        None if xc is None else jnp.asarray(xc),
        None if yc is None else jnp.asarray(yc),
        algorithm=algorithm, n_cat_bins=bins, distance_scale=1000))
    args = [_torch(a) for a in (txn, tyn, txc, tyc)]
    got = TD.pairwise_full(*args, algorithm=algorithm, n_cat_bins=tbins,
                           distance_scale=1000).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    off = got != want
    n_off = int(off.sum())
    if n_off:
        d = TD.block_distance(*args, tbins, algorithm).numpy()
        scaled = d.astype(np.float64) * 1000
        frac = np.abs(scaled - np.floor(scaled) - 0.5)
        assert np.all(frac[off] <= BOUNDARY), frac[off].max()
        assert np.all(np.abs(got[off].astype(np.int64) - want[off]) == 1)
    assert n_off <= 1e-4 * off.size, f"{n_off} cells at a boundary"


@pytest.mark.parametrize("name,part", _PARTS[:3])
def test_block_distance_and_blocks_agree(name, part, monkeypatch):
    """``block_distance`` within a few ulps of JAX's (eager there, so it
    rounds apart from the compiled matrix), and the matrix computed in
    many row blocks equal to one block."""
    (xn, yn, xc, yc, bins), (txn, tyn, txc, tyc, _) = _operands(name)
    args = [_torch(a) for a in (txn, tyn, txc, tyc)]
    want = np.asarray(JD.block_distance(
        *(None if a is None else jnp.asarray(a) for a in (xn, yn, xc, yc)),
        bins))
    got = TD.block_distance(*args, bins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    whole = TD.pairwise_full(*args, n_cat_bins=bins)
    monkeypatch.setattr(TD, "_FULL_BLOCK_CELLS", 4096)
    assert torch.equal(TD.pairwise_full(*args, n_cat_bins=bins), whole)


# -- classify_from_neighbors ---------------------------------------------

def _records(n_test, n_train, k_ties, seed, post=False):
    """Records of ``n_test`` test ids in shuffled order, ranks drawn from
    few values so that ties sit at the k-th place; ``post`` adds
    class-conditional probabilities (some zero)."""
    rng = np.random.default_rng(seed)
    recs = []
    for t in range(n_test):
        for j in range(n_train):
            rec = {"test_id": f"t{t}",
                   "rank": str(int(rng.integers(0, k_ties)) * 10),
                   "train_class": ["pass", "fail", "maybe"][
                       int(rng.integers(0, 3))],
                   "test_class": ["pass", "fail"][t % 2]}
            if post:
                rec["post"] = ("0" if rng.random() < 0.2
                               else f"{rng.random():.6f}")
            recs.append(rec)
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


@pytest.mark.parametrize("kernel,inverse,cond,k", [
    ("none", False, False, 5), ("linearMultiplicative", False, False, 3),
    ("linearAdditive", True, False, 7), ("gaussian", False, True, 5),
    ("none", True, True, 1), ("gaussian", True, True, 40)])
def test_classify_from_neighbors_equals_jax(kernel, inverse, cond, k):
    """Every vote, probability, label, distance and the test-id order
    equal; the heap keeps ``sorted(...)[:k]``'s tie order (ranks from
    four values, so ties fall at the cut; k = 40 exceeds the 30 records
    a test id, so slots stay empty)."""
    recs = _records(25, 30, 4, seed=k, post=cond)
    classes = ["fail", "maybe", "pass"]
    kw = dict(top_match_count=k, kernel_function=kernel, kernel_param=20,
              class_cond_weighted=cond, inverse_distance_weighted=inverse)
    jp, jids, jcls = JK.classify_from_neighbors(
        iter(recs), JK.KnnConfig(**kw), classes)
    tp, tids, tcls = TK.classify_from_neighbors(
        iter(recs), TK.KnnConfig(**kw), classes, device="cpu")
    assert tids == jids and tcls == jcls
    for name in ("predicted", "class_votes", "class_prob", "neighbor_idx",
                 "neighbor_dist"):
        np.testing.assert_array_equal(getattr(tp, name),
                                      np.asarray(getattr(jp, name)))


def test_classify_from_neighbors_decision_threshold():
    recs = _records(20, 12, 3, seed=2)
    for r in recs:
        r["train_class"] = "pass" if r["train_class"] == "maybe" \
            else r["train_class"]
    kw = dict(top_match_count=5, decision_threshold=1.5,
              positive_class="fail")
    jp, _, _ = JK.classify_from_neighbors(iter(recs), JK.KnnConfig(**kw),
                                          ["fail", "pass"])
    tp, _, _ = TK.classify_from_neighbors(iter(recs), TK.KnnConfig(**kw),
                                          ["fail", "pass"], device="cpu")
    np.testing.assert_array_equal(tp.predicted, np.asarray(jp.predicted))
    np.testing.assert_array_equal(tp.class_prob, np.asarray(jp.class_prob))


# -- regress ----------------------------------------------------------------

def _regression_tables(n_train, n_test, seed=91):
    """elearn tables whose target is a planted linear score of the
    features (the class column is not read)."""
    jtr, jte, ttr, tte = tables("elearn", n_train, n_test, seed=seed,
                                test_labels=False)
    _, rows = fixture("elearn", n_train + n_test, seed)
    rng = np.random.default_rng(seed)
    feats = np.asarray([[float(v) for v in r[1:10]] for r in rows])
    target = (feats @ rng.uniform(-1, 1, 9) + rng.normal(0, 3, len(rows))
              ).astype(np.float32)
    return (jtr, jte, ttr, tte, feats.astype(np.float32), target,
            n_train)


@pytest.fixture(scope="module")
def regression_tables():
    return _regression_tables(900, 240)


def _regr_inputs(method, feats, n_train):
    if method == "linearRegression":
        return feats[:n_train, 0], feats[n_train:, 0]
    if method == "multiLinearRegression":
        return feats[:n_train], feats[n_train:]
    return None


@pytest.mark.parametrize("method", ["average", "median", "linearRegression",
                                    "multiLinearRegression"])
@pytest.mark.parametrize("k,extra", [
    (5, {"mode": "exact"}), (6, {"mode": "exact"}),
    (5, {"mode": "exact", "feed_chunk_rows": 64}), (5, {"quantized": True}),
    (4, {"mode": "exact", "feed_chunk_rows": 100})])
def test_regress_equals_jax(regression_tables, method, k, extra):
    """``average`` and ``median`` equal. linearRegression: the values
    before the int cast within rtol 1e-4 of a float64 fit of the same
    neighborhoods, the ints equal to the JAX package's except where the
    value lies within rtol 1e-4 of an integer (counted, at most 2%).
    multiLinearRegression: the JAX package solves its ridge system in f32,
    which strays from the float64 solve by up to a few 1e-2 (ROADMAP C8);
    the port solves in float64 and departs from the reference there: its
    values are held to that solve at rtol 1e-6, the JAX ints to within
    their own error of it, and the differing ints are counted (13-15 of
    240 on this fixture, held at most 7%; 228 of 20,000 at chip_smoke
    phase 11's shape). ``knn.mode=exact`` on both sides: the JAX package's
    fast mode is approximate. ``prediction.mode`` is set on the JAX config
    only: the port's ``regress`` is the mode."""
    jtr, jte, ttr, tte, feats, target, n_train = regression_tables
    kw = dict(top_match_count=k, regression_method=method, **extra)
    ri = _regr_inputs(method, feats, n_train)
    jp = JK.regress(jtr, jte, JK.KnnConfig(prediction_mode="regression",
                                           **kw),
                    jnp.asarray(target[:n_train]),
                    regr_input=None if ri is None else tuple(
                        jnp.asarray(a) for a in ri))
    tp = TK.regress(ttr, tte, TK.KnnConfig(**kw),
                    torch.from_numpy(target[:n_train].copy()),
                    regr_input=None if ri is None else tuple(
                        torch.from_numpy(a.copy()) for a in ri))
    np.testing.assert_array_equal(tp.neighbor_idx,
                                  np.asarray(jp.neighbor_idx))
    # the scaled distances of the two exact modes round within 1
    assert np.abs(tp.neighbor_dist.astype(np.int64)
                  - np.asarray(jp.neighbor_dist)).max() <= 1
    want = np.asarray(jp.predicted)
    assert tp.predicted.dtype == np.int32
    if method in ("average", "median"):
        np.testing.assert_array_equal(tp.predicted, want)
        return
    ref = _f64_regression(method, tp.neighbor_idx, target[:n_train], ri)
    value = tp.regressed.astype(np.float64)
    off = tp.predicted != want
    if method == "linearRegression":
        np.testing.assert_allclose(value, ref, rtol=1e-4, atol=1e-3)
        near = np.abs(value - np.round(value)) <= 1e-4 * np.maximum(
            np.abs(value), 1.0)
        assert np.all(near[off]), value[off]
        assert off.sum() <= max(2, 0.02 * len(off)), off.sum()
    else:
        # the port's float64 solve is the ridge solution's to ~1e-7; the
        # JAX package's f32 one is off by up to ~1e-2 relative, and its
        # ints follow its own error
        np.testing.assert_allclose(value, ref, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(tp.predicted,
                                      value.astype(np.int32))
        band = 1.0 + 1e-2 * np.abs(ref)
        assert np.all(np.abs(want - ref) <= band)
        assert off.sum() <= 0.07 * len(off), off.sum()
    assert np.all(np.abs(tp.predicted[off].astype(np.int64) - want[off])
                  <= 1 + np.abs(ref[off]) * 1e-2)


def _f64_regression(method, idx, targets, ri):
    """The linear modes in float64 on the port's neighborhoods."""
    y = targets.astype(np.float64)[idx]
    if method == "linearRegression":
        x = ri[0].astype(np.float64)[idx]
        mx, my = x.mean(1, keepdims=True), y.mean(1, keepdims=True)
        sxx = ((x - mx) ** 2).sum(1)
        slope = ((x - mx) * (y - my)).sum(1) / np.where(sxx > 0, sxx, 1.0)
        return my[:, 0] - slope * mx[:, 0] + slope * ri[1].astype(
            np.float64)
    x = ri[0].astype(np.float64)[idx]
    a = np.concatenate([x, np.ones(x.shape[:2] + (1,))], axis=2)
    ata = np.einsum("mkf,mkg->mfg", a, a)
    aty = np.einsum("mkf,mk->mf", a, y)
    f1 = a.shape[2]
    lam = 1e-5 * np.einsum("mff->m", ata)[:, None, None] / f1 + 1e-6
    w = np.linalg.solve(ata + lam * np.eye(f1), aty[..., None])[..., 0]
    test = np.concatenate([ri[1].astype(np.float64),
                           np.ones((ri[1].shape[0], 1))], axis=1)
    return (test * w).sum(1)


def test_regress_ann_refusal_matches_jax():
    """A sparse probe that leaves a query short of k neighbors is refused
    with the JAX package's message; a full probe regresses as
    ``knn.quantized`` does."""
    jtr, jte, ttr, tte, _, target, n_train = _regression_tables(64, 12, 69)
    kw = dict(ann=True, ann_nlist=32, ann_nprobe=1, top_match_count=8)
    with pytest.raises(ValueError, match="fewer than top.match.count") as j:
        JK.regress(jtr, jte, JK.KnnConfig(prediction_mode="regression",
                                          **kw),
                   jnp.asarray(target[:n_train]))
    with pytest.raises(ValueError, match="fewer than top.match.count") as t:
        TK.regress(ttr, tte, TK.KnnConfig(**kw),
                   torch.from_numpy(target[:n_train].copy()))
    assert str(t.value) == str(j.value)
    full = dict(kw, ann_nprobe=32)
    jp = JK.regress(jtr, jte, JK.KnnConfig(prediction_mode="regression",
                                           **full),
                    jnp.asarray(target[:n_train]))
    tp = TK.regress(ttr, tte, TK.KnnConfig(**full),
                    torch.from_numpy(target[:n_train].copy()))
    np.testing.assert_array_equal(tp.predicted, np.asarray(jp.predicted))


def test_regress_unknown_method_and_missing_input(regression_tables):
    _, _, ttr, tte, _, target, n_train = regression_tables
    t = torch.from_numpy(target[:n_train].copy())
    for method, msg in (("mode", "unknown regression method"),
                        ("linearRegression", "needs regr_input"),
                        ("multiLinearRegression", "needs regr_input")):
        with pytest.raises(ValueError, match=msg):
            TK.regress(ttr, tte, TK.KnnConfig(regression_method=method), t)
