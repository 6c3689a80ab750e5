"""The port's gradient boosting against the JAX package's: the quanta
(XLA's exponential and sigmoid bit for bit), the integer channel
histogram and K1's integer mode, boosted trees with their leaf values,
the artifact, early stopping, streamed growth, margins and the errors, on
the JAX boosting test's retarget rows and on hospital rows.

Every tree comparison is exact (``canonical_tree(with_values=True)``):
the quanta are the same f32 integers, their sums are exact, and the
level selection computes its gain ratios in XLA's compiled order. Each
config boosts the JAX model once."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.models import boost as JB
from avenir_tpu.models import forest as JF
from avenir_tpu.models import tree as JT
from avenir_tpu.ops import histogram as jhg

from avenir_tpu_torch import interop
from avenir_tpu_torch.models import boost as TB
from avenir_tpu_torch.models import forest as TF
from avenir_tpu_torch.models import tree as TT
from avenir_tpu_torch.ops import cuda_histogram
from avenir_tpu_torch.ops import histogram as thg
from avenir_tpu_torch.ops import infotheory as it

from _torch_parity import featurizers, write_csv

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    """(jax train, torch train, jax test, torch test) of the JAX boosting
    test's split (retarget_rows(2400, seed=21)), and (jax, torch) of 1,200
    hospital rows."""
    rows = JG.retarget_rows(2400, seed=21)
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON, rows[:2000])
    hosp = JG.hosp_readmit_rows(1200, seed=31)
    hjfz, htfz = featurizers(JG._HOSP_SCHEMA_JSON, hosp)
    return {"retarget": (jfz.transform(rows[:2000]),
                         tfz.transform(rows[:2000]),
                         jfz.transform(rows[2000:]),
                         tfz.transform(rows[2000:])),
            "hosp": (hjfz.transform(hosp), htfz.transform(hosp))}


def _configs(**kw):
    tree = kw.pop("tree", {})
    return (JB.BoostConfig(tree=JT.TreeConfig(**tree), **kw),
            TB.BoostConfig(tree=TT.TreeConfig(**tree), **kw))


def _canon(model):
    return [TT.canonical_tree(t, with_values=True) for t in model.trees]


def _jcanon(model):
    return [JT.canonical_tree(t, with_values=True) for t in model.trees]


# (fixture, config keys)
CASES = {
    "retarget-gini": ("retarget", dict(n_rounds=8, tree=dict(max_depth=3))),
    "retarget-entropy": ("retarget", dict(
        n_rounds=8, tree=dict(max_depth=3, algorithm="entropy"))),
    "hosp-gini": ("hosp", dict(n_rounds=8, tree=dict(max_depth=3))),
    "hosp-entropy": ("hosp", dict(
        n_rounds=8, tree=dict(max_depth=3, algorithm="entropy"))),
    "hosp-deep-entropy": ("hosp", dict(
        n_rounds=6, learning_rate=0.9, tree=dict(max_depth=5,
                                                 algorithm="entropy"))),
}
_MODELS = {}


def _models(tables, name):
    """(JAX model, port model) of a case, each boosted once."""
    if name not in _MODELS:
        fixture, kw = CASES[name]
        jcfg, tcfg = _configs(**kw)
        _MODELS[name] = (JB.grow_boosted(tables[fixture][0], jcfg),
                         TB.grow_boosted(tables[fixture][1], tcfg))
    return _MODELS[name]


# -- XLA's exponential and the quanta ----------------------------------------

#: >= 1M dense scores in [-16, 16], with the range edges and the flush
#: region of the exponential
GRID = np.concatenate([
    np.linspace(-16.0, 16.0, (1 << 20) + 1, dtype=np.float32),
    np.linspace(-100.0, 100.0, 20001, dtype=np.float32)])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_xla_exp_bit_identical_to_jitted_jax():
    got = it.xla_exp(torch.from_numpy(GRID)).numpy()
    want = np.asarray(jax.jit(jnp.exp)(GRID))
    assert np.array_equal(_bits(got), _bits(want))


def test_xla_sigmoid_and_softplus_against_jitted_jax():
    got = it.xla_sigmoid(torch.from_numpy(GRID)).numpy()
    assert np.array_equal(_bits(got),
                          _bits(jax.jit(jax.nn.sigmoid)(GRID)))
    # softplus takes torch's log1p: within an ulp of XLA's
    soft = it.xla_softplus(torch.from_numpy(GRID)).numpy()
    np.testing.assert_allclose(soft, np.asarray(jax.jit(jax.nn.softplus)(
        GRID)), rtol=2e-7, atol=0)


@pytest.mark.parametrize("label", [0, 1])
def test_channels_bit_identical_to_jitted_jax(label):
    labels = np.full(GRID.shape, label, np.int32)
    want = np.asarray(jax.jit(JB._channels, static_argnums=2)(
        jnp.asarray(labels), jnp.asarray(GRID), 2))
    hq, gq = TB._channels(torch.from_numpy(labels), torch.from_numpy(GRID))
    onehot = np.eye(2, dtype=np.float32)[labels]
    got = np.concatenate([onehot * hq.numpy()[:, None],
                          gq.numpy()[:, None]], axis=1)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.abs(gq.numpy()).max() <= TB._Q


# -- the integer channel histogram and K1's integer mode ---------------------

@pytest.mark.parametrize("n,a,nodes,bins", [
    (2000, 3, 1, 10), (3000, 4, 5, 7), (1500, 2, 1200, 9)])
def test_node_channel_bin_sums_equal_jax(n, a, nodes, bins):
    """Against JAX's f32 channel contraction (exact here) on quanta as the
    rounds make them, with out-of-range bins and nodes dropping out; 1,200
    nodes of 9 bins take two chunks."""
    rng = np.random.default_rng(n + nodes)
    b = rng.integers(-1, bins + 1, size=(n, a)).astype(np.int32)
    node = rng.integers(-1, nodes + 1, size=n).astype(np.int32)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    score = rng.normal(size=n).astype(np.float32) * 3
    hq, gq = TB._channels(torch.from_numpy(labels), torch.from_numpy(score))
    chan = np.concatenate([np.eye(2, dtype=np.float32)[labels]
                           * hq.numpy()[:, None], gq.numpy()[:, None]], 1)
    want = np.asarray(jhg.node_channel_bin_sums(
        jnp.asarray(b), jnp.asarray(node), jnp.asarray(chan), nodes, bins))
    got = thg.node_channel_bin_sums(
        torch.from_numpy(b), torch.from_numpy(node),
        torch.from_numpy(labels), hq, gq, nodes, bins, 2, TB._Q)
    assert got.dtype == torch.int64 and got.shape == (a, nodes, bins, 3)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n,f,c,b,past_f32", [(5000, 3, 2, 11, True),
                                              (777, 1, 1, 4096, False)])
def test_plain_integer_k1_equals_int64_bincount(n, f, c, b, past_f32):
    """The integer mode's plain version against an int64 ``bincount`` of
    the weights (from -2^18 to 2^20), with sums past 2^24 where the cells
    hold enough rows, and ids and labels out of range dropping out."""
    rng = np.random.default_rng(n)
    bins = torch.from_numpy(rng.integers(-2, b + 2, size=(n, f))
                            .astype(np.int32))
    labels = torch.from_numpy(rng.integers(-1, c + 1, size=n)
                              .astype(np.int32))
    w = torch.from_numpy(rng.integers(-(1 << 18), 1 << 20, size=n)
                         .astype(np.float32))
    got = cuda_histogram.class_feature_bin_sums(bins, labels, c, b, w,
                                                1 << 20)
    want = np.zeros((c, f, b), np.int64)
    for j in range(f):
        col = bins[:, j].long()
        ok = (col >= 0) & (col < b) & (labels >= 0) & (labels < c)
        flat = labels.long()[ok] * b + col[ok]
        want[:, j] = torch.bincount(
            flat, weights=w.double()[ok], minlength=c * b
        ).to(torch.int64).reshape(c, b).numpy()
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (np.abs(want).max() > 2 ** 24) == past_f32


class _FakeLib:
    def __init__(self):
        self.calls = []

    def avt_cfb_sums_int(self, *args):
        self.calls.append(args)
        return 0


def test_integer_k1_splits_rows_below_the_int32_limit(monkeypatch):
    """The launches on the host side, the library faked: each takes fewer
    than 2^31 / max|w| rows at its rows' storage, together every row, and
    each counts one launch."""
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_histogram.class_feature_bin_sums, "launches", 0)
    assert cuda_histogram.rows_per_launch(TB._Q) == (2 ** 31 - 1) // 1024
    assert cuda_histogram.rows_per_launch(0.0) == 2 ** 31 - 1
    with pytest.raises(ValueError, match="does not fit an int32 sum"):
        cuda_histogram.rows_per_launch(2.0 ** 31)
    n, f = 10, 3
    bins = torch.zeros((n, f), dtype=torch.int32)
    labels = torch.zeros(n, dtype=torch.int32)
    w = torch.ones(n)
    out = cuda_histogram._int_sum_launches(bins, labels, w, 2, 5, rows=4)
    assert out.dtype == torch.int64 and out.shape == (f, 10)
    assert [args[3] for args in lib.calls] == [4, 4, 2]
    assert [args[0] - bins.data_ptr() for args in lib.calls] == \
        [0, 4 * f * 4, 8 * f * 4]
    assert [args[2] - w.data_ptr() for args in lib.calls] == [0, 16, 32]
    assert cuda_histogram.class_feature_bin_sums.launches == 3


def test_counts_from_hist_sums_int64_in_int64(tables):
    """Segment sums of an int64 histogram stay int64 and exact past 2^24
    and 2^31 (where f32 would round)."""
    _, tt, *_ = tables["retarget"]
    cand = TT._device_candidates(tt, TT._attr_plans(
        tt, TT.splittable_ordinals(tt), 3))
    a = len({k[0] for k in cand.keys})
    hist = torch.full((a, 2, cand.b_max, 3), (1 << 31) + 1,
                      dtype=torch.int64)
    cc = TT._counts_from_hist(hist, cand)
    assert cc.dtype == torch.int64
    seg_bins = [(cand.seg_of_bin[t] == s).sum().item()
                for t in range(len(cand.keys)) for s in range(cand.s_max)]
    assert sorted(set(cc[:, :, 0, 0].reshape(-1).tolist())) == sorted(
        {((1 << 31) + 1) * k for k in seg_bins})


# -- boosted trees, artifacts, early stopping, streaming ---------------------

@pytest.mark.parametrize("name", list(CASES))
def test_boosted_trees_equal_jax(tables, name):
    want, got = _models(tables, name)
    assert _canon(got) == _jcanon(want)
    assert len(got.trees) == CASES[name][1]["n_rounds"]


@pytest.mark.parametrize("name", ["retarget-gini", "hosp-entropy"])
def test_artifacts_byte_identical(tables, name, tmp_path):
    want, got = _models(tables, name)
    JB.save_boosted(want, str(tmp_path / "j.json"))
    TB.save_boosted(got, str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    back = TB.load_boosted(str(tmp_path / "j.json"))
    assert _canon(back) == _canon(got)
    assert [JT.canonical_tree(t, with_values=True) for t in
            JB.load_boosted(str(tmp_path / "t.json")).trees] == _canon(got)


def test_one_round_anchor(tables):
    """One round at learning rate 1 from base 0 is the port's own tree
    grown with constant row weights 0.25 (p(1-p) at p = 0.5), on the
    device growth and on the host loop."""
    _, tt, *_ = tables["retarget"]
    _, cfg = _configs(n_rounds=1, learning_rate=1.0,
                      tree=dict(max_depth=3))
    tree = TB.grow_boosted(tt, cfg).trees[0]
    device = TT.grow_tree_device(tt, cfg.tree,
                                 row_weights=torch.full((tt.n_rows,), 0.25))
    host = TT.grow_tree(tt, cfg.tree,
                        row_weights=np.full(tt.n_rows, 0.25, np.float32))
    assert TT.canonical_tree(tree) == TT.canonical_tree(device) == \
        TT.canonical_tree(host)
    assert tree.leaf_value is not None and device.leaf_value is None


def test_early_stopping_equals_jax(tables):
    """The overfitting recipe stops where JAX stops, on a prefix of the
    full run; the holdout loss of the same margins within 1e-6."""
    jt, tt, *_ = tables["retarget"]
    kw = dict(n_rounds=30, learning_rate=0.9, early_stop_rounds=2,
              tree=dict(max_depth=5))
    jcfg, tcfg = _configs(**kw)
    want = JB.grow_boosted(jt, jcfg)
    got = TB.grow_boosted(tt, tcfg)
    assert got.rounds_used == want.rounds_used == len(got.trees) < 30
    assert _canon(got) == _jcanon(want)
    # the same holdout with a patience that never runs out (trimmed to its
    # best round all the same): the stopped model is its prefix
    _, full_cfg = _configs(**{**kw, "early_stop_rounds": 10 ** 6})
    full = TB.grow_boosted(tt, full_cfg)
    assert full.rounds_used == len(full.trees) >= got.rounds_used
    assert _canon(full)[:got.rounds_used] == _canon(got)
    score = got.margins(tt)
    hmask = TB._holdout_split(tt.n_rows, 0.2)
    idx = np.nonzero(hmask)[0]
    y01 = (tt.labels.numpy()[idx] == 1).astype(np.float32)
    loss = TB._holdout_logloss(torch.from_numpy(score), torch.from_numpy(idx),
                               torch.from_numpy(y01))
    jloss = float(JB._holdout_logloss(jnp.asarray(score),
                                      jnp.asarray(idx.astype(np.int32)),
                                      jnp.asarray(y01)))
    assert abs(loss - jloss) <= 1e-6


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Three part files of the retarget train rows, the middle one empty,
    and both packages' fitted featurizers."""
    d = tmp_path_factory.mktemp("boost_parts")
    rows = JG.retarget_rows(2400, seed=21)[:2000]
    paths = [str(d / f"part-0000{i}") for i in range(3)]
    write_csv(paths[0], rows[:1300])
    open(paths[1], "w").close()
    write_csv(paths[2], rows[1300:])
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON, rows)
    return paths, jfz, tfz


def test_streamed_equals_in_core_and_jax(tables, parts):
    paths, jfz, tfz = parts
    jcfg, tcfg = _configs(n_rounds=4, tree=dict(max_depth=3,
                                                algorithm="entropy"))
    got = TB.grow_boosted_streaming(tfz, paths, tcfg)
    assert _canon(got) == _canon(TB.grow_boosted(tables["retarget"][1],
                                                 tcfg))
    assert _canon(got) == _jcanon(JB.grow_boosted_streaming(jfz, paths,
                                                            jcfg))


def test_streamed_errors(parts):
    paths, _, tfz = parts
    _, tcfg = _configs(n_rounds=2, early_stop_rounds=1)
    with pytest.raises(ValueError, match="not supported by the streaming"):
        TB.grow_boosted_streaming(tfz, paths, tcfg)
    _, tcfg = _configs(n_rounds=2)
    with pytest.raises(ValueError, match="no part files"):
        TB.grow_boosted_streaming(tfz, [], tcfg)
    with pytest.raises(ValueError, match="produced no rows"):
        TB.grow_boosted_streaming(tfz, [paths[1]], tcfg)


# -- margins, interop, artifacts' kinds ---------------------------------------

def test_margins_host_equal_jax_and_device_close(tables):
    want, got = _models(tables, "retarget-gini")
    jtest, ttest = tables["retarget"][2:]
    host = got.margins(ttest)
    assert host.dtype == np.float32
    assert np.array_equal(_bits(host), _bits(want.margins(jtest)))
    device = got.margins(ttest, device=True)
    np.testing.assert_allclose(device, host, rtol=0, atol=1e-5)
    assert np.array_equal(got.predict(ttest, device=True),
                          got.predict(ttest))
    assert np.array_equal(got.predict(ttest), want.predict(jtest))


def test_jax_trained_model_through_interop(tables, tmp_path):
    """A model the JAX package trained, carried over as its artifact's
    JSON object, scores as JAX scores it."""
    want, _ = _models(tables, "hosp-gini")
    JB.save_boosted(want, str(tmp_path / "j.json"))
    payload = json.loads((tmp_path / "j.json").read_text())
    model = interop.boosted_model_from_dict(payload, device="cpu")
    jt, tt = tables["hosp"]
    assert np.array_equal(_bits(model.margins(tt)),
                          _bits(want.margins(jt)))
    assert np.array_equal(model.predict(tt, device=True), want.predict(jt))
    with pytest.raises(ValueError, match="'bagged' model"):
        interop.boosted_model_from_dict({**payload, "kind": "bagged"},
                                        device="cpu")


def test_artifact_kinds_refused_both_ways(tables, tmp_path):
    _, got = _models(tables, "retarget-gini")
    TB.save_boosted(got, str(tmp_path / "boost.json"))
    with pytest.raises(ValueError, match="holds a 'boosted' model but was "
                       "loaded on the 'bagged' predict path"):
        TF.load_forest(str(tmp_path / "boost.json"))
    with pytest.raises(ValueError, match="holds a 'boosted' model but was "
                       "loaded on the 'bagged' predict path"):
        JF.load_forest(str(tmp_path / "boost.json"))
    _, tt, *_ = tables["retarget"]
    trees = TF.grow_forest(tt, TF.ForestConfig(
        n_trees=2, attrs_per_tree=2, tree=TT.TreeConfig(max_depth=2)))
    TF.save_forest(trees, str(tmp_path / "forest.json"))
    with pytest.raises(ValueError, match="holds a 'bagged' model but was "
                       "loaded on the 'boosted' predict path"):
        TB.load_boosted(str(tmp_path / "forest.json"))
    model = json.loads((tmp_path / "boost.json").read_text())
    (tmp_path / "v2.json").write_text(json.dumps({**model, "format": 2}))
    with pytest.raises(ValueError, match="unsupported ensemble artifact "
                       "format 2"):
        TB.load_boosted(str(tmp_path / "v2.json"))


def test_tree_node_value_round_trip():
    node = TT.TreeNode(class_counts=np.asarray([1.5, 2.25], np.float32),
                       class_values=["no", "yes"], leaf_value=-0.125)
    d = node.to_dict()
    assert d["value"] == -0.125
    back = TT.TreeNode.from_dict(json.loads(json.dumps(d)), ["no", "yes"])
    assert TT.canonical_tree(back, with_values=True) == \
        TT.canonical_tree(node, with_values=True)
    assert "value" not in TT.TreeNode(class_counts=np.ones(2),
                                      class_values=["a", "b"]).to_dict()
    assert TT.canonical_tree(node) == TT.canonical_tree(back)[:4]


# -- configuration errors ---------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(n_rounds=0), "n_rounds must be an int >= 1"),
    (dict(n_rounds=True), "n_rounds must be an int >= 1"),
    (dict(learning_rate=0.0), r"learning_rate must be a finite number in "
                              r"\(0, 1\]"),
    (dict(learning_rate=1.5), r"learning_rate must be"),
    (dict(learning_rate=float("nan")), r"learning_rate must be"),
    (dict(base_score=float("inf")), "base_score must be a finite number"),
    (dict(reg_lambda=-1.0), "reg_lambda must be a finite number >= 0"),
    (dict(early_stop_rounds=-1), r"forest\.boost\.early\.stop\.rounds must "
                                 r"be an int >= 0"),
    (dict(early_stop_rounds=2, holdout_fraction=0.75),
     r"forest\.boost\.early\.stop\.holdout must be a fraction in"),
    (dict(tree=dict(split_selection_strategy="randomFromTop")),
     "must be 'best' for boosting"),
    (dict(tree=dict(max_depth=0)), "tree.max_depth must be >= 1"),
])
def test_invalid_configs_raise_as_jax(tables, kwargs, match):
    jt, tt, *_ = tables["retarget"]
    jcfg, tcfg = _configs(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        TB.grow_boosted(tt, tcfg)
    with pytest.raises(ValueError) as want:
        JB.grow_boosted(jt, jcfg)
    assert str(got.value) == str(want.value)


def test_binary_only_and_holdout_needs_rows(tables):
    from avenir_tpu_torch.datagen import generators as TG
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.schema import FeatureSchema
    with pytest.raises(ValueError, match="binary classification"):
        TB._require_binary(3)
    schema = FeatureSchema.from_json(TG._RETARGET_SCHEMA_JSON)
    rows = TG.retarget_rows(1, seed=3)
    one = Featurizer(schema, device="cpu").fit(rows).transform(rows)
    _, tcfg = _configs(n_rounds=2, early_stop_rounds=1)
    with pytest.raises(ValueError, match="needs >= 2 training rows"):
        TB.grow_boosted(one, tcfg)
