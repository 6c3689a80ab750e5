"""The port's random forest against the JAX package's: batched, serial and
streamed growth, the vote, the artifact and the errors, on the JAX
forest test's retarget rows and on hospital rows.

Every comparison is exact: the counts are integers, the bootstrap draws
are the same numpy calls, and each tree is held by ``canonical_tree``.
The JAX package pins its batched, serial and auto forests equal
(``tests/test_forest.py``), so each config grows the JAX forest once and
the port's three growths are held against it.

The JAX package computes its level selection compiled, where XLA's fused
multiply-adds make the sum over segments depend on their order; two
candidates that split a node's rows into the same children in another
segment order then tie only up to rounding, and its argmax picks the one
that rounds higher. The port's ``_level_select`` computes the gain ratio
in the compiled order (bit for bit with two classes, held below), so it
picks the same candidate."""

import json

import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.models import forest as JF
from avenir_tpu.models import tree as JT

from avenir_tpu_torch.models import forest as TF
from avenir_tpu_torch.models import tree as TT
from avenir_tpu_torch.ops import cuda_histogram

from _torch_parity import featurizers, write_csv

torch.set_num_threads(2)


def _pair(schema_json, rows, test_rows=None):
    jfz, tfz = featurizers(schema_json, rows)
    out = (jfz.transform(rows), tfz.transform(rows))
    if test_rows is not None:
        out += (jfz.transform(test_rows), tfz.transform(test_rows))
    return out


@pytest.fixture(scope="module")
def tables():
    """The JAX forest test's split (retarget_rows(2400, seed=21)) and 1,200
    hospital rows."""
    rows = JG.retarget_rows(2400, seed=21)
    hosp = JG.hosp_readmit_rows(1200, seed=31)
    return {"retarget": _pair(JG._RETARGET_SCHEMA_JSON, rows[:2000],
                              rows[2000:]),
            "hosp": _pair(JG._HOSP_SCHEMA_JSON, hosp)}


def _canon(trees):
    return [TT.canonical_tree(t) for t in trees]


def _assert_forests_match(got, want):
    """Each port tree equal to the JAX tree, node by node."""
    assert _canon(got) == [JT.canonical_tree(t) for t in want]


def _configs(n_trees, attrs, bagging, seed, growth="auto", **tree):
    return (JF.ForestConfig(n_trees=n_trees, attrs_per_tree=attrs,
                            bagging=bagging, seed=seed, growth=growth,
                            tree=JT.TreeConfig(**tree)),
            TF.ForestConfig(n_trees=n_trees, attrs_per_tree=attrs,
                            bagging=bagging, seed=seed, growth=growth,
                            tree=TT.TreeConfig(**tree)))


# (fixture, n_trees, attrs per tree, bagging, seed, tree keys)
CASES = {
    "gini-3trees-bag": ("retarget", 3, 2, True, 4,
                        dict(max_depth=3)),
    "entropy-5trees": ("retarget", 5, 1, False, 1,
                       dict(max_depth=4, algorithm="entropy",
                            min_node_size=5)),
    "hellinger-1tree": ("retarget", 1, 3, True, 7,
                        dict(max_depth=2, algorithm="hellingerDistance")),
    "depth1-5trees": ("retarget", 5, 2, True, 3, dict(max_depth=1)),
    "hosp-gini": ("hosp", 5, 3, True, 2,
                  dict(max_depth=4, min_node_size=5)),
    "hosp-entropy": ("hosp", 3, 2, False, 5,
                     dict(max_depth=3, algorithm="entropy")),
}
_JAX_FORESTS = {}


def _jax_forest(tables, name):
    """The JAX package's forest of a case, grown once."""
    if name not in _JAX_FORESTS:
        fixture, *args, tree = CASES[name]
        jcfg, _ = _configs(*args, **tree)
        _JAX_FORESTS[name] = JF.grow_forest(tables[fixture][0], jcfg)
    return _JAX_FORESTS[name]


@pytest.mark.parametrize("growth", ["auto", "batched", "serial"])
@pytest.mark.parametrize("name", list(CASES))
def test_forest_equals_jax(tables, name, growth):
    fixture, *args, tree = CASES[name]
    _, tcfg = _configs(*args, growth=growth, **tree)
    want = _jax_forest(tables, name)
    got = TF.grow_forest(tables[fixture][1], tcfg)
    assert len(got) == len(want) == args[0]
    _assert_forests_match(got, want)


@pytest.mark.parametrize("algorithm", ["entropy", "giniIndex"])
@pytest.mark.parametrize("shape", [(33, 2, 4), (40, 3, 8), (16, 5, 2),
                                   (33, 2, 4, 3), (40, 3, 8, 4),
                                   (15, 4, 1, 3), (24, 4, 3, 4),
                                   (24, 8, 5, 3), (20, 6, 2, 4),
                                   (20, 16, 3), (20, 16, 3, 3),
                                   (20, 17, 2, 3), (20, 21, 4),
                                   (20, 24, 1, 4), (20, 24, 2, 4),
                                   (12, 32, 3), (12, 32, 5, 3),
                                   (6, 33, 2), (6, 40, 3, 3), (6, 48, 1, 4),
                                   (6, 64, 5), (6, 64, 2, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_level_select_ratios_equal_compiled_jax(algorithm, shape, weighted):
    """The gain ratios of every (candidate, node) equal the JAX package's
    compiled ``_level_select`` bit for bit, on integer counts and on
    hessian-weighted ones (multiples of 2^-10), with (T, S, K[, C])
    candidates, segments, nodes and classes (two unless given): (33, 2, 4)
    is the hospital catalog's shape, K = 1 a root level, and 4 or 8
    segments XLA's vectorized segment sum; from 16 segments on the sum
    runs in 8 or 4 lanes, with a scalar epilogue where the counts' loads
    interleave with gaps (K = 3 at C = 2, K = 2 at C = 4) and without
    (C = 3 at K = 3, K = 1, K = 5), and the 32-segment denominator in 8
    lanes; from 33 segments on XLA sums the products and the denominator
    in windows of 32."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    t, s, k, c = (shape + (2,))[:4]
    rng = np.random.default_rng(t * 100 + s * 10 + k + (c - 2) * 1000)
    if weighted:
        counts = (rng.integers(0, 12_800, size=(t, s, k, c))
                  / 1024.0).astype(np.float32)
    else:
        counts = rng.integers(0, 50, size=(t, s, k, c)).astype(np.float32)
    counts[rng.random(counts.shape) < 0.3] = 0
    want = np.asarray(jax.jit(partial(
        JT._level_select, k_nodes=k, s_max=s, n_classes=c,
        algorithm=algorithm, min_node_size=1, min_gain=-1.0,
        with_ratio=True))(jnp.asarray(counts))["ratio"])
    got = TT._level_select(torch.from_numpy(counts), algorithm=algorithm,
                           min_node_size=1, min_gain=-1.0,
                           with_ratio=True)["ratio"].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_random_from_top_grows_serially_as_jax(tables):
    jt, tt = tables["retarget"][:2]
    kw = dict(max_depth=3, min_node_size=5,
              split_selection_strategy="randomFromTop", num_top_splits=3)
    jcfg, tcfg = _configs(3, 2, True, 9, growth="batched", **kw)
    want = JF.grow_forest(jt, jcfg)
    assert _canon(TF.grow_forest(tt, tcfg)) == \
        [JT.canonical_tree(t) for t in want]
    with pytest.raises(ValueError, match="use growth='serial'"):
        TF.grow_forest_batched(tt, tcfg)


def test_node_budget_falls_back_to_the_host_loop(tables):
    """A budget of 2 overflows the batched frontier ('use grow_tree'): auto
    regrows serially, and each overflowing tree on the host loop."""
    jt, tt = tables["retarget"][:2]
    kw = dict(max_depth=4, min_node_size=2, device_node_budget=2)
    jcfg, tcfg = _configs(3, 3, True, 6, **kw)
    want = JF.grow_forest(jt, jcfg)
    assert _canon(TF.grow_forest(tt, tcfg)) == \
        [JT.canonical_tree(t) for t in want]
    with pytest.raises(ValueError) as got:
        TF.grow_forest(tt, TF.ForestConfig(
            n_trees=3, attrs_per_tree=3, seed=6, growth="batched",
            tree=TT.TreeConfig(**kw)))
    with pytest.raises(ValueError) as exp:
        JF.grow_forest_batched(jt, jcfg)
    assert str(got.value) == str(exp.value)
    assert "use grow_tree" in str(got.value)


def test_only_budget_and_out_of_memory_fall_back(tables, monkeypatch):
    _, tt = tables["retarget"][:2]
    _, tcfg = _configs(3, 2, True, 4, max_depth=3)
    serial = _canon(TF._grow_forest_serial(tt, tcfg))

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(TF, "grow_forest_batched", oom)
    assert _canon(TF.grow_forest(tt, tcfg)) == serial
    with pytest.raises(torch.cuda.OutOfMemoryError):
        TF.grow_forest(tt, TF.ForestConfig(
            n_trees=3, attrs_per_tree=2, seed=4, growth="batched",
            tree=tcfg.tree))

    def launch_failure(*args, **kwargs):
        raise RuntimeError("class_feature_bin_counts kernel launch failed")
    monkeypatch.setattr(TF, "grow_forest_batched", launch_failure)
    with pytest.raises(RuntimeError, match="kernel launch"):
        TF.grow_forest(tt, tcfg)


def test_a_level_is_one_selection_and_a_k1_call_per_tree(tables,
                                                         monkeypatch):
    """The tree axis rides the tensors: one selection and one routing a
    level whatever the number of trees, and K1 once for each tree and
    chunk of nodes (level widths 1, 4, 16: one chunk each)."""
    _, tt = tables["retarget"][:2]
    counted = {"select": 0, "route": 0, "k1": 0}
    for name, fn in (("select", TT._level_select),
                     ("route", TT._route_level_hist),
                     ("k1", cuda_histogram.class_feature_bin_counts)):
        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            counted[_name] += 1
            return _fn(*args, **kwargs)
        module = cuda_histogram if name == "k1" else TT
        attr = {"select": "_level_select", "route": "_route_level_hist",
                "k1": "class_feature_bin_counts"}[name]
        monkeypatch.setattr(module, attr, wrapped)
    for n_trees in (1, 5):
        for key in counted:
            counted[key] = 0
        _, tcfg = _configs(n_trees, 2, True, 4, growth="batched",
                           max_depth=3)
        TF.grow_forest_batched(tt, tcfg)
        assert counted == {"select": 3, "route": 3, "k1": 3 * n_trees}


def test_bootstrap_draws_equal_jax():
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    jcfg, tcfg = _configs(4, 2, True, 0)
    want = JF._draw_tree_plans(rng_j, [1, 2, 3], jcfg, 500)
    got = TF._draw_tree_plans(rng_t, [1, 2, 3], tcfg, 500)
    assert [a for a, _ in got] == [a for a, _ in want]
    for (_, w), (_, g) in zip(want, got):
        assert g.dtype == np.float32 and np.array_equal(g, w)


# -- streamed growth ----------------------------------------------------------

@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Three part files of the retarget train rows, the middle one empty,
    and both packages' fitted featurizers."""
    d = tmp_path_factory.mktemp("forest_parts")
    rows = JG.retarget_rows(2400, seed=21)[:2000]
    paths = [str(d / f"part-0000{i}") for i in range(3)]
    write_csv(paths[0], rows[:1200])
    open(paths[1], "w").close()
    write_csv(paths[2], rows[1200:])
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON, rows)
    return paths, jfz, tfz


@pytest.mark.parametrize("bagging", [False, True])
def test_streamed_growth_equals_jax(tables, parts, bagging):
    paths, jfz, tfz = parts
    jcfg, tcfg = _configs(3, 2, bagging, 8, max_depth=3, min_node_size=5)
    want = JF.grow_forest_streaming(jfz, paths, jcfg)
    got = TF.grow_forest_streaming(tfz, paths, tcfg)
    assert _canon(got) == [JT.canonical_tree(t) for t in want]
    if not bagging:
        # without bagging, streamed equals in-core batched growth
        assert _canon(got) == _canon(
            TF.grow_forest_batched(tables["retarget"][1], tcfg))


def test_streamed_growth_errors(parts, tmp_path):
    paths, _, tfz = parts
    _, tcfg = _configs(2, 2, True, 1, max_depth=2)
    empty = tmp_path / "part-00000"
    empty.write_text("")
    with pytest.raises(ValueError, match="produced no rows"):
        TF.grow_forest_streaming(tfz, [str(empty)], tcfg)
    with pytest.raises(ValueError, match="no part files"):
        TF.grow_forest_streaming(tfz, [], tcfg)
    _, rft = _configs(2, 2, True, 1, max_depth=2,
                      split_selection_strategy="randomFromTop")
    with pytest.raises(ValueError, match="'best' strategy only"):
        TF.grow_forest_streaming(tfz, paths, rft)
    _, flat = _configs(2, 2, True, 1, max_depth=0)
    with pytest.raises(ValueError, match="max_depth >= 1"):
        TF.grow_forest_streaming(tfz, paths, flat)


# -- prediction and the artifact ----------------------------------------------

@pytest.mark.parametrize("n_trees,depth", [(1, 3), (2, 1), (4, 2), (5, 3)])
def test_vote_equals_jax_host_and_device(tables, n_trees, depth):
    """Two and four trees tie on some rows; both packages take the first
    class of most votes."""
    jt, tt, jtest, ttest = tables["retarget"]
    jcfg, _ = _configs(n_trees, 1, True, 11, max_depth=depth)
    jtrees = JF.grow_forest(jt, jcfg)
    ttrees = [TT.TreeNode.from_dict(t.to_dict(), t.class_values)
              for t in jtrees]
    want = JF.predict_forest(jtrees, jtest)
    assert np.array_equal(JF.predict_forest(jtrees, jtest, device=True),
                          want)
    for device in (False, True):
        assert np.array_equal(
            TF.predict_forest(ttrees, ttest, device=device), want)


def test_vote_takes_the_first_class_on_ties(tables):
    _, _, _, ttest = tables["retarget"]
    leaf = {"attr": None, "splitKey": None, "children": {}}
    cv = ttest.class_values
    trees = [TT.TreeNode.from_dict({**leaf, "classCounts": c}, cv)
             for c in ([1.0, 5.0], [5.0, 1.0])]
    for device in (False, True):
        assert (TF.predict_forest(trees, ttest, device=device) == 0).all()


def test_artifact_bytes_and_cross_loading(tables, tmp_path):
    jt, tt = tables["hosp"]
    jtrees = _jax_forest(tables, "hosp-gini")
    _, tcfg = _configs(*CASES["hosp-gini"][1:-1], **CASES["hosp-gini"][-1])
    ttrees = TF.grow_forest(tt, tcfg)
    JF.save_forest(jtrees, str(tmp_path / "j.json"))
    TF.save_forest(ttrees, str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    assert _canon(TF.load_forest(str(tmp_path / "j.json"))) == _canon(ttrees)
    assert [JT.canonical_tree(t) for t in
            JF.load_forest(str(tmp_path / "t.json"))] == _canon(ttrees)


def test_loader_refuses_other_kinds_and_formats(tmp_path):
    path = str(tmp_path / "m.json")
    for model, match in (({"format": 1, "kind": "boosted"}, "'boosted'"),
                         ({"format": 2}, "format 2")):
        with open(path, "w") as fh:
            json.dump({**model, "classValues": ["a"], "trees": []}, fh)
        with pytest.raises(ValueError) as got:
            TF.load_forest(path)
        with pytest.raises(ValueError) as want:
            JF.load_forest(path)
        assert str(got.value) == str(want.value)
        assert match in str(got.value)


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_trees=0), "n_trees must be >= 1"),
    (dict(attrs_per_tree=0), "attrs_per_tree must be >= 1"),
    (dict(growth="eager"), "unknown forest growth mode 'eager'")])
def test_config_errors(tables, kwargs, match):
    _, tt = tables["retarget"][:2]
    with pytest.raises(ValueError, match=match):
        TF.grow_forest(tt, TF.ForestConfig(**kwargs))


def test_prediction_errors(tables):
    _, _, _, ttest = tables["retarget"]
    with pytest.raises(ValueError, match="empty forest"):
        TF.predict_forest([], ttest)
    leaf = {"classCounts": [1.0, 2.0], "attr": None, "splitKey": None,
            "children": {}}
    mixed = [TT.TreeNode.from_dict(leaf, ["yes", "no"]),
             TT.TreeNode.from_dict(leaf, ["no", "yes"])]
    with pytest.raises(ValueError, match="disagree on class_values"):
        TF.predict_forest(mixed, ttest)
    with pytest.raises(ValueError, match="empty forest"):
        TF.save_forest([], "unused.json")


def test_auto_grows_batched_without_the_serial_loop(tables, monkeypatch):
    _, tt = tables["retarget"][:2]
    _, tcfg = _configs(2, 2, True, 4, max_depth=2)

    def serial(*args, **kwargs):
        raise AssertionError("the serial loop ran")
    monkeypatch.setattr(TF, "_grow_forest_serial", serial)
    assert len(TF.grow_forest(tt, tcfg)) == 2
