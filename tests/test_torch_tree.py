"""The port's decision-tree library against the JAX package's: the split
statistics, a tree level's K1 histogram, the candidate splits, the trees
(host loop and device growth), the batched levels and prediction, on the
same retarget rows.

Tolerances. The port's statistics round each f32 operation as eager JAX
does and equal ``avenir_tpu.ops.infotheory``'s eager functions exactly,
but for Hellinger, whose square roots XLA's CPU backend approximates
(within ``STAT_RTOL``). The JAX package computes candidate statistics in
compiled kernels, where XLA fuses products into the adds that consume
them and sums short axes as vector trees: there the port's statistics
agree within ``STAT_RTOL`` relative or ``STAT_ATOL`` absolute (a few f32
ulps of 1; the absolute term covers stats that cancel to near zero).
Counts, candidate keys and order, and trees are held exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu.datagen import generators as JG
from avenir_tpu.models import tree as JT
from avenir_tpu.ops import histogram as jh
from avenir_tpu.ops import infotheory as ji

from avenir_tpu_torch import interop
from avenir_tpu_torch.models import tree as TT
from avenir_tpu_torch.ops import cuda_histogram
from avenir_tpu_torch.ops import histogram as th
from avenir_tpu_torch.ops import infotheory as ti
from avenir_tpu_torch.utils.schema import FeatureSchema as TSchema

from _torch_parity import featurizers

torch.set_num_threads(2)

STAT_RTOL, STAT_ATOL = 1e-6, 1e-6
ALGORITHMS = ("giniIndex", "entropy", "hellingerDistance",
              "classConfidenceRatio")


def _tables(n, seed):
    rows = JG.retarget_rows(n, seed=seed)
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON, rows)
    return jfz.transform(rows), tfz.transform(rows)


@pytest.fixture(scope="module")
def retarget():
    return _tables(400, seed=3)


def _counts(seed, shape):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 300, shape).astype(np.float32)
    c[rng.random(shape) < 0.3] = 0
    return c


# -- split statistics ---------------------------------------------------------

def test_xla_log_equals_jax_log():
    rng = np.random.default_rng(0)
    a = rng.integers(1, 20000, 50000)
    x = np.concatenate([
        (a / (a + rng.integers(0, 20000, 50000))).astype(np.float32),
        rng.random(20000).astype(np.float32) * 1000,
        np.float32([1.0, 2.0, 0.5, 1e-30, 1.2e-38, 3.4e38])])
    assert np.array_equal(ti.xla_log(torch.from_numpy(x)).numpy(),
                          np.asarray(jnp.log(x)))


@pytest.mark.parametrize("shape", [(2000, 4, 2), (2000, 3, 2), (500, 5, 3)])
@pytest.mark.parametrize("name", [
    "gini", "entropy", "intrinsic_info_content", "split_info_content:entropy",
    "split_info_content:giniIndex", "class_confidence_ratio",
    "hellinger_distance", "hellinger_distance:reference"])
def test_stats_equal_eager_jax(name, shape):
    c = _counts(len(name) * 7 + shape[1], shape)
    fn, _, arg = name.partition(":")
    if fn == "hellinger_distance":
        kw = {"reference_absent": arg == "reference"}
        want = np.asarray(ji.hellinger_distance(c, **kw))
        got = ti.hellinger_distance(torch.from_numpy(c), **kw).numpy()
        # XLA's CPU square root is approximate: not bit for bit
        np.testing.assert_allclose(got, want, rtol=STAT_RTOL, atol=0)
        return
    args = (arg,) if arg else ()
    want = np.asarray(getattr(ji, fn)(c, *args))
    got = getattr(ti, fn)(torch.from_numpy(c), *args).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("algorithm", ALGORITHMS
                         + ("hellingerDistance:reference",))
def test_split_stat_within_ulps_of_compiled_jax(algorithm):
    c = _counts(5, (5000, 4, 2))
    want = np.asarray(jax.jit(lambda x: ji.split_stat(x, algorithm))(c))
    got = ti.split_stat(torch.from_numpy(c), algorithm).numpy()
    np.testing.assert_allclose(got, want, rtol=STAT_RTOL, atol=STAT_ATOL)
    with pytest.raises(ValueError, match="unknown split algorithm"):
        ti.split_stat(torch.from_numpy(c), "variance")


# -- a tree level's histogram -------------------------------------------------

@pytest.mark.parametrize("n_nodes,n_bins,weighted,pallas", [
    (5, 10, False, "off"),
    (5, 10, True, "off"),
    (900, 10, True, "off"),      # 819 nodes a chunk: two chunks
    (3, 4, True, "interpret"),   # JAX through its Pallas kernel
])
def test_node_class_bin_counts_equal_jax(monkeypatch, n_nodes, n_bins,
                                         weighted, pallas):
    rng = np.random.default_rng(n_nodes + n_bins)
    n, n_a, c = 3000, 3, 2
    bins = rng.integers(-1, n_bins + 2, (n, n_a)).astype(np.int32)
    node = rng.integers(-1, n_nodes + 2, n).astype(np.int32)
    labels = rng.integers(0, c, n).astype(np.int32)
    w = (rng.integers(0, 4, n).astype(np.float32) if weighted else None)
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", pallas)
    want = np.asarray(jh.node_class_bin_counts(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(labels), n_nodes,
        n_bins, c, None if w is None else jnp.asarray(w)))
    got = th.node_class_bin_counts(
        torch.from_numpy(bins), torch.from_numpy(node),
        torch.from_numpy(labels), n_nodes, n_bins, c,
        None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == (n_a, n_nodes, n_bins, c)
    assert np.array_equal(got, want)


def test_node_chunks_are_k1_calls(monkeypatch):
    """One K1 call for each chunk of 8,192 // n_bins nodes."""
    calls = []
    plain = cuda_histogram.class_feature_bin_counts

    def counting(bins, labels, n_classes, n_bins, weights=None):
        calls.append(n_bins)
        return plain(bins, labels, n_classes, n_bins, weights)
    monkeypatch.setattr(cuda_histogram, "class_feature_bin_counts",
                        counting)
    ids = torch.zeros((10, 2), dtype=torch.int32)
    th.node_class_bin_counts(ids, ids[:, 0], ids[:, 0], 2048, 10, 2)
    assert calls == [8190, 8190, 4100]


# -- candidate splits ---------------------------------------------------------

def _assert_candidates(want, got, exact):
    assert ([(c.attr_ordinal, c.key) for c in got]
            == [(c.attr_ordinal, c.key) for c in want])
    for field in ("stat", "gain", "gain_ratio"):
        a = np.array([getattr(c, field) for c in want])
        b = np.array([getattr(c, field) for c in got])
        if exact:
            assert np.array_equal(a, b), field
        else:
            np.testing.assert_allclose(b, a, rtol=STAT_RTOL, atol=STAT_ATOL)


@pytest.mark.parametrize("algorithm", ALGORITHMS
                         + ("hellingerDistance:reference",))
def test_split_gains_and_root_info(retarget, algorithm):
    jt, tt = retarget
    attrs = JT.splittable_ordinals(jt)
    assert TT.splittable_ordinals(tt) == attrs
    assert TT.root_info(tt, algorithm) == JT.root_info(jt, algorithm)
    _assert_candidates(JT.split_gains(jt, attrs, algorithm),
                       TT.split_gains(tt, attrs, algorithm), exact=False)
    # a node's rows through a mask, and a given parent information
    mask = (np.arange(jt.n_rows) % 3 == 0).astype(np.float32)
    _assert_candidates(
        JT.split_gains(jt, [3, 1], algorithm, 0.4,
                       row_mask=jnp.asarray(mask)),
        TT.split_gains(tt, [3, 1], algorithm, 0.4,
                       row_mask=torch.from_numpy(mask)), exact=False)


@pytest.mark.parametrize("algorithm", ["giniIndex", "entropy"])
def test_split_gains_with_class_probs(retarget, algorithm):
    jt, tt = retarget
    jc, jp = JT.split_gains_with_class_probs(jt, [1, 2, 3], algorithm)
    tc, tp = TT.split_gains_with_class_probs(tt, [1, 2, 3], algorithm)
    _assert_candidates(jc, tc, exact=False)
    assert tp == jp                  # from integer counts: exact


def test_candidate_file_round_trip_and_selection(tmp_path, retarget):
    _, tt = retarget
    cands = TT.split_gains(tt, [1, 3])
    TT.write_candidate_splits(cands, str(tmp_path / "s.txt"))
    triples = TT.read_candidate_splits(str(tmp_path / "s.txt"))
    assert triples == [(c.attr_ordinal, c.key, c.gain_ratio) for c in cands]
    assert (TT.select_split(triples)
            == JT.select_split(triples))
    assert (TT.select_split(triples, "randomFromTop", 5,
                            np.random.default_rng(4))
            == JT.select_split(triples, "randomFromTop", 5,
                               np.random.default_rng(4)))
    with pytest.raises(ValueError, match="unknown split selection"):
        TT.select_split(triples, "worst")


# -- trees --------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_grow_tree_device_equals_jax(retarget, algorithm, depth):
    jt, tt = retarget
    kw = dict(algorithm=algorithm, max_depth=depth, min_node_size=5)
    want = JT.canonical_tree(JT.grow_tree_device(jt, JT.TreeConfig(**kw)))
    got = TT.canonical_tree(TT.grow_tree_device(tt, TT.TreeConfig(**kw)))
    assert got == want


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_grow_tree_host_equals_jax(retarget, algorithm):
    jt, tt = retarget
    kw = dict(algorithm=algorithm, max_depth=3, min_node_size=5)
    want = JT.grow_tree(jt, JT.TreeConfig(**kw))
    got = TT.grow_tree(tt, TT.TreeConfig(**kw))
    assert TT.canonical_tree(got) == JT.canonical_tree(want)
    assert got.to_dict() == want.to_dict()
    # the device growth grows the same tree
    assert TT.canonical_tree(
        TT.grow_tree_device(tt, TT.TreeConfig(**kw))) == \
        TT.canonical_tree(got)


def test_random_from_top_draws_like_jax(retarget):
    jt, tt = retarget
    kw = dict(max_depth=3, min_node_size=5,
              split_selection_strategy="randomFromTop", num_top_splits=4)
    want = JT.grow_tree(jt, JT.TreeConfig(**kw), np.random.default_rng(9))
    got = TT.grow_tree(tt, TT.TreeConfig(**kw), np.random.default_rng(9))
    assert TT.canonical_tree(got) == JT.canonical_tree(want)
    with pytest.raises(ValueError, match="supports the 'best' strategy"):
        TT.grow_tree_device(tt, TT.TreeConfig(**kw))


def test_row_weights_equal_jax():
    jt, tt = _tables(300, seed=8)
    w = np.random.default_rng(2).integers(0, 4, jt.n_rows).astype(np.float32)
    cfg = dict(max_depth=3, min_node_size=5)
    want = JT.grow_tree_device(jt, JT.TreeConfig(**cfg), jnp.asarray(w))
    got = TT.grow_tree_device(tt, TT.TreeConfig(**cfg), torch.from_numpy(w))
    assert TT.canonical_tree(got) == JT.canonical_tree(want)
    host = TT.grow_tree(tt, TT.TreeConfig(**cfg), row_weights=w)
    assert TT.canonical_tree(host) == TT.canonical_tree(got)


def test_frontier_budget_raises_as_jax(retarget):
    jt, tt = retarget
    kw = dict(max_depth=4, min_node_size=2, device_node_budget=2)
    with pytest.raises(ValueError) as want:
        JT.grow_tree_device(jt, JT.TreeConfig(**kw))
    with pytest.raises(ValueError) as got:
        TT.grow_tree_device(tt, TT.TreeConfig(**kw))
    assert str(got.value) == str(want.value)
    assert "use grow_tree" in str(got.value)


def test_leaf_root_without_splittable_attributes(retarget):
    jt, tt = retarget
    cfg = dict(max_depth=0)
    assert TT.grow_tree_device(tt, TT.TreeConfig(**cfg)).to_dict() == \
        JT.grow_tree_device(jt, JT.TreeConfig(**cfg)).to_dict()


def test_depth_eight_counts_thirteen_k1_calls(monkeypatch):
    """Level widths 1, 4, ..., 2,048 under the budget: the levels of 1,024
    and 2,048 nodes take 2, 3 and 3 chunks, 13 K1 calls a tree."""
    _, tt = _tables(300, seed=12)
    calls = []
    plain = cuda_histogram.class_feature_bin_counts

    def counting(*args, **kwargs):
        calls.append(args[3])
        return plain(*args, **kwargs)
    monkeypatch.setattr(cuda_histogram, "class_feature_bin_counts",
                        counting)
    TT.grow_tree_device(tt, TT.TreeConfig(max_depth=8, min_node_size=2))
    assert TT._level_widths(8, 4, 2048) == [1, 4, 16, 64, 256, 1024,
                                            2048, 2048]
    assert len(calls) == 13 and max(calls) == 8190


def test_device_growth_reads_back_once(monkeypatch, retarget):
    """The level loop never waits on the device: a tree's records come
    to the host in one copy, and nothing else reads a tensor back."""
    _, tt = retarget
    reads = []
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        method = getattr(torch.Tensor, name)

        def counting(self, *args, _name=name, _method=method, **kwargs):
            reads.append(_name)
            return _method(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counting)
    TT.grow_tree_device(tt, TT.TreeConfig(max_depth=4, min_node_size=5))
    assert reads == ["cpu", "numpy"]


@pytest.mark.parametrize("algorithm", ["giniIndex", "entropy"])
def test_grow_levels_batched_equals_jax(retarget, algorithm):
    jt, tt = retarget
    want, jkeys = JT.grow_levels_batched(jt, [1, 2, 3], algorithm, 3)
    got, tkeys = TT.grow_levels_batched(tt, [1, 2, 3], algorithm, 3)
    assert tkeys == jkeys and len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for key in ("best_t", "split", "child_counts", "child_slot",
                    "n_live"):
            assert np.array_equal(g[key], np.asarray(w[key])), key
        np.testing.assert_allclose(g["ratio"], np.asarray(w["ratio"]),
                                   rtol=STAT_RTOL, atol=STAT_ATOL)


# -- prediction ---------------------------------------------------------------

def test_predict_equals_jax():
    jt, tt = _tables(600, seed=21)
    tree = JT.grow_tree_device(jt, JT.TreeConfig(max_depth=4,
                                                 min_node_size=5))
    ttree = TT.TreeNode.from_dict(tree.to_dict(), tree.class_values)
    test_rows = JG.retarget_rows(500, seed=22)
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON,
                           JG.retarget_rows(600, seed=21))
    jtest, ttest = jfz.transform(test_rows), tfz.transform(test_rows)
    want = JT.predict(tree, jtest)
    assert np.array_equal(TT.predict(ttree, ttest), want)
    assert np.array_equal(TT.predict_device(ttree, ttest), want)
    assert np.array_equal(JT.predict_device(tree, jtest), want)


def test_encoded_table_from_numpy_grows_the_same_tree():
    """A JAX-encoded table crosses over as host arrays."""
    jt, _ = _tables(300, seed=30)
    tt = interop.encoded_table_from_numpy(
        np.asarray(jt.binned), np.asarray(jt.numeric),
        np.asarray(jt.labels), jt.ids,
        feature_fields=TSchema.from_json(
            JG._RETARGET_SCHEMA_JSON).get_feature_fields(),
        bins_per_feature=jt.bins_per_feature,
        is_continuous=jt.is_continuous, class_values=jt.class_values,
        bin_labels=jt.bin_labels, device="cpu")
    cfg = dict(max_depth=3, min_node_size=5)
    assert TT.canonical_tree(TT.grow_tree_device(tt, TT.TreeConfig(**cfg))) \
        == JT.canonical_tree(JT.grow_tree_device(jt, JT.TreeConfig(**cfg)))
