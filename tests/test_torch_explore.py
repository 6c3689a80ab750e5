"""K4's plain version, the info-theory ops, mutual information, the
categorical correlations and their three CLI verbs against the JAX
package: its jnp and einsum paths and the Pallas kernel in interpret
mode."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG
from avenir_tpu.explore import correlation as jcorr
from avenir_tpu.explore import mutual_information as jmi
from avenir_tpu.ops import histogram as jh
from avenir_tpu.ops import infotheory as jinfo
from avenir_tpu.ops import pallas_histogram as jp
from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
from avenir_tpu.utils.schema import FeatureSchema as JSchema

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.datagen import generators as TG
from avenir_tpu_torch.explore import correlation as tcorr
from avenir_tpu_torch.explore import mutual_information as tmi
from avenir_tpu_torch.ops import cuda_histogram
from avenir_tpu_torch.ops import histogram as th
from avenir_tpu_torch.ops import infotheory as tinfo
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.dataset import Featurizer as TFeaturizer
from avenir_tpu_torch.utils.schema import FeatureSchema as TSchema

from _torch_parity import tables, write_csv, write_fixture

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("class_counts", "feature", "feature_class", "feature_pair",
            "feature_pair_class")
ALGORITHMS = ("mutualInfoMaximizer", "mutualInfoFeatureSelection",
              "jointMutualInfo", "doubleInputSymmetricalRelevance",
              "minRedundancyMaxRelevance")


def _props(path, **kv):
    with open(path, "w") as fh:
        for k, v in kv.items():
            fh.write(f"{k}={v}\n")
    return str(path)


def _hosp_schema(features=None):
    """The hospital-readmission schema, optionally with only the feature
    fields at ``features`` (ordinals) left as features."""
    schema = json.loads(json.dumps(JG._HOSP_SCHEMA_JSON))
    if features is not None:
        for field in schema["fields"]:
            if field.get("feature") and field["ordinal"] not in features:
                del field["feature"]
    return schema


def _hosp_tables(n, seed, features=None):
    """(jax table, torch CPU table) of the same hospital rows."""
    schema = _hosp_schema(features)
    rows = JG.hosp_readmit_rows(n, seed=seed)
    jt = JFeaturizer(JSchema.from_json(schema)).fit_transform(rows)
    tt = TFeaturizer(TSchema.from_json(schema), device="cpu").fit(rows) \
        .transform(rows)
    return jt, tt


# --------------------------------------------------------------------------
# K4: pair contingency counts
# --------------------------------------------------------------------------

PAIR_CASES = [
    # (n, n_a, n_b, out-of-range ids)
    (1000, 9, 18, True),        # ids -2..n+1 drop out
    (2100, 3, 2, False),        # ragged tail past one 2048-row block
    (1, 4, 3, False),
    (0, 9, 18, False),          # N = 0
    (777, 1, 5, True),
]


def _pair_ids(rng, n, n_a, n_b, bad):
    lo, hi = (-2, 2) if bad else (0, 0)
    a = rng.integers(lo, n_a + hi, size=n).astype(np.int32)
    b = rng.integers(lo, n_b + hi, size=n).astype(np.int32)
    return a, b


def _pair_weights(rng, n, kind):
    if kind == "01":
        return (rng.random(n) < 0.6).astype(np.float32)
    if kind == "float":
        return rng.random(n).astype(np.float32) * 3.0
    return None


@pytest.mark.parametrize("n,n_a,n_b,bad", PAIR_CASES)
@pytest.mark.parametrize("wkind", [None, "01"])
def test_pair_counts_exact_vs_jax(n, n_a, n_b, bad, wkind):
    rng = np.random.default_rng(n * 7 + n_a)
    a, b = _pair_ids(rng, n, n_a, n_b, bad)
    w = _pair_weights(rng, n, wkind)
    got = cuda_histogram.pair_counts_plain(
        torch.from_numpy(a), torch.from_numpy(b), n_a, n_b,
        None if w is None else torch.from_numpy(w)).numpy()
    jw = None if w is None else jnp.asarray(w)
    ref = np.asarray(jh._pair_counts_jnp(jnp.asarray(a), jnp.asarray(b),
                                         n_a, n_b, jw))
    pal = np.asarray(jp.pair_counts(jnp.asarray(a), jnp.asarray(b), n_a, n_b,
                                    jw, interpret=True))
    assert got.shape == (n_a, n_b) and got.dtype == np.float32
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pal)


@pytest.mark.parametrize("n,n_a,n_b,bad", PAIR_CASES[:3])
def test_pair_counts_float_weights(n, n_a, n_b, bad):
    rng = np.random.default_rng(3 + n)
    a, b = _pair_ids(rng, n, n_a, n_b, bad)
    w = _pair_weights(rng, n, "float")
    got = cuda_histogram.pair_counts_plain(
        torch.from_numpy(a), torch.from_numpy(b), n_a, n_b,
        torch.from_numpy(w)).numpy()
    for ref in (jh._pair_counts_jnp(jnp.asarray(a), jnp.asarray(b), n_a,
                                    n_b, jnp.asarray(w)),
                jp.pair_counts(jnp.asarray(a), jnp.asarray(b), n_a, n_b,
                               jnp.asarray(w), interpret=True)):
        # one f64 sum rounded to f32 against f32 sums in another order
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_pair_counts_wrapper_cpu_path_and_casts():
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 5, size=(300, 3))          # int64, [N, F]
    before = cuda_histogram.pair_counts.launches
    # a strided int64 column goes through the cast to contiguous int32
    got = th.pair_counts(torch.from_numpy(bins)[:, 1],
                         torch.from_numpy(bins)[:, 2], 5, 5)
    want = np.asarray(jh._pair_counts_jnp(jnp.asarray(bins[:, 1]),
                                          jnp.asarray(bins[:, 2]), 5, 5))
    assert np.array_equal(got.numpy(), want)
    assert cuda_histogram.pair_counts.launches == before


def test_pair_counts_refuses_other_devices_and_shapes():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_histogram.pair_counts(meta, meta, 2, 3)
    with pytest.raises(ValueError, match=r"must be \[N\]"):
        cuda_histogram.pair_counts(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(5, dtype=torch.int32), 2, 3)


# --------------------------------------------------------------------------
# info theory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (4, 6), (3, 5, 4, 2)])
def test_entropy_and_mi_vs_jax(shape):
    rng = np.random.default_rng(len(shape))
    counts = rng.integers(0, 20, size=shape).astype(np.float32)
    counts[rng.random(shape) < 0.3] = 0.0            # zeros mask to 0
    if len(shape) > 1:
        counts[0] = 0.0                               # an empty slice
    # f32 logs of two libraries: last-ulp differences
    np.testing.assert_allclose(
        tinfo.entropy(torch.from_numpy(counts)).numpy(),
        np.asarray(jinfo.entropy(jnp.asarray(counts))), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(
        tinfo.xlogx(torch.from_numpy(counts / 20)).numpy(),
        np.asarray(jinfo.xlogx(jnp.asarray(counts / 20))), rtol=1e-5,
        atol=1e-7)
    if len(shape) > 1:
        got = tinfo.mutual_information(torch.from_numpy(counts)).numpy()
        want = np.asarray(jinfo.mutual_information(jnp.asarray(counts)))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", [(10, 10, 9, 9), (10, 10, 81, 2),
                                   (4, 40, 3), (5, 5, 25, 2), (6, 4, 2),
                                   (3, 21, 3), (3, 16, 7), (3, 29, 4),
                                   (3, 24, 9)])
def test_mutual_information_sums_in_xla_order(shape):
    """A sum over two axes is one reduction in XLA: in row-major order, or
    with the outer axis in vector lanes, and in windows past 32 (C11).
    The hospital table's pair blocks are [9, 9] and [81, 2], the churn
    table's [5, 5] and [25, 2]."""
    rng = np.random.default_rng(sum(shape))
    counts = rng.integers(0, 300, size=shape).astype(np.float32)
    counts[rng.random(shape) < 0.3] = 0.0
    got = tinfo.mutual_information(torch.from_numpy(counts)).numpy()
    want = np.asarray(jinfo.mutual_information(jnp.asarray(counts)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    terms = rng.standard_normal(shape).astype(np.float32)
    for axes in ((-2, -1), -2, -1):
        assert np.array_equal(
            tinfo.xla_sum(torch.from_numpy(terms), axes).numpy(),
            np.asarray(jnp.sum(jnp.asarray(terms), axis=axes))), axes


def test_fma_rounds_once_as_xla():
    """``fma`` is a correctly rounded f32 FMA (C13): where the float64 sum
    sits on an f32 midpoint, its TwoSum error breaks the tie, as XLA's
    contracted ``a * b + c`` does; subnormals flush as XLA's do (C18)."""
    import jax

    f32 = np.float32
    a, c = f32(1 + 2 ** -12), f32(2.0 ** -80)
    assert float(tinfo.fma(torch.tensor(a), torch.tensor(a),
                           torch.tensor(c))) == float(f32(1.0004884))
    jfma = jax.jit(lambda x, y, z: x * y + z)
    assert f32(jfma(a, a, c)) == f32(1.0004884)
    rng = np.random.default_rng(13)
    n = 20_000
    # midpoints by construction: (1 + m 2^-12)^2 carries the bit 2^-24
    m = rng.integers(1, 2 ** 11, n) * 2 + 1
    x = (1 + m * 2.0 ** -12).astype(f32) * f32(2.0) ** rng.integers(
        -20, 20, n).astype(f32)
    tiny = (rng.choice([-1.0, 1.0], n) * 2.0 ** rng.integers(
        -120, -60, n)).astype(f32) * np.abs(x) * np.abs(x)
    xs = [x, rng.standard_normal(n).astype(f32)]
    ys = [x, rng.standard_normal(n).astype(f32) * f32(1e3)]
    zs = [tiny.astype(f32), (rng.standard_normal(n)
                             * 10.0 ** rng.integers(-30, 5, n)).astype(f32)]
    for xa, ya, za in zip(xs, ys, zs):
        got = tinfo.fma(torch.from_numpy(xa), torch.from_numpy(ya),
                        torch.from_numpy(za)).numpy()
        want = np.asarray(jfma(xa, ya, za))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # subnormal factors, addends and results read and come back as zero,
    # as XLA's CPU code runs: inf·1e-40 + 0 is NaN, the rest 0
    fa, fb, fc = (np.array(t, f32) for t in zip(
        (np.inf, 1e-40, 0.0), (1e-40, 2.0, 0.0), (1e-20, 1e-20, 0.0),
        (3e-39, 0.5, 1e-45), (-1e-20, 1e-20, 0.0)))
    want = np.asarray(jfma(fa, fb, fc))
    assert np.isnan(want[0]) and not want[1:].any()
    got = tinfo.fma(torch.from_numpy(fa), torch.from_numpy(fb),
                    torch.from_numpy(fc)).numpy()
    assert np.isnan(got[0])
    assert np.array_equal(got[1:].view(np.int32), want[1:].view(np.int32))
    # a factor given as a Python number is flushed the same way
    assert float(tinfo.fma(torch.tensor([2.0]), 1e-40, 0.0)) == 0.0
    assert math.isnan(float(tinfo.fma(torch.tensor([math.inf]), 1e-40, 0.0)))


# --------------------------------------------------------------------------
# mutual information
# --------------------------------------------------------------------------

def test_mi_distributions_equal_jax_einsum(monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", "off")   # the einsum path
    jt, tt = _hosp_tables(1500, seed=61)
    before = cuda_histogram.pair_counts.launches
    got = tmi.compute_distributions(tt)
    want = jmi.compute_distributions(jt)
    for family in FAMILIES:
        g, w = getattr(got, family), getattr(want, family)
        assert g.dtype == w.dtype == np.float32, family
        assert np.array_equal(g, w), family
    assert got.feature_ordinals == want.feature_ordinals
    assert got.class_values == tuple(want.class_values)
    assert cuda_histogram.pair_counts.launches == before   # CPU: plain


def test_mi_distributions_equal_jax_interpret_kernel(monkeypatch):
    """The JAX package's accelerator path, its Pallas pair kernel in
    interpret mode, on a 4-feature table."""
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", "interpret")
    assert jh.pallas_histograms_active()
    jt, tt = _hosp_tables(400, seed=5, features=(1, 4, 6, 8))
    assert tt.binned.shape[1] == 4
    got = tmi.compute_distributions(tt)
    want = jmi.compute_distributions(jt)
    for family in FAMILIES:
        assert np.array_equal(getattr(got, family), getattr(want, family))


def test_mi_label_outside_classes_drops_out(monkeypatch):
    """A row with label -1 drops out of every class family, as in the
    einsum path; the JAX combined id would alias it into the previous
    bin's last class."""
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", "off")
    _, tt = _hosp_tables(300, seed=9, features=(4, 6, 8))
    labels = tt.labels.clone()
    labels[::7] = -1
    table = EncodedTable(
        binned=tt.binned, numeric=tt.numeric, labels=labels, ids=tt.ids,
        feature_fields=tt.feature_fields,
        bins_per_feature=tt.bins_per_feature,
        is_continuous=tt.is_continuous, class_values=tt.class_values)
    got = tmi.compute_distributions(table)
    n_bins, n_classes = max(tt.bins_per_feature), len(tt.class_values)
    oh_bins = jnp.asarray(np.eye(n_bins, dtype=np.float32)[
        tt.binned.numpy()])
    oh_cls = jnp.asarray(np.eye(n_classes + 1, dtype=np.float32)[
        labels.numpy()][:, :n_classes])                # -1 -> all zeros
    cls, _, fc, _, fpc = map(np.asarray,
                             jmi._distribution_kernel(oh_bins, oh_cls))
    assert np.array_equal(got.class_counts, cls)
    assert np.array_equal(got.feature_class, fc)
    assert np.array_equal(got.feature_pair_class, fpc)
    kept = int((labels >= 0).sum())
    assert got.feature_pair_class[0, 0].sum() == kept < labels.shape[0]
    # the JAX combined id counts the dropped rows in another bin
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", "interpret")
    aliased = jmi._distributions_pallas(
        jnp.asarray(tt.binned.numpy()), jnp.asarray(labels.numpy()), n_bins,
        n_classes)[4]
    assert np.asarray(aliased)[0, 0].sum() > kept


def test_mi_refuses_mesh_and_mask():
    _, tt = _hosp_tables(50, seed=1)
    for kw in ({"mesh": object()}, {"mask": torch.ones(50)}):
        with pytest.raises(ValueError, match="multi-device layer"):
            tmi.compute_distributions(tt, **kw)


def _pinned_prefix(ranked, gap=1e-4):
    """The ordinals of a ranking up to its first near-tie: where two
    adjacent scores lie within ``gap``, f32 rounding may swap them, and a
    greedy selection goes on from either pick."""
    values = [v for _, v in ranked]
    cut = next((i for i in range(len(values) - 1)
                if abs(values[i] - values[i + 1]) <= gap), len(values))
    return [o for o, _ in ranked][:cut]


def test_mi_scores_and_selection_vs_jax(monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_PALLAS_HIST", "off")
    jt, tt = _hosp_tables(2500, seed=61)
    d = tmi.compute_distributions(tt)
    got = tmi.compute_scores(d, device="cpu")
    want = jmi.compute_scores(jmi.compute_distributions(jt))
    for name in ("feature_class_mi", "feature_pair_mi",
                 "feature_pair_class_mi", "feature_pair_class_entropy",
                 "class_cond_pair_mi"):
        g, w = getattr(got, name), getattr(want, name)
        assert list(g) == list(w), name
        # the logs are XLA's and every sum runs in XLA's order: bit for bit
        assert np.array_equal(np.float32(list(g.values())),
                              np.float32(list(w.values()))), name
    for algo in ALGORITHMS:
        g = tmi.SCORE_ALGORITHMS[algo](got, redundancy_factor=0.5)
        w = jmi.SCORE_ALGORITHMS[algo](want, redundancy_factor=0.5)
        pinned = _pinned_prefix(w)
        assert len(pinned) >= 5, algo     # the fixture pins most of it
        assert [o for o, _ in g][:len(pinned)] == pinned, algo
    assert set(tmi.SCORE_ALGORITHMS) == set(jmi.SCORE_ALGORITHMS)


# --------------------------------------------------------------------------
# categorical correlation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 2), (4, 5), (1, 3), (2, 2)])
def test_correlation_statistics_exact(shape):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    counts = rng.integers(0, 50, size=shape).astype(np.float32)
    for c in (counts, np.zeros(shape, np.float32)):
        for name, fn in tcorr.STAT_ALGORITHMS.items():
            assert fn(c) == jcorr.STAT_ALGORITHMS[name](c), name
    assert set(tcorr.STAT_ALGORITHMS) == set(jcorr.STAT_ALGORITHMS)


@pytest.mark.parametrize("algorithm", ["cramerIndex", "concentrationCoeff",
                                       "uncertaintyCoeff"])
def test_correlate_pairs_exact_with_the_class_either_side(algorithm):
    jt, _, tt, _ = tables("churn", 1200, 1, seed=71)
    pairs = [(3, 6), (6, 2), (1, 2), (4, 5)]
    got = tcorr.correlate_pairs(tt, pairs, algorithm, class_ordinal=6)
    want = jcorr.correlate_pairs(jt, pairs, algorithm, class_ordinal=6)
    assert got == want
    with pytest.raises(KeyError, match="ordinal 9"):
        tcorr.correlate_pairs(tt, [(1, 9)], algorithm, class_ordinal=6)


# --------------------------------------------------------------------------
# the CLI verbs
# --------------------------------------------------------------------------

def _mi_fixture(tmp_path, n=2500, seed=61):
    rows = TG.hosp_readmit_rows(n, seed=seed)
    write_csv(tmp_path / "hosp.csv", rows)
    with open(tmp_path / "hosp.json", "w") as fh:
        json.dump(TG._HOSP_SCHEMA_JSON, fh)
    return rows


def _mi_lines_close(j_text, t_text):
    """The port's MI file equals the JAX CLI's byte for byte: every score
    sums in XLA's compiled order (``infotheory.xla_sum``)."""
    assert t_text == j_text
    return t_text.splitlines()


@pytest.mark.parametrize("extra", [
    ["-D", "mi.score.algorithms=" + ",".join(ALGORITHMS)],
    ["-D", "mutual.info.score.algorithms=mutual.info.selection,"
     "min.redundancy.max.relevance",
     "-D", "mutual.info.redundancy.factor=0.3"],
    ["-D", "mi.score.algorithms=", "-D", "field.delim.out=;"],
    ["-D", "output.mutual.info=false"]])
def test_mutual_information_cli_vs_jax(tmp_path, capsys, extra):
    _mi_fixture(tmp_path)
    props = _props(tmp_path / "mi.properties",
                   **{"feature.schema.file.path": tmp_path / "hosp.json"})
    base = ["MutualInformation", str(tmp_path / "hosp.csv")]
    jmain(base + [str(tmp_path / "j.txt"), "--conf", props, "-D",
                  "plan.enable=false"] + extra)
    tmain(base + [str(tmp_path / "t.txt"), "--conf", props, "--device",
                  "cpu"] + extra)
    assert capsys.readouterr().out == ""
    j_text = (tmp_path / "j.txt").read_text()
    t_text = (tmp_path / "t.txt").read_text().replace(";", ",")
    t_lines = _mi_lines_close(j_text.replace(";", ","), t_text)
    kinds = {line.split(",")[0] for line in t_lines}
    if "output.mutual.info=false" in extra:
        assert kinds == {"mutual.info.maximization"}
    elif "mi.score.algorithms=" in extra:
        assert kinds == {"featureClass", "featurePair", "featurePairClass",
                         "classCondPair"}
    fc = {int(f[1]): float(f[2]) for f in map(lambda s: s.split(","),
                                                 t_lines)
          if f[0] == "featureClass"}
    if fc:
        assert fc[8] > fc[3]          # the tutorial's planted signal


@pytest.mark.parametrize("verb,pairs,algorithm", [
    ("CramerCorrelation", "3:6,2:6", None),
    ("CramerCorrelation", None, "uncertaintyCoeff"),
    ("HeterogeneityReductionCorrelation", "6:1,2:6,4:5", None),
    ("HeterogeneityReductionCorrelation", None, None)])
def test_correlation_cli_byte_identical(tmp_path, capsys, verb, pairs,
                                        algorithm):
    write_fixture(tmp_path, "churn", 1500, 1, seed=71)
    kv = {"feature.schema.file.path": tmp_path / "schema.json",
          "field.delim.out": ","}
    if pairs:
        kv["correlation.attr.pairs"] = pairs
    if algorithm:
        kv["correlation.algorithm"] = algorithm
    props = _props(tmp_path / "c.properties", **kv)
    jmain([verb, str(tmp_path / "train.csv"), str(tmp_path / "j.txt"),
           "--conf", props])
    tmain([verb, str(tmp_path / "train.csv"), str(tmp_path / "t.txt"),
           "--conf", props, "--device", "cpu"])
    j_bytes = (tmp_path / "j.txt").read_bytes()
    assert j_bytes == (tmp_path / "t.txt").read_bytes()
    out = {tuple(line.split(",")[:2]): float(line.split(",")[2])
           for line in j_bytes.decode().splitlines()}
    assert len(out) == (len(pairs.split(",")) if pairs else 10)
    if verb == "CramerCorrelation" and pairs:
        assert out[("3", "6")] > out[("2", "6")] > 0.05


def test_mutual_information_plan_enable_runs(tmp_path, capsys):
    """plan.enable=true (the default plan path) runs, with the file of the
    hand-wired body (plan.enable=false) and of the JAX CLI's default."""
    _mi_fixture(tmp_path, n=300)
    props = _props(tmp_path / "mi.properties",
                   **{"feature.schema.file.path": tmp_path / "hosp.json"})
    base = ["MutualInformation", str(tmp_path / "hosp.csv")]
    for flag in ("true", "false"):
        tmain(base + [str(tmp_path / f"t_{flag}.txt"), "--conf", props,
                      "-D", f"plan.enable={flag}", "--device", "cpu"])
    jmain(base + [str(tmp_path / "j.txt"), "--conf", props])
    assert capsys.readouterr().out == ""
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t_true.txt").read_bytes() == want
    assert (tmp_path / "t_false.txt").read_bytes() == want


@pytest.mark.parametrize("key,value", [
    ("train.sharded", "true"), ("mesh.shape", "2")])
def test_mutual_information_refuses_later_keys(tmp_path, key, value):
    _mi_fixture(tmp_path, n=40)
    props = _props(tmp_path / "mi.properties",
                   **{"feature.schema.file.path": tmp_path / "hosp.json"})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tmain(["MutualInformation", str(tmp_path / "hosp.csv"),
               str(tmp_path / "o.txt"), "--conf", props, "-D",
               f"{key}={value}", "--device", "cpu"])
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("verb", ["MutualInformation", "CramerCorrelation",
                                  "HeterogeneityReductionCorrelation"])
def test_new_verbs_refuse_resume_and_need_cpu_asked(tmp_path, verb):
    _mi_fixture(tmp_path, n=40)
    props = _props(tmp_path / "mi.properties",
                   **{"feature.schema.file.path": tmp_path / "hosp.json"})
    args = [verb, str(tmp_path / "hosp.csv"), str(tmp_path / "o.txt"),
            "--conf", props]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tmain(args)
    assert not (tmp_path / "o.txt").exists()
    tmain(args + ["--device", "cpu"])
    first = (tmp_path / "o.txt").read_text()
    assert first
    # the JAX CLI reads job.resume only on its sharded paths, which no
    # single-file job takes: --resume is accepted and changes nothing
    tmain(args + ["--resume", "--device", "cpu"])
    assert (tmp_path / "o.txt").read_text() == first
    assert not (tmp_path / "o.txt.shards").exists()


def test_hospital_generator_copy():
    assert TG.hosp_readmit_rows(400, seed=3) == JG.hosp_readmit_rows(
        400, seed=3)
    assert TG._HOSP_SCHEMA_JSON == JG._HOSP_SCHEMA_JSON
    assert [f.ordinal for f in TG.hosp_readmit_schema().get_feature_fields()] \
        == list(range(1, 11))


def test_smoke_records_the_mi_path(tmp_path):
    """``chip_smoke.recording`` sees the MI job's one K4 call — all F²
    pairs, each pair's block equal to the one-pair plain version on its
    own columns — and puts the wrappers back afterwards."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _mi_fixture(tmp_path, n=300)
    props = _props(tmp_path / "mi.properties",
                   **{"feature.schema.file.path": tmp_path / "hosp.json"})
    wrappers = (cuda_histogram.pair_counts, cuda_histogram.pair_counts_multi)
    calls = []
    with smoke.recording(calls):
        tmain(["MutualInformation", str(tmp_path / "hosp.csv"),
               str(tmp_path / "o.txt"), "--conf", props, "--device", "cpu"])
    assert (cuda_histogram.pair_counts,
            cuda_histogram.pair_counts_multi) == wrappers
    assert [name for name, _, _ in calls] == ["K4"]
    (_, a, out), = calls
    ids, pairs, cards = a["ids"], a["pairs"], a["cards"]
    assert ids.shape == (20, 300) and len(pairs) == 100
    assert torch.equal(out, cuda_histogram.pair_counts_multi_plain(
        ids, pairs, cards, a["weights"]))
    blocks = cuda_histogram.split_pairs(out, pairs, cards)
    for block, (c_a, c_b) in zip(blocks, pairs):
        assert (cards[c_a], cards[c_b]) == (9, 18)
        assert torch.equal(block, cuda_histogram.pair_counts_plain(
            ids[c_a], ids[c_b], 9, 18))
