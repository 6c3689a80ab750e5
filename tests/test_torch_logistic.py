"""The port's logistic regression and Fisher discriminant against the JAX
package: the modules, and the LogisticRegressionJob and
FisherDiscriminant verbs' files against the JAX CLI's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.models import fisher as jfisher
from avenir_tpu.models import logistic as jlog
from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
from avenir_tpu.utils.schema import FeatureSchema as JSchema

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.models import fisher as tfisher
from avenir_tpu_torch.models import logistic as tlog
from avenir_tpu_torch.utils.dataset import Featurizer as TFeaturizer
from avenir_tpu_torch.utils.schema import FeatureSchema as TSchema

from _torch_parity import write_csv

torch.set_num_threads(2)

# the f32 loop's coefficients against the JAX package's (ROADMAP queue C:
# its f32 matvec sums in Eigen's order, the port's in float64)
RTOL, ATOL = 1e-5, 1e-6


def _data(n=2000, seed=0, d=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    true_w = np.linspace(1.5, -2.0, d)
    p = 1 / (1 + np.exp(-(x @ true_w + 0.3)))
    y = (rng.random(n) < p).astype(np.float32)
    return x, y


def _history(path):
    return np.asarray([[float(v) for v in line.split(",")]
                       for line in open(path).read().splitlines()])


def _both(x, y, tmp_path, **cfg):
    jw, jit, jconv = jlog.train(jnp.asarray(x), jnp.asarray(y),
                                jlog.LogisticConfig(**cfg),
                                str(tmp_path / "j.txt"))
    tw, tit, tconv = tlog.train(torch.from_numpy(x), torch.from_numpy(y),
                                tlog.LogisticConfig(**cfg),
                                str(tmp_path / "t.txt"))
    return (jw, jit, jconv), (tw, tit, tconv)


@pytest.mark.parametrize("cfg", [
    dict(learning_rate=1.0, max_iterations=300, convergence_threshold=0.01),
    dict(learning_rate=0.01, max_iterations=500, convergence_threshold=5.0),
    dict(learning_rate=0.5, max_iterations=37, convergence_threshold=1e-9,
         convergence_criteria="all")])
def test_f32_loop_agrees_with_jax(cfg, tmp_path):
    """The same iterations and ``converged``; every coefficient of every
    history line within rtol 1e-5 + atol 1e-6 of the JAX package's."""
    x, y = _data()
    (jw, jit, jconv), (tw, tit, tconv) = _both(x, y, tmp_path, **cfg)
    assert (tit, tconv) == (jit, jconv)
    want, got = _history(tmp_path / "j.txt"), _history(tmp_path / "t.txt")
    assert got.shape == want.shape == (jit, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)


def test_f32_loop_exact_where_the_products_are(tmp_path):
    """One feature, no intercept, one row: each product is one f32
    rounding in both packages, so every step is bit for bit — the XLA
    sigmoid and the fused update reproduced."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        x = (rng.normal(size=(1, 1)) * 10).astype(np.float32)
        y = np.float32([rng.integers(0, 2)])
        w0 = rng.normal(size=(1,)).astype(np.float32)
        s = np.float32(rng.uniform(0.01, 1.0))
        want = np.asarray(jlog._train_chunk(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(w0), jnp.asarray(s)))
        got = tlog._train_chunk(tlog._feature_major(torch.from_numpy(x)),
                                torch.from_numpy(y), torch.from_numpy(w0),
                                torch.tensor(s))
        assert np.array_equal(got.numpy(), want)


def test_f64_loop_byte_identical(tmp_path):
    x, y = _data(500)
    (jw, jit, jconv), (tw, tit, tconv) = _both(
        x, y, tmp_path, learning_rate=0.5, max_iterations=3000,
        convergence_threshold=1e-7)
    assert (tit, tconv) == (jit, jconv) and jconv
    assert ((tmp_path / "t.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())
    assert np.array_equal(tw, jw)


@pytest.mark.parametrize("threshold", [1.0, 1e-5])
def test_resume_from_a_truncated_history(threshold, tmp_path):
    """A run cut after 7 iterations and resumed from its history file
    writes the uninterrupted run's file."""
    x, y = _data(800, seed=2)
    whole = tmp_path / "whole.txt"
    cut = tmp_path / "cut.txt"
    cfg = dict(learning_rate=0.5, convergence_threshold=threshold)
    tlog.train(torch.from_numpy(x), torch.from_numpy(y),
               tlog.LogisticConfig(max_iterations=40, **cfg), str(whole))
    lines = whole.read_text().splitlines(keepends=True)
    cut.write_text("".join(lines[:7]))
    w, it, _ = tlog.train(torch.from_numpy(x), torch.from_numpy(y),
                          tlog.LogisticConfig(max_iterations=40, **cfg),
                          str(cut))
    assert it == len(lines) and cut.read_bytes() == whole.read_bytes()


def test_tree_sum_is_a_fixed_order():
    """The gradient's float64 row sum halves the rows, padded with zero
    rows to a power of two: its value is that tree's, and a padded row
    adds nothing."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 64, 1001):
        x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        x64 = tlog._feature_major(x)
        p = x64.shape[1]
        assert p >= n and p & (p - 1) == 0 and not x64[:, n:].any()
        rows = [x64[:, i] for i in range(p)]
        while len(rows) > 1:
            half = len(rows) // 2
            rows = [rows[i] + rows[half + i] for i in range(half)]
        assert torch.equal(tlog._tree_sum(x64), rows[0])
        np.testing.assert_allclose(tlog._tree_sum(x64).numpy(),
                                   x.double().sum(0).numpy(), rtol=1e-12)


def test_predict_agrees_with_jax():
    x, y = _data(600)
    cfg_j, cfg_t = jlog.LogisticConfig(), tlog.LogisticConfig()
    w = np.asarray([0.25, 1.0, -1.5, 0.5])
    want = np.asarray(jlog.predict_proba(jnp.asarray(x), w, cfg_j))
    got = tlog.predict_proba(torch.from_numpy(x), w, cfg_t)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(tlog.predict(torch.from_numpy(x), w, cfg_t),
                          jlog.predict(jnp.asarray(x), w, cfg_j))


# -- Fisher -------------------------------------------------------------------

_FISHER_JSON = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    *({"name": f"x{i}", "ordinal": i, "dataType": "int", "feature": True}
      for i in (1, 2, 3)),
    {"name": "cls", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["pos", "neg"]}]}


def _fisher_rows(n, seed, integer=True):
    """Three features, class-shifted; integers in [0, 60] keep every f32
    sum and sum of squares below 2^24 at n ≤ 4,000."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pos = rng.random() < 0.4
        vals = rng.normal([30, 20, 40] if pos else [22, 28, 37], 6)
        vals = np.clip(vals, 0, 60)
        vals = np.rint(vals).astype(int) if integer else vals
        rows.append([f"r{i}", *(str(v) for v in vals),
                     "pos" if pos else "neg"])
    return rows


def _fisher_tables(rows):
    j = JFeaturizer(JSchema.from_json(_FISHER_JSON)).fit_transform(rows)
    t = TFeaturizer(TSchema.from_json(_FISHER_JSON),
                    device="cpu").fit_transform(rows)
    return j, t


def test_fisher_serializes_like_jax_below_2_24():
    j, t = _fisher_tables(_fisher_rows(3000, 1))
    jm, tm = jfisher.train(j), tfisher.train(t)
    assert tfisher.serialize(tm) == jfisher.serialize(jm)
    assert tfisher.serialize(tm, "\t") == jfisher.serialize(jm, "\t")
    for f in range(3):
        assert np.array_equal(
            tfisher.classify(tm, t.numeric[:, f], f),
            jfisher.classify(jm, j.numeric[:, f], f))


def test_fisher_agrees_with_jax_on_real_values():
    """Real-valued features: JAX's f32 einsum sums are not exact, the
    port's moments are (float64, rounded once), so the discriminant agrees
    to the moments' f32 precision: the means within 1e-5, the variances
    (``sumsq/n − mean²``, ~22× cancellation here) within 1e-4."""
    j, t = _fisher_tables(_fisher_rows(3000, 2, integer=False))
    jm, tm = jfisher.train(j), tfisher.train(t)
    assert tm.log_odds_prior == jm.log_odds_prior
    for f, rtol in (("mean0", 1e-5), ("mean1", 1e-5),
                    ("pooled_variance", 1e-4), ("boundary", 1e-4)):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   rtol=rtol)


def test_fisher_needs_both_classes():
    rows = [r for r in _fisher_rows(200, 3) if r[-1] == "pos"]
    j, t = _fisher_tables(rows)
    for mod, table in ((tfisher, t), (jfisher, j)):
        with pytest.raises(ValueError, match="'neg' has no rows"):
            mod.train(table)


# -- the two verbs against the JAX CLI ----------------------------------------

def _cli_both(capsys, args_of):
    out = {}
    for tag, fn, extra in (("j", jmain, ["-D", "plan.enable=false"]),
                           ("t", tmain, ["--device", "cpu"])):
        fn(args_of(tag) + extra)
        out[tag] = capsys.readouterr().out
    return out


def _elearn_csv(tmp_path, n, seed=5):
    from avenir_tpu.datagen import generators as JG
    write_csv(tmp_path / "elearn.csv", JG.elearn_rows(n, seed=seed))
    return str(tmp_path / "elearn.csv")


@pytest.mark.parametrize("extra", [
    (),
    ("-D", "convergence.threshold=1e-5", "-D", "iteration.limit=40"),
    ("-D", "convergence.criteria=all", "-D", "learning.rate=0.1")])
def test_logistic_regression_job_matches_the_jax_cli(extra, tmp_path,
                                                     capsys):
    """elearn's nine features and the fail class: stdout equal (iterations
    and converged); on the float64 loop the history and output byte for
    byte, on the f32 loop within the queue C tolerance."""
    data = _elearn_csv(tmp_path, 1200)
    props = tmp_path / "lr.properties"
    props.write_text("field.delim.regex=,\nfeature.field.ordinals="
                     "1,2,3,4,5,6,7,8,9\nclass.attr.ord=10\n"
                     "positive.class.value=fail\niteration.limit=60\n")
    out = _cli_both(capsys, lambda tag: [
        "LogisticRegressionJob", data, str(tmp_path / f"{tag}.txt"),
        "--conf", str(props), "-D",
        f"coeff.file.path={tmp_path / f'{tag}_hist.txt'}", *extra])
    assert out["t"] == out["j"]
    assert json.loads(out["t"].splitlines()[-1])["iterations"] > 0
    for name in ("", "_hist"):
        want = (tmp_path / f"j{name}.txt")
        got = (tmp_path / f"t{name}.txt")
        if "convergence.threshold=1e-5" in extra:
            assert got.read_bytes() == want.read_bytes()
        else:
            np.testing.assert_allclose(_history(got), _history(want),
                                       rtol=RTOL, atol=ATOL)


def test_logistic_regression_job_resumes(tmp_path, capsys):
    """A job split at iteration 25 and resumed from its history file
    writes the uninterrupted job's history and output."""
    data = _elearn_csv(tmp_path, 600, seed=8)
    props = tmp_path / "lr.properties"
    props.write_text("feature.field.ordinals=1,2,3,4,5,6,7,8,9\n"
                     "class.attr.ord=10\npositive.class.value=fail\n")

    def run(tag, limit):
        tmain(["LogisticRegressionJob", data, str(tmp_path / f"{tag}.txt"),
               "--conf", str(props), "-D", f"iteration.limit={limit}",
               "-D", f"coeff.file.path={tmp_path / f'{tag}_hist.txt'}",
               "--device", "cpu"])
        return capsys.readouterr().out

    whole = run("whole", 50)
    run("split", 25)
    assert run("split", 50) == whole
    for name in ("", "_hist"):
        assert ((tmp_path / f"split{name}.txt").read_bytes()
                == (tmp_path / f"whole{name}.txt").read_bytes())


@pytest.mark.parametrize("delim_out", [",", ";"])
def test_fisher_discriminant_matches_the_jax_cli(delim_out, tmp_path,
                                                 capsys):
    write_csv(tmp_path / "f.csv", _fisher_rows(2500, 6))
    (tmp_path / "schema.json").write_text(json.dumps(_FISHER_JSON))
    props = tmp_path / "f.properties"
    props.write_text(f"feature.schema.file.path={tmp_path / 'schema.json'}\n"
                     f"field.delim.out={delim_out}\n")
    out = _cli_both(capsys, lambda tag: [
        "FisherDiscriminant", str(tmp_path / "f.csv"),
        str(tmp_path / f"{tag}.txt"), "--conf", str(props)])
    assert out["t"] == out["j"]
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt") \
        .read_bytes()
    assert len((tmp_path / "t.txt").read_text().splitlines()) == 3
