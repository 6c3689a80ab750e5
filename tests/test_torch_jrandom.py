"""The port's JAX random bits (``utils/jrandom.py``) and its samplers
(``explore/sampling.py``) against ``jax.random`` and the JAX package's
samplers, bit for bit; ``samplecomplexity`` and ``buy_xaction_rows``
against their JAX originals."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.explore import samplecomplexity as jsc
from avenir_tpu.explore import sampling as js

from avenir_tpu_torch import datagen as TG
from avenir_tpu_torch.explore import samplecomplexity as tsc
from avenir_tpu_torch.explore import sampling as ts
from avenir_tpu_torch.utils import jrandom

torch.set_num_threads(2)

SEEDS = (0, 1, 42, -1, 2 ** 31 - 1, 2 ** 32 + 5)


def _keys(seed):
    return jax.random.PRNGKey(seed), jrandom.prng_key(seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    jk, tk = _keys(seed)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    for num in (2, 3, 7):
        assert np.array_equal(jrandom.split(tk, num).numpy(),
                              np.asarray(jax.random.split(jk, num)))
    # a split of a split, as bagging's and randint's subkeys are
    sub = jrandom.split(jrandom.split(tk)[1])[0]
    jsub = jax.random.split(jax.random.split(jk)[1])[0]
    assert np.array_equal(sub.numpy(), np.asarray(jsub))


def test_known_answers():
    """``jax.random`` at PRNGKey(0) under threefry2x32, partitionable."""
    key = jrandom.prng_key(0, "cpu")
    assert jrandom.uniform(key, (4,)).tolist() == np.asarray(
        [0.947667, 0.9785799, 0.33229148, 0.46866846], np.float32).tolist()
    assert jrandom.randint(key, (4,), 0, 10).tolist() == [9, 0, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (4, 5), (100_003,)])
def test_uniform_bits(seed, shape):
    jk, tk = _keys(seed)
    got = jrandom.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(),
                          np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("seed", (0, 42, -1, 2 ** 32 + 5))
@pytest.mark.parametrize("span", [1, 7, 10_000, 65_537, 2 ** 31 - 1])
def test_randint_bits(seed, span):
    jk, tk = _keys(seed)
    for shape in ((11,), (3, 10_000)):
        got = jrandom.randint(tk, shape, 0, span)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(
            jax.random.randint(jk, shape, 0, span)))


@pytest.mark.parametrize("lo,hi", [(5, 3), (-7, 30), (-2 ** 31, 2 ** 31 - 1),
                                   (100, 100)])
def test_randint_offsets_and_empty_spans(lo, hi):
    jk, tk = _keys(7)
    assert np.array_equal(jrandom.randint(tk, (99,), lo, hi).numpy(),
                          np.asarray(jax.random.randint(jk, (99,), lo, hi)))


def _labels(n, probs, seed):
    return np.random.default_rng(seed).choice(len(probs), n, p=probs) \
        .astype(np.int32)


@pytest.mark.parametrize("seed", (0, 9))
@pytest.mark.parametrize("probs", [(0.7, 0.2, 0.1), (0.5, 0.5), (0.9, 0.1)])
def test_under_sample_masks_equal_jax(seed, probs):
    lab = _labels(4000, probs, seed + 1)
    jk, tk = _keys(seed)
    want = np.asarray(js.under_sample(jnp.asarray(lab), jk, len(probs)))
    got = ts.under_sample(torch.from_numpy(lab), tk, len(probs)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bootstrap", [1, 100, 2500, 10_000])
def test_streaming_keep_probs_and_masks_equal_jax(bootstrap):
    lab = _labels(4000, (0.6, 0.3, 0.1), 3)
    jk, tk = _keys(5)
    want = np.asarray(js._streaming_keep_probs(jnp.asarray(lab), 3,
                                               bootstrap))
    got = ts._streaming_keep_probs(torch.from_numpy(lab), 3, bootstrap)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(js.under_sample_streaming(jnp.asarray(lab), jk, 3,
                                                bootstrap))
    got = ts.under_sample_streaming(torch.from_numpy(lab), tk, 3, bootstrap)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_rows,batch", [(30_000, 10_000), (25_003, 10_000),
                                          (777, 10_000), (0, 10), (64, 8)])
def test_bagging_sample_equals_jax(n_rows, batch):
    for seed in (0, 3):
        jk, tk = _keys(seed)
        want = np.asarray(js.bagging_sample(n_rows, jk, batch))
        got = ts.bagging_sample(n_rows, tk, batch).numpy()
        assert np.array_equal(got, want)


def test_samplecomplexity_equals_jax():
    """The JAX module's own tests' cases."""
    assert (tsc.pac_sample_bound(973, 0.1, 0.05)
            == jsc.pac_sample_bound(973, 0.1, 0.05) == 99)
    assert (tsc.pac_sample_bound_ln(math.log(973), 0.1, 0.05)
            == jsc.pac_sample_bound_ln(math.log(973), 0.1, 0.05))
    for mod in (tsc, jsc):
        with pytest.raises(ValueError):
            mod.pac_sample_bound(10, 0.0, 0.05)
        with pytest.raises(ValueError):
            mod.pac_sample_bound_ln(5.0, 0.1, 0.0)
        with pytest.raises(ValueError):
            mod.num_value_combinations([2, 3], 5)
    assert (tsc.sample_table(100, [0.1, 0.2], [0.05])
            == jsc.sample_table(100, [0.1, 0.2], [0.05]))
    assert (tsc.conjunctive_hypothesis_space([3, 4], 2)
            == jsc.conjunctive_hypothesis_space([3, 4], 2) == 40)
    for k in (2, 3):
        assert (tsc.num_value_combinations([2, 3, 4], k)
                == jsc.num_value_combinations([2, 3, 4], k))
    assert (tsc.k_term_dnf_hypothesis_space([2, 3, 4], 2, 2, 2)
            == jsc.k_term_dnf_hypothesis_space([2, 3, 4], 2, 2, 2) == 650)
    assert (tsc.k_cnf_hypothesis_space_ln([2, 3, 4], 2, 2)
            == jsc.k_cnf_hypothesis_space_ln([2, 3, 4], 2, 2))


@pytest.mark.parametrize("args", [(200, 120, 0.1, 3), (300, 200, 0.15, 4)])
def test_buy_xaction_rows_equal_jax(args):
    *shape, seed = args
    assert TG.buy_xaction_rows(*shape, seed=seed) == JG.buy_xaction_rows(
        *shape, seed=seed)


_JITTED = {}


def _jitted(name, fn):
    """One compiled function a name, shared by the parametrized cases."""
    if name not in _JITTED:
        _JITTED[name] = jax.jit(fn)
    return _JITTED[name]


@pytest.mark.parametrize("seed", (0, 1, 42, -1, 2 ** 32 + 5))
@pytest.mark.parametrize("shape", [(3,), (1000,), (4, 5)])
def test_gumbel_bits(seed, shape):
    """``jax.random.gumbel`` compiled (XLA's CPU logs), default mode."""
    jk, tk = _keys(seed)
    want = np.asarray(_jitted(("gumbel", shape), lambda k: jax.random.gumbel(
        k, shape))(jk))
    got = jrandom.gumbel(tk, shape).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", (0, 7, 42, -1))
@pytest.mark.parametrize("n", [2, 3, 12, 40])
def test_categorical_and_choice(seed, n):
    jk, tk = _keys(seed)
    rng = np.random.default_rng(abs(seed) + n)
    logits = rng.normal(size=n).astype(np.float32) * 3
    p = rng.random(n).astype(np.float32)
    p /= p.sum()
    categorical = _jitted("categorical", jax.random.categorical)
    choice = _jitted(("choice", n),
                     lambda k, q: jax.random.choice(k, n, p=q))
    for k_j, k_t in zip(jax.random.split(jk, 8), jrandom.split(tk, 8)):
        assert int(jrandom.categorical(k_t, torch.from_numpy(logits))) == \
            int(categorical(k_j, logits))
        assert int(jrandom.choice(k_t, n, torch.from_numpy(p))) == int(
            choice(k_j, p))


def test_known_answers_of_the_learners_draws():
    """At PRNGKey(0): gumbel, categorical over [0, 1, 2] and choice over
    [0.2, 0.3, 0.5], as ``jax.random`` draws them."""
    key = jrandom.prng_key(0, "cpu")
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (3,)))
    assert np.array_equal(jrandom.gumbel(key, (3,)).numpy(), want)
    logits = np.asarray([0.0, 1.0, 2.0], np.float32)
    assert int(jrandom.categorical(key, torch.from_numpy(logits))) == int(
        jax.random.categorical(jax.random.PRNGKey(0), logits))
    p = np.asarray([0.2, 0.3, 0.5], np.float32)
    assert int(jrandom.choice(key, 3, torch.from_numpy(p))) == int(
        jax.random.choice(jax.random.PRNGKey(0), 3, p=p))
    with pytest.raises(ValueError, match="3 probabilities"):
        jrandom.choice(key, 3, torch.ones(4))


@pytest.mark.parametrize("seed", (0, 5, -1))
def test_randint_with_a_bound_a_position(seed):
    """``maxval`` as a tensor broadcast against the shape, as the Thompson
    samplers' per-arm ring-buffer bounds (0 and 1 give 0)."""
    jk, tk = _keys(seed)
    hi = np.asarray([1, 5, 256, 3, 0], np.int32)
    assert np.array_equal(
        jrandom.randint(tk, (5,), 0, torch.from_numpy(hi)).numpy(),
        np.asarray(jax.random.randint(jk, (5,), 0, hi)))
    assert np.array_equal(
        jrandom.randint(tk, (5, 7), 0, torch.from_numpy(hi)[:, None]).numpy(),
        np.asarray(jax.random.randint(jk, (5, 7), 0, hi[:, None])))
