"""K1's plain version and the port's count reductions against the JAX
package: the jnp path and the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.ops import histogram as jh
from avenir_tpu.ops import pallas_histogram as jp

from avenir_tpu_torch.ops import cuda_histogram
from avenir_tpu_torch.ops import histogram as th

torch.set_num_threads(2)


def _ids(rng, n, f, c, b, bad):
    lo, hi = (-2, 2) if bad else (0, 0)
    bins = rng.integers(lo, b + hi, size=(n, f)).astype(np.int32)
    labels = rng.integers(lo, c + hi, size=n).astype(np.int32)
    return bins, labels


def _weights(rng, n, kind):
    if kind == "01":
        return (rng.random(n) < 0.6).astype(np.float32)
    if kind == "float":
        return rng.random(n).astype(np.float32) * 3.0
    return None


CASES = [
    # (n, f, c, b, bad ids)
    (1000, 5, 2, 5, True),      # out-of-range bins and labels drop
    (2100, 3, 3, 4, False),     # ragged tail past one 2048-row block
    (1, 4, 2, 3, False),
    (0, 4, 2, 3, False),        # N = 0
    (300, 0, 2, 3, False),      # F = 0
    (257, 2, 7, 11, True),
]


@pytest.mark.parametrize("n,f,c,b,bad", CASES)
@pytest.mark.parametrize("wkind", [None, "01"])
def test_counts_exact_vs_jax(n, f, c, b, bad, wkind):
    rng = np.random.default_rng(n * 31 + f)
    bins, labels = _ids(rng, n, f, c, b, bad)
    w = _weights(rng, n, wkind)
    got = cuda_histogram.class_feature_bin_counts(
        torch.from_numpy(bins), torch.from_numpy(labels), c, b,
        None if w is None else torch.from_numpy(w)).numpy()
    jw = None if w is None else jnp.asarray(w)
    ref = np.asarray(jh._class_feature_bin_counts_jnp(
        jnp.asarray(bins), jnp.asarray(labels), c, b, jw))
    pal = np.asarray(jp.class_feature_bin_counts(
        jnp.asarray(bins), jnp.asarray(labels), c, b, jw, interpret=True))
    assert got.shape == (c, f, b) and got.dtype == np.float32
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pal)


@pytest.mark.parametrize("n,f,c,b,bad", CASES[:3])
def test_float_weights_within_f32_rounding(n, f, c, b, bad):
    rng = np.random.default_rng(7 + n)
    bins, labels = _ids(rng, n, f, c, b, bad)
    w = _weights(rng, n, "float")
    got = cuda_histogram.class_feature_bin_counts(
        torch.from_numpy(bins), torch.from_numpy(labels), c, b,
        torch.from_numpy(w)).numpy()
    ref = np.asarray(jh._class_feature_bin_counts_jnp(
        jnp.asarray(bins), jnp.asarray(labels), c, b, jnp.asarray(w)))
    pal = np.asarray(jp.class_feature_bin_counts(
        jnp.asarray(bins), jnp.asarray(labels), c, b, jnp.asarray(w),
        interpret=True))
    # f32 sums in another order: a few ulps of the largest count
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * ref.max())
    np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-6 * ref.max())


def test_cpu_tensor_takes_plain_and_counts_no_launch():
    before = cuda_histogram.class_feature_bin_counts.launches
    bins = torch.zeros((10, 2), dtype=torch.int32)
    labels = torch.ones(10, dtype=torch.int32)
    out = th.class_feature_bin_counts(bins, labels, 2, 3)
    assert out[1, :, 0].tolist() == [10.0, 10.0] and out.sum() == 20
    assert cuda_histogram.class_feature_bin_counts.launches == before


def test_other_devices_are_refused():
    bins = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    labels = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_histogram.class_feature_bin_counts(bins, labels, 2, 3)


@pytest.mark.parametrize("wkind", [None, "01", "float"])
def test_other_reductions_vs_jax(wkind):
    rng = np.random.default_rng(5)
    n, f, c, b = 900, 4, 3, 6
    bins, labels = _ids(rng, n, f, c, b, bad=True)
    vals = rng.normal(50.0, 20.0, size=(n, 3)).astype(np.float32)
    w = _weights(rng, n, wkind)
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    tol = dict(rtol=1e-6) if wkind == "float" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(
        th.class_counts(torch.from_numpy(labels), c, tw).numpy(),
        np.asarray(jh.class_counts(jnp.asarray(labels), c, jw)), **tol)
    np.testing.assert_allclose(
        th.feature_bin_counts(torch.from_numpy(bins), b, tw).numpy(),
        np.asarray(jh.feature_bin_counts(jnp.asarray(bins), b, jw)), **tol)
    t_mom = th.per_class_moments(torch.from_numpy(vals),
                                 torch.from_numpy(labels), c, tw)
    j_mom = jh.per_class_moments(jnp.asarray(vals), jnp.asarray(labels), c,
                                 jw)
    for t, j in zip(t_mom, j_mom):
        # f32 sums of ~900 terms in another order
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6)
