"""K2 and K3 plain versions and the plain top-k against the JAX package:
the exact XLA path, and the Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.ops import distance as jd
from avenir_tpu.ops.pallas_distance import pairwise_topk_pallas
from avenir_tpu.ops.pallas_fused import fused_topk_pallas

from avenir_tpu_torch import ops
from avenir_tpu_torch.ops import cuda_distance, cuda_fused
from avenir_tpu_torch.ops import distance as td

from _torch_parity import exact_metrics, near_tie_rows

torch.set_num_threads(2)


def _inputs(seed, m, n, n_num=9, n_cat=0, n_bins=4, ints=False):
    rng = np.random.default_rng(seed)
    if ints:   # bounded-int features like elearn: many exact ties
        x_num = rng.integers(0, 6, (m, n_num)).astype(np.float32) / 5
        y_num = rng.integers(0, 6, (n, n_num)).astype(np.float32) / 5
    else:
        x_num = rng.random((m, n_num), dtype=np.float32)
        y_num = rng.random((n, n_num), dtype=np.float32)
    if not n_num:
        x_num = y_num = None
    x_cat = y_cat = None
    if n_cat:
        x_cat = rng.integers(0, n_bins, (m, n_cat)).astype(np.int32)
        y_cat = rng.integers(0, n_bins, (n, n_cat)).astype(np.int32)
    return x_num, y_num, x_cat, y_cat


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_kernel_path(x_num, y_num, x_cat, y_cat, k, n_bins):
    d, i = cuda_distance.pairwise_topk_cuda(
        _t(x_num), _t(y_num), _t(x_cat), _t(y_cat), k=k, n_cat_bins=n_bins)
    return d.numpy(), i.numpy()


def _assert_matches_exact(x_num, y_num, x_cat, y_cat, k, n_bins, d, i):
    """Ids equal (as sets) wherever the k-th and (k+1)-th metrics differ by
    more than 1e-5 relative; scaled ints within 1 position by position."""
    jd_, ji = jd.pairwise_topk(_j(x_num), _j(y_num), _j(x_cat), _j(y_cat),
                               k=k, n_cat_bins=n_bins, mode="exact")
    jd_, ji = np.asarray(jd_), np.asarray(ji)
    assert i.shape == ji.shape and d.shape == jd_.shape
    ties = near_tie_rows(exact_metrics(x_num, y_num, x_cat, y_cat),
                         min(k, ji.shape[1]))
    for r in np.nonzero(~ties)[0]:
        assert sorted(i[r]) == sorted(ji[r]), r
    assert np.abs(d.astype(np.int64) - jd_).max() <= 1
    return ties


@pytest.mark.parametrize("n_num,n_cat", [(9, 0), (0, 5), (4, 3)])
def test_encode_mixed_exact(n_num, n_cat):
    x_num, _, x_cat, _ = _inputs(1, 40, 1, n_num, n_cat, n_bins=5)
    want = np.asarray(jd.encode_mixed(_j(x_num), _j(x_cat), 5))
    assert np.array_equal(td.encode_mixed(_t(x_num), _t(x_cat), 5).numpy(),
                          want)


@pytest.mark.parametrize("n_num,n_cat,ints", [
    (9, 0, False), (9, 0, True), (4, 3, False), (0, 5, False)])
def test_k2_plain_vs_jax_exact(n_num, n_cat, ints):
    x_num, y_num, x_cat, y_cat = _inputs(2, 512, 4096, n_num, n_cat,
                                         ints=ints)
    d, i = _port_kernel_path(x_num, y_num, x_cat, y_cat, 5, 4)
    _assert_matches_exact(x_num, y_num, x_cat, y_cat, 5, 4, d, i)


def _gates(i_ex, d_ex, i_got, d_got, labels):
    k = i_ex.shape[1]
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(i_ex, i_got)])
    err = 0
    for re, de, rg, dg in zip(i_ex, d_ex, i_got, d_got):
        ex = dict(zip(re.tolist(), de.tolist()))
        for t, v in zip(rg.tolist(), dg.tolist()):
            if t in ex:
                err = max(err, abs(int(v) - ex[t]))
    vote = lambda idx: (labels[idx].mean(axis=1) > 0.5)  # noqa: E731
    agree = float((vote(i_ex) == vote(i_got)).mean())
    return recall, err, agree


@pytest.mark.parametrize("fused", [False, True])
def test_plain_passes_bench_gates_vs_pallas(fused):
    # mode="exact" keeps the Pallas dot in f32, which is what the TPU runs
    # (its bf16 cast is elided, pallas_distance.py:70-84); interpret mode on
    # the CPU would round real bf16 operands. The lane-bucket fold stays.
    rng = np.random.default_rng(3)
    m, n, k = 256, 2048, 5
    y = rng.random((n, 9), dtype=np.float32)
    x = rng.random((m, 9), dtype=np.float32)
    labels = (y[:, 0] > 0.5).astype(np.int64)
    if fused:
        mins = rng.random(9, dtype=np.float32) * 10
        span = rng.random(9, dtype=np.float32) * 50 + 1
        raw = x * span + mins
        pd, pi = fused_topk_pallas(jnp.asarray(raw), jnp.asarray(y), k=k,
                                   mins=jnp.asarray(mins),
                                   span=jnp.asarray(span), interpret=True,
                                   tile_m=128, tile_n=512, mode="exact")
        td_, ti = cuda_fused.fused_topk_cuda(
            torch.from_numpy(raw), torch.from_numpy(y), k=k,
            mins=torch.from_numpy(mins), span=torch.from_numpy(span))
    else:
        pd, pi = pairwise_topk_pallas(jnp.asarray(x), jnp.asarray(y), k=k,
                                      interpret=True, tile_m=128, tile_n=512,
                                      mode="exact")
        td_, ti = cuda_distance.pairwise_topk_cuda(
            torch.from_numpy(x), torch.from_numpy(y), k=k)
    pd, pi, td_, ti = map(np.asarray, (pd, pi, td_, ti))
    recall, err, agree = _gates(pi, pd, ti, td_, labels)
    assert recall >= 0.985 and err <= 25 and agree >= 0.99, (recall, err,
                                                             agree)


@pytest.mark.parametrize("n_num,n_cat", [(9, 0), (4, 3)])
def test_plain_fused_on_raw_is_bit_identical_to_staged(n_num, n_cat):
    x_num, y_num, x_cat, y_cat = _inputs(4, 300, 1500, n_num, n_cat)
    rng = np.random.default_rng(5)
    mins = rng.random(n_num, dtype=np.float32) * 7
    span = rng.random(n_num, dtype=np.float32) * 30 + 1
    raw = np.round(x_num * span + mins)
    staged = (raw - mins) / span
    fd, fi = cuda_fused.fused_topk_cuda(
        _t(raw), _t(y_num), _t(x_cat), _t(y_cat), mins=_t(mins),
        span=_t(span), k=5, n_cat_bins=4)
    sd, si = cuda_distance.pairwise_topk_cuda(
        _t(staged), _t(y_num), _t(x_cat), _t(y_cat), k=5, n_cat_bins=4)
    assert torch.equal(fd, sd) and torch.equal(fi, si)
    # the JAX package's fused kernel sees the same normalize
    assert np.array_equal(
        np.asarray((jnp.asarray(raw) - mins) / span), staged)


@pytest.mark.parametrize("n", [1, 3, 7, 13])
def test_fewer_train_rows_than_k(n):
    x_num, y_num, _, _ = _inputs(6, 50, n)
    d, i = _port_kernel_path(x_num, y_num, None, None, 5, 0)
    assert i.shape == (50, min(5, n))
    assert np.all((i >= 0) & (i < n)) and np.all(d < td.INT_BIG)
    _assert_matches_exact(x_num, y_num, None, None, 5, 0, d, i)


def test_exact_ties_go_to_the_lowest_id():
    rng = np.random.default_rng(7)
    base = rng.random((40, 9), dtype=np.float32)
    y = np.concatenate([base] * 5)          # every row five times
    x = base[:30]
    d, i = _port_kernel_path(x, y, None, None, 5, 0)
    # the 5 copies of row r sit at r, r+40, r+80, ... and all tie at 0
    assert np.array_equal(i, np.arange(30)[:, None] + 40 * np.arange(5))
    assert np.all(d == 0)
    # plain and categorical ties alike: mismatch counts are whole numbers
    _, _, x_cat, y_cat = _inputs(8, 64, 600, 0, 5, n_bins=3)
    dc, ic = _port_kernel_path(None, None, x_cat, y_cat, 5, 3)
    jdc, jic = jd.pairwise_topk(None, None, jnp.asarray(x_cat),
                                jnp.asarray(y_cat), k=5, n_cat_bins=3,
                                mode="exact")
    assert np.array_equal(ic, np.asarray(jic))
    assert np.array_equal(dc, np.asarray(jdc))


@pytest.mark.parametrize("m,n,width,k", [(64, 1000, 9, 128),
                                          (48, 600, 512, 5)])
def test_supported_range_edges(m, n, width, k):
    x_num, y_num, _, _ = _inputs(9, m, n, width)
    d, i = _port_kernel_path(x_num, y_num, None, None, k, 0)
    ties = _assert_matches_exact(x_num, y_num, None, None, k, 0, d, i)
    assert ties.sum() < m
    assert cuda_distance.supported(algorithm="euclidean", k=k, mode="fast",
                                   encoded_width=width)
    assert not cuda_distance.supported(algorithm="euclidean", k=129,
                                       mode="fast", encoded_width=width)
    assert not cuda_distance.supported(algorithm="euclidean", k=5,
                                       mode="fast", encoded_width=513)


@pytest.mark.parametrize("algorithm,mode", [("euclidean", "exact"),
                                            ("manhattan", "exact"),
                                            ("manhattan", "fast"),
                                            ("euclidean", "fast")])
def test_plain_topk_modes_vs_jax(algorithm, mode):
    x_num, y_num, x_cat, y_cat = _inputs(10, 200, 900, 4, 2, n_bins=3)
    d, i = td.pairwise_topk(_t(x_num), _t(y_num), _t(x_cat), _t(y_cat), k=5,
                            n_cat_bins=3, algorithm=algorithm, mode=mode,
                            block_size=256)
    jd_, ji = jd.pairwise_topk(_j(x_num), _j(y_num), _j(x_cat), _j(y_cat),
                               k=5, n_cat_bins=3, algorithm=algorithm,
                               mode="exact", block_size=256)
    d, i, jd_, ji = map(np.asarray, (d, i, jd_, ji))
    if algorithm == "manhattan":
        metric = (np.abs(x_num[:, None] - y_num[None]).sum(-1)
                  + (x_cat[:, None] != y_cat[None]).sum(-1))
    else:
        metric = exact_metrics(x_num, y_num, x_cat, y_cat)
    ties = near_tie_rows(metric, 5)
    for r in np.nonzero(~ties)[0]:
        assert sorted(i[r]) == sorted(ji[r]), r
    assert np.abs(d.astype(np.int64) - jd_).max() <= 1


def test_fused_topk_dispatch():
    x_num, y_num, x_cat, y_cat = _inputs(11, 120, 700, 4, 2, n_bins=3)
    mins = np.full(4, 0.25, np.float32)
    span = np.full(4, 2.0, np.float32)
    args = (_t(x_num), _t(y_num), _t(x_cat), _t(y_cat))
    kw = dict(mins=_t(mins), span=_t(span), k=5, n_cat_bins=3)
    assert all(torch.equal(a, b) for a, b in zip(
        ops.fused_topk(*args, **kw), cuda_fused.fused_topk_cuda(*args, **kw)))
    # exact mode is outside the kernel family: normalize → plain top-k
    got = ops.fused_topk(*args, mode="exact", **kw)
    staged = td.pairwise_topk(_t((x_num - mins) / span), _t(y_num),
                              _t(x_cat), _t(y_cat), k=5, n_cat_bins=3,
                              mode="exact")
    assert all(torch.equal(a, b) for a, b in zip(got, staged))
