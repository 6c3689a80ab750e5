"""K2, K3 and K5 plain versions and the plain top-k against the JAX
package: the exact XLA path, and the Pallas kernels in interpret mode."""

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


def _stable_sort_topk(d, i, k):
    """The k smallest of each row by a stable sort of the whole row."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


@pytest.mark.parametrize("block_size", [1, 2, 3, 7, 64, 600])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n_num,n_cat", [(0, 5), (9, 0), (4, 3)])
def test_block_merge_equals_stable_sort_of_the_row(block_size, k, n_num,
                                                   n_cat):
    """The running merge over blocks keeps what one stable sort of the
    whole row keeps, with ties at the k-th place falling across blocks
    (bounded ints and 3-bin codes tie everywhere) and blocks narrower than
    k leaving the (TOPK_BIG, −1) sentinels in the running list."""
    x_num, y_num, x_cat, y_cat = _inputs(21, 48, 600, n_num, n_cat,
                                         n_bins=3, ints=True)
    args = (_t(x_num), _t(y_num), _t(x_cat), _t(y_cat))
    d, i = td.pairwise_topk_raw(*args, k=k, block_size=block_size,
                                n_cat_bins=3, mode="exact")
    # the blocks' metrics as the sweep computes them (a product's rounding
    # may depend on its width)
    metric = torch.cat([td._block_metric(
        args[0], None if y_num is None else args[1][j0:j0 + block_size],
        args[2], None if y_cat is None else args[3][j0:j0 + block_size],
        3, "euclidean") for j0 in range(0, 600, block_size)], dim=1)
    ids = torch.arange(600, dtype=torch.int32).expand(48, 600)
    want_d, want_i = _stable_sort_topk(metric, ids, k)
    assert torch.equal(i, want_i) and torch.equal(d, want_d)
    # the rows do tie at the cut, across blocks
    assert (metric <= want_d[:, -1:]).sum(dim=1).gt(k).any()


def test_merge_equals_stable_sort_with_sentinels_and_signed_zeros():
    """``stable_merge_topk`` on a running list that still holds sentinels,
    candidates that tie with it, −0 beside +0, and a candidate block
    narrower than k."""
    rng = np.random.default_rng(5)
    for width, k in ((12, 4), (3, 6), (40, 8)):
        best_d = np.sort(rng.integers(0, 4, (32, k)), axis=1).astype(
            np.float32)
        best_d[:, k // 2:] = td.TOPK_BIG
        best_i = np.where(best_d < td.TOPK_BIG,
                          rng.integers(0, 50, (32, k)), -1).astype(np.int32)
        best_i = np.sort(best_i, axis=1)   # equal metrics in id order
        cand_d = rng.integers(0, 4, (32, width)).astype(np.float32)
        cand_d[rng.random((32, width)) < 0.2] = -0.0
        cand_i = np.broadcast_to(np.arange(50, 50 + width, dtype=np.int32),
                                 (32, width)).copy()
        got = td.stable_merge_topk(*map(torch.from_numpy, (
            best_d, best_i, cand_d, cand_i)), k)
        want = _stable_sort_topk(
            torch.from_numpy(np.concatenate([best_d, cand_d], axis=1)),
            torch.from_numpy(np.concatenate([best_i, cand_i], axis=1)), k)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])


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


@pytest.mark.parametrize("n_num,n_cat,m,n,k", [
    (9, 0, 257, 3001, 5), (4, 3, 100, 900, 7), (0, 5, 64, 600, 5),
    (9, 0, 20, 3, 5)])
def test_tpose_layout_equals_lane_layout(n_num, n_cat, m, n, k):
    x_num, y_num, x_cat, y_cat = _inputs(12, m, n, n_num, n_cat, n_bins=3)
    args = (_t(x_num), _t(y_num), _t(x_cat), _t(y_cat))
    lane = cuda_distance.pairwise_topk_cuda(*args, k=k, n_cat_bins=3)
    tpose = ops.pairwise_topk_cuda(*args, k=k, n_cat_bins=3, layout="tpose")
    assert all(torch.equal(a, b) for a, b in zip(lane, tpose))
    x = td.encode_mixed(args[0], args[2], 3)
    y = td.encode_mixed(args[1], args[3], 3)
    y2 = td.row_sq_norm(y)
    kk = min(k, n)
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_distance.topk_raw_tpose(x.T.contiguous(), y.T.contiguous(), y2,
                                     kk),
        cuda_distance.topk_raw(x, y, y2, kk)))


def test_tpose_plain_passes_bench_gates_vs_pallas():
    # as test_plain_passes_bench_gates_vs_pallas, against the JAX package's
    # transposed-operand kernel (_tpose_tag_kernel) in interpret mode
    rng = np.random.default_rng(13)
    m, n, k = 256, 2048, 5
    y = rng.random((n, 9), dtype=np.float32)
    x = rng.random((m, 9), dtype=np.float32)
    labels = (y[:, 0] > 0.5).astype(np.int64)
    pd, pi = pairwise_topk_pallas(jnp.asarray(x), jnp.asarray(y), k=k,
                                  interpret=True, tile_m=128, tile_n=512,
                                  mode="exact", layout="tpose")
    before = cuda_distance.topk_raw_tpose.launches
    td_, ti = cuda_distance.pairwise_topk_cuda(
        torch.from_numpy(x), torch.from_numpy(y), k=k, layout="tpose")
    assert cuda_distance.topk_raw_tpose.launches == before   # CPU: plain
    pd, pi, td_, ti = map(np.asarray, (pd, pi, td_, ti))
    recall, err, agree = _gates(pi, pd, ti, td_, labels)
    assert recall >= 0.985 and err <= 25 and agree >= 0.99, (recall, err,
                                                             agree)


def test_unknown_layout_and_cuda_only_launch_raise():
    x = torch.rand(8, 9)
    with pytest.raises(ValueError, match="layout"):
        cuda_distance.pairwise_topk_cuda(x, x, k=2, layout="lanes")
    # a tensor that is not on the CPU takes the launch branch, which takes
    # CUDA tensors only: no fallback to the plain version
    meta = torch.empty((9, 8), device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_distance.topk_raw_tpose(meta, meta, torch.empty(8,
                                                             device="meta"),
                                     2)
