"""K6-K9's plain versions against the fold kernels of scripts/exp_fold.py
and scripts/roofline_knn.py, each run in interpret mode inside the
pallas_call its launcher builds; and the wrappers' rules."""

import numpy as np
import pytest
import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops import fold as F
from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import exp_fold, roofline_knn

from _torch_fold_ref import assert_fold_close, fold_metric64, jax_fold

torch.set_num_threads(2)


def _inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    return (rng.random((m, d), dtype=np.float32),
            rng.random((n, d), dtype=np.float32))


def _port(variant, x, y, **kw):
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    y2 = row_sq_norm(ty)
    if variant == "acc":
        return cuda_fold.acc_fold(tx, ty, y2, **kw)
    if variant == "dotmin":
        return cuda_fold.dotmin(tx, ty, y2)
    if variant == "nodot":
        kw.pop("use_bf16", None)
        return cuda_fold.nodot_fold(tx, y2, **kw)
    kw.pop("use_bf16", None)
    return cuda_fold.tpose_fold(tx.T.contiguous(), ty.T.contiguous(), y2,
                                **kw)


# (d, n_acc, tile_n, n, k, use_bf16): n a multiple of tile_n, ragged, and
# below the bucket count
ACC_CASES = [
    (9, 4, 4096, 8192, 5, True),
    (9, 2, 4096, 5000, 5, True),
    (25, 8, 4096, 9000, 1, False),
    (9, 4, 6144, 1000, 128, True),
    (25, 2, 6144, 300, 5, False),
    (9, 8, 4096, 700, 128, False),
]


@pytest.mark.parametrize("d,n_acc,tile_n,n,k,use_bf16", ACC_CASES)
def test_acc_fold_plain_vs_interpret_kernel(d, n_acc, tile_n, n, k,
                                            use_bf16):
    x, y = _inputs(d + n, 40, n, d)
    kw = dict(k=k, tile_n=tile_n, n_acc=n_acc, use_bf16=use_bf16)
    want = jax_fold("acc", x, y, **kw)
    before = cuda_fold.acc_fold.launches
    got = _port("acc", x, y, **kw)
    assert cuda_fold.acc_fold.launches == before      # CPU: plain version
    assert got[0].shape == got[1].shape == (40, 128)
    assert_fold_close(got, want, fold_metric64("acc", x, y, use_bf16))
    # the (BIG, -1) slots: past k, and past the buckets that hold a column
    filled = min(k, n)
    assert (got[1][:, :filled] >= 0).all()
    assert (got[1][:, filled:] == -1).all()
    assert (got[0][:, filled:] == F.BIG).all()


@pytest.mark.parametrize("variant,d,n_acc,tile_n,n,k", [
    ("nodot", 9, 4, 4096, 8192, 5),
    ("nodot", 25, 2, 512, 100, 128),
    ("tpose", 9, 4, 4096, 5000, 5),
    ("tpose", 25, 8, 1024, 700, 128),
    ("tpose", 9, 2, 512, 300, 1),
])
def test_indexed_fold_plain_vs_interpret_kernel(variant, d, n_acc, tile_n,
                                                n, k):
    x, y = _inputs(d + n + 1, 40, n, d)
    kw = dict(k=k, tile_n=tile_n, n_acc=n_acc)
    want = jax_fold(variant, x, y, **kw)
    got = _port(variant, x, y, **kw)
    assert_fold_close(got, want, fold_metric64(variant, x, y))
    assert (got[1][:, min(k, n):] == -1).all()


@pytest.mark.parametrize("d,n,tile_n", [(9, 8192, 4096), (25, 300, 512),
                                        (9, 1000, 512)])
def test_dotmin_plain_vs_interpret_kernel(d, n, tile_n):
    x, y = _inputs(d + n + 2, 40, n, d)
    want = jax_fold("dotmin", x, y, tile_n=tile_n)
    got = _port("dotmin", x, y).numpy()
    empty = want == F.BIG            # lanes no column falls in (n < 128)
    assert np.array_equal(got == F.BIG, empty)
    assert np.abs(got[~empty] - want[~empty]).max() <= 1e-5


def test_bf16_rounding_is_real_on_the_reference():
    """The interpret kernel rounds its operands (the TPU elided the cast):
    its metrics are the rounded operands' product, off the f32 product."""
    x, y = _inputs(3, 32, 4096, 9)
    want_d, want_i = jax_fold("acc", x, y, k=5, tile_n=4096, n_acc=4)
    rows = np.arange(32)[:, None]
    rounded = fold_metric64("acc", x, y, use_bf16=True)[rows, want_i[:, :5]]
    exact = fold_metric64("acc", x, y, use_bf16=False)[rows, want_i[:, :5]]
    assert np.abs(want_d[:, :5] - rounded).max() <= 1e-5
    assert np.abs(want_d[:, :5] - exact).max() > 1e-3


def test_tile_rule_and_ranges_raise():
    x = torch.rand(8, 9)
    y2 = torch.rand(600)
    with pytest.raises(ValueError, match="multiple of n_acc"):
        F.acc_fold_plain(x, torch.rand(600, 9), y2, k=5, n_acc=4,
                         tile_n=4096 + 128)
    with pytest.raises(ValueError, match="n_acc"):
        F.nodot_fold_plain(x, y2, k=5, n_acc=3, tile_n=3 * 128)
    with pytest.raises(ValueError, match="k must be"):
        F.extract_k(torch.zeros(2, 256), torch.zeros(2, 256,
                                                     dtype=torch.int32), 129)
    # the wrappers check the rule before they look at the device
    meta = torch.empty((8, 9), device="meta")
    with pytest.raises(ValueError, match="multiple of n_acc"):
        cuda_fold.tpose_fold(meta, meta, torch.empty(9, device="meta"), k=5,
                             tile_n=1000)


def test_cuda_tensors_launch_or_raise_and_no_silent_cpu():
    """A tensor off the CPU takes the launch branch, which takes CUDA
    tensors only; the harness entry points run on CUDA by default."""
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.acc_fold(meta(8, 9), meta(600, 9), meta(600), k=5)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.dotmin(meta(8, 9), meta(600, 9), meta(600))
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.nodot_fold(meta(8, 9), meta(600), k=5)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x, y = _inputs(4, 8, 600, 9)
    with pytest.raises(RuntimeError, match="device cpu"):
        exp_fold.acc_topk(x, y, k=5)
    with pytest.raises(RuntimeError, match="device cpu"):
        roofline_knn.main(["--m", "8", "--n", "600"])
    d, i = exp_fold.acc_topk(x, y, k=5, device="cpu")
    assert d.shape == i.shape == (8, 5) and (i >= 0).all()
