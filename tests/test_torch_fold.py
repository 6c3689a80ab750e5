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


# --------------------------------------------------------------------------
# The tensor-core body of K6 (bf16 on) and K7: its planner, its operands
# and its launch arguments (the kernels run only on the card)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d,buckets,want", [
    # (grid, n_pad, width): rounds of three steps at one k-step and two
    # ahead; rounds of two and one ahead at more
    (8192, 65536, 9, 512, ((64, 8), (129 + 2) * 512, 16)),
    (1000, 5000, 13, 128, ((8, 2), (42 + 2) * 128, 16)),
    (1000, 5000, 14, 1024, ((8, 16), (6 + 1) * 1024, 32)),
    (300, 50, 30, 256, ((3, 4), (2 + 1) * 256, 48)),
    (129, 1, 48, 128, ((2, 2), (2 + 1) * 128, 64)),
    (2051, 16383, 9, 512, ((17, 8), (33 + 2) * 512, 16)),
])
def test_tc_plan_shapes(m, n, d, buckets, want):
    plan = cuda_fold.tc_plan(m, n, d, buckets)
    assert (plan.grid, plan.n_pad, plan.width) == want
    assert plan.buckets == buckets and plan.scratch == (m, buckets)
    if buckets == cuda_fold.TC_DOTMIN_BUCKETS:     # K7: no scratch
        k7 = cuda_fold.tc_plan(m, n, d, buckets, indexed=False)
        assert k7.scratch is None and k7[:4] == plan[:4]
    # every row tile and bucket slice is covered, whole steps of columns
    assert plan.grid[0] * cuda_fold.TC_ROWS >= m > (
        plan.grid[0] - 1) * cuda_fold.TC_ROWS
    assert plan.grid[1] * cuda_fold.TC_SLICE == buckets
    steps = cuda_fold.tc_sweep_steps(n, d, buckets)
    ahead = cuda_fold.tc_ahead(d)
    assert steps % (ahead + 1) == 0 and steps * buckets >= n
    assert (steps - ahead - 1) * buckets < n
    assert plan.n_pad == (steps + ahead) * buckets
    assert plan.width >= d + 3 and plan.width % 16 == 0


def test_tc_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_fold.tc_plan(8, 600, 9, 96)
    with pytest.raises(ValueError, match="at least 128"):
        cuda_fold.tc_plan(8, 600, 9, 64)
    with pytest.raises(ValueError, match="width"):
        cuda_fold.tc_plan(8, 600, 49, 512)
    with pytest.raises(ValueError, match="no rows"):
        cuda_fold.tc_plan(0, 600, 9, 512)
    with pytest.raises(ValueError, match="K7 folds 512"):
        cuda_fold.tc_plan(8, 600, 9, 128, indexed=False)


def test_tc_steps_boundaries():
    """d features and y2's three parts in k-steps of 16."""
    assert [cuda_fold.tc_steps(d) for d in (1, 13, 14, 29, 30, 45, 46, 48)] \
        == [1, 1, 2, 2, 3, 3, 4, 4]


@pytest.mark.parametrize("use_bf16,body", [(True, "tensor"),
                                           (False, "cuda_cores")])
def test_acc_fold_launches_the_body_of_its_operands(monkeypatch, use_bf16,
                                                    body):
    """A CUDA tensor takes the tensor cores with bf16 rounding and the
    CUDA cores without, at every n_acc; one launch counted each."""
    calls = []

    def launch(x, y, y2, k, n_acc, bf16, chosen, dev):
        calls.append((n_acc, bf16, chosen))
        return torch.empty(8, 128), torch.empty(8, 128), ()
    monkeypatch.setattr(cuda_fold, "_launch_acc", launch)
    monkeypatch.setattr(cuda_fold, "_check_operands",
                        lambda **t: torch.device("meta"))
    monkeypatch.setattr(cuda_fold.acc_fold, "launches", 0)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    for n_acc in (1, 2, 4, 8):
        cuda_fold.acc_fold(meta(8, 9), meta(600, 9), meta(600), k=5,
                           n_acc=n_acc, use_bf16=use_bf16)
    assert calls == [(a, use_bf16, body) for a in (1, 2, 4, 8)]
    assert cuda_fold.acc_fold.launches == 4


def test_tc_planner_mirrors_the_kernel_constants():
    """The planner and the operands mirror ``csrc/fold.cu``'s tile, pad
    value and packed word order."""
    import re
    from pathlib import Path
    src = (Path(cuda_fold.__file__).resolve().parent.parent / "csrc"
           / "fold.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+(?: \w+)? {name} = (\w+);",
                             src).group(1), 0)
    assert const("kWarpRows") * const("kWarpsR") == cuda_fold.TC_ROWS
    assert const("kWarpCols") * const("kWarpsC") == cuda_fold.TC_SLICE
    assert const("kPadY2") == cuda_fold.TC_PAD_Y2
    assert const("kDotminBuckets") == cuda_fold.TC_DOTMIN_BUCKETS
    assert "kDotminBuckets == 4 * kLanes" in src
    stores = re.findall(r"make_uint4\(w\[(\d)\], w\[(\d)\], w\[(\d)\], "
                        r"w\[(\d)\]\)", src)
    assert tuple(int(i) for s in stores for i in s) == \
        cuda_fold.TC_WORD_ORDER
    assert "(d + 3 + 15) / 16" in src
    assert "return kSteps == 1 ? 2 : 1;" in src       # tc_ahead
    # K8's tile runs tc_ahead(d) steps ahead, so that tc_padded_rows sizes
    # its y2p as it sizes K6's packed rows
    assert "if (steps_ahead(ksteps(d)) == 2) {" in src
    assert "tc_nodot_kernel<2>" in src and "tc_nodot_kernel<1>" in src
    # tc_strides: element (i, c) at i·row + c·feature; K6 and K7 row-major,
    # K9's CUDA-core body feature-major only, K10's that of its layout
    assert "static_cast<size_t>(i) * row + static_cast<size_t>(c) * feat" \
        in src
    assert src.count("tc::Strides{d, 1}") == 2
    assert "const Strides rows{d, 1};" in src
    assert cuda_fold.tc_strides(7, 9, False) == (9, 1)
    assert "x_row != 1 || x_feat != m || y_row != 1 || y_feat != n" in src
    assert cuda_fold.tc_strides(7, 9, True) == (1, 7)
    assert ("tpose ? x_row == 1 && x_feat == m && y_row == 1 && y_feat == n"
            "\n              : x_row == d && x_feat == 1 && y_row == d && "
            "y_feat == 1;") in src
    # the C entries' body codes: K6, K8, K9 and K10 keep the CUDA-core body
    assert cuda_fold.BODIES == {"cuda_cores": 0, "tensor": 1, "tile": 1}
    assert src.count("if (body == 0) {") == 4


@pytest.mark.parametrize("d,n", [(1, 300), (9, 1000), (13, 129), (14, 700),
                                 (30, 64), (48, 200)])
def test_tc_operands_product_is_the_metric(d, n):
    """A·Yᵀ summed exactly is y2 − 2·bf16(x)·bf16(y): the y2 parts are exact
    bf16 values summing to y2, and a pad column's metric lies above BIG."""
    x, y = _inputs(d + n + 7, 33, n, d)
    tx, ty = torch.from_numpy(x * 3.0), torch.from_numpy(y * 5.0)
    y2 = row_sq_norm(ty)
    a, yp = cuda_fold.tc_operands(tx, ty, y2, 256)
    assert a.shape == (33, cuda_fold.tc_width(d))
    assert yp.shape == (cuda_fold.tc_padded_rows(n, d, 256),
                        cuda_fold.tc_width(d))
    for t in (a, yp):     # every value is a bf16 value
        assert torch.equal(t, t.to(torch.bfloat16).to(torch.float32))
    parts = yp[:n, d:d + 3].double().sum(dim=1)
    assert torch.equal(parts, y2.double())
    metric = a.double() @ yp.double().T
    want = y2.double() - 2.0 * (F.round_bf16(tx).double()
                                @ F.round_bf16(ty).double().T)
    assert torch.allclose(metric[:, :n], want, rtol=1e-12, atol=1e-12)
    assert (metric[:, n:] > F.BIG).all()


def test_tc_packed_word_order():
    """Lane tig's B fragment, logical words tig and tig + 4 of a k-step,
    is one 8-byte pair of the packed layout."""
    rows = torch.arange(2 * 32, dtype=torch.float32).reshape(2, 32)
    packed = cuda_fold.tc_packed(rows)
    assert packed.shape == (2, 32) and packed.dtype == torch.bfloat16
    logical = rows.to(torch.bfloat16).view(torch.int32).reshape(2, 2, 8)
    words = packed.view(torch.int32).reshape(2, 2, 4, 2)
    for tig in range(4):
        assert torch.equal(words[:, :, tig, 0], logical[:, :, tig])
        assert torch.equal(words[:, :, tig, 1], logical[:, :, tig + 4])


class _FakeFoldLib:
    """Stands in for the kernels' library: records each K6/K7 launch."""

    def __init__(self):
        self.calls = []

    def avt_fold_acc(self, *args):
        self.calls.append(("acc", args))
        return 0

    def avt_fold_dotmin(self, *args):
        self.calls.append(("dotmin", args))
        return 0

    def avt_fold_nodot(self, *args):
        self.calls.append(("nodot", args))
        return 0

    def avt_fold_tpose(self, *args):
        self.calls.append(("tpose", args))
        return 0


@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
def test_k6_launch_arguments(monkeypatch, body):
    """K6's launch on the host side, the library faked: the body's code,
    the packed rows and the scratch its plan asks for; the count is left
    to the wrapper."""
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeFoldLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_fold.acc_fold, "launches", 0)
    m, n, d, k, n_acc = 300, 1000, 9, 5, 4
    x, y = (torch.rand(m, d), torch.rand(n, d))
    y2 = row_sq_norm(y)
    out_d, out_i, scratch = cuda_fold._launch_acc(
        x, y, y2, k, n_acc, True, body, torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    ((kind, args),) = lib.calls
    assert kind == "acc"
    assert args[3:10] == (m, n, d, k, n_acc, 1, cuda_fold.BODIES[body])
    if body == "cuda_cores":
        assert scratch == () and args[10:13] == (None, None, None)
    else:
        plan = cuda_fold.tc_plan(m, n, d, n_acc * 128)
        assert scratch[0].shape == (plan.n_pad, plan.width)
        assert scratch[0].dtype == torch.bfloat16
        assert [(t.shape, t.dtype) for t in scratch[1:]] == [
            (plan.scratch, torch.float32), (plan.scratch, torch.int32)]
        assert args[10:13] == tuple(t.data_ptr() for t in scratch)
    assert args[13:15] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.acc_fold.launches == 0


@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
def test_k7_launch_arguments(monkeypatch, body):
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeFoldLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_fold.dotmin, "launches", 0)
    m, n, d = 200, 700, 17
    x, y = torch.rand(m, d), torch.rand(n, d)
    out_d, scratch = cuda_fold._launch_dotmin(
        x, y, row_sq_norm(y), body, torch.device("cpu"))
    ((kind, args),) = lib.calls
    assert kind == "dotmin" and out_d.shape == (m, 128)
    assert args[3:7] == (m, n, d, cuda_fold.BODIES[body])
    if body == "cuda_cores":
        assert scratch == () and args[7] is None
    else:
        buckets = cuda_fold.TC_DOTMIN_BUCKETS
        (packed,) = scratch
        assert packed.shape == (cuda_fold.tc_padded_rows(n, d, buckets),
                                cuda_fold.tc_width(d))
        assert args[7] == packed.data_ptr()
    assert args[8] == out_d.data_ptr()
    assert cuda_fold.dotmin.launches == 0


@pytest.mark.parametrize("body", ["cuda_cores", "tile"])
def test_k8_launch_arguments(monkeypatch, body):
    """K8's launch with the library faked: the body's code; on the tile,
    y2 padded with +inf to the plan's rows (the sweep tests no bound) and
    K6's scratch; the count is left to the wrapper."""
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeFoldLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_fold.nodot_fold, "launches", 0)
    m, n, d, k, n_acc = 300, 1000, 9, 5, 2
    x, y2 = torch.rand(m, d), torch.rand(n)
    out_d, out_i, scratch = cuda_fold._launch_nodot(
        x, y2, k, n_acc, body, torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    ((kind, args),) = lib.calls
    assert kind == "nodot"
    assert args[2:8] == (m, n, d, k, n_acc, cuda_fold.BODIES[body])
    if body == "cuda_cores":
        assert scratch == () and args[8:11] == (None, None, None)
    else:
        plan = cuda_fold.tc_plan(m, n, d, n_acc * 128)
        y2p, vals, cols = scratch
        assert y2p.shape == (cuda_fold.tc_padded_rows(n, d, n_acc * 128),)
        assert plan.n_pad == y2p.shape[0] > n
        assert torch.equal(y2p[:n], y2)
        assert (y2p[n:] == float("inf")).all()
        assert [(t.shape, t.dtype) for t in (vals, cols)] == [
            (plan.scratch, torch.float32), (plan.scratch, torch.int32)]
        assert args[8:11] == tuple(t.data_ptr() for t in scratch)
    assert args[11:13] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.nodot_fold.launches == 0
    with pytest.raises(ValueError, match="K8 runs on"):
        cuda_fold._launch_nodot(x, y2, k, n_acc, "tensor",
                                torch.device("cpu"))


@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
def test_k9_launch_arguments(monkeypatch, body):
    """K9's launch with the library faked: the body's code, the strides of
    feature-major operands, and on the tensor cores K6's packed rows and
    scratch from the plan."""
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeFoldLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_fold.tpose_fold, "launches", 0)
    m, n, d, k, n_acc = 200, 700, 17, 5, 8
    xt, yt = torch.rand(d, m), torch.rand(d, n)
    out_d, out_i, scratch = cuda_fold._launch_tpose(
        xt, yt, row_sq_norm(yt.T), k, n_acc, body, torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    ((kind, args),) = lib.calls
    assert kind == "tpose"
    assert args[3:9] == (m, n, d, k, n_acc, cuda_fold.BODIES[body])
    assert args[9:13] == (1, m, 1, n)         # (row, feature) of xt, yt
    if body == "cuda_cores":
        assert scratch == () and args[13:16] == (None, None, None)
    else:
        plan = cuda_fold.tc_plan(m, n, d, n_acc * 128)
        assert scratch[0].shape == (plan.n_pad, plan.width)
        assert scratch[0].dtype == torch.bfloat16
        assert [(t.shape, t.dtype) for t in scratch[1:]] == [
            (plan.scratch, torch.float32), (plan.scratch, torch.int32)]
        assert args[13:16] == tuple(t.data_ptr() for t in scratch)
    assert args[16:18] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.tpose_fold.launches == 0


def test_nodot_and_tpose_folds_launch_their_new_bodies(monkeypatch):
    """A CUDA tensor takes K8's tile and K9's tensor cores at every n_acc;
    one launch counted each."""
    calls = []

    def launch(name):
        def run(*args):
            calls.append((name, args[-3], args[-2]))     # n_acc, body
            return torch.empty(8, 128), torch.empty(8, 128), ()
        return run
    monkeypatch.setattr(cuda_fold, "_launch_nodot", launch("K8"))
    monkeypatch.setattr(cuda_fold, "_launch_tpose", launch("K9"))
    monkeypatch.setattr(cuda_fold, "_check_operands",
                        lambda **t: torch.device("meta"))
    monkeypatch.setattr(cuda_fold.nodot_fold, "launches", 0)
    monkeypatch.setattr(cuda_fold.tpose_fold, "launches", 0)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    for n_acc in (1, 2, 4, 8):
        cuda_fold.nodot_fold(meta(8, 9), meta(600), k=5, n_acc=n_acc)
        cuda_fold.tpose_fold(meta(9, 8), meta(9, 600), meta(600), k=5,
                             n_acc=n_acc)
    assert calls == [c for a in (1, 2, 4, 8)
                     for c in (("K8", a, "tile"), ("K9", a, "tensor"))]
    assert cuda_fold.nodot_fold.launches == cuda_fold.tpose_fold.launches \
        == 4


def _k8_tile(x, y2, k, n_acc):
    """K8's tile in plain torch, in the kernel's order: y2 padded with +inf
    to ``tc_padded_rows`` entries; step t brings columns t·B + b; each
    (row, bucket) pair keeps the first step at which ``y2p[t·B + b] + s[r]``
    (s summed in feature order) is strictly below its best, BIG at first;
    then the column t·B + b, or -1, and the k rounds."""
    m, d = x.shape
    n, buckets = y2.shape[0], n_acc * 128
    s = torch.zeros(m)
    for c in range(d):
        s = s + x[:, c]
    y2p = torch.full((cuda_fold.tc_padded_rows(n, d, buckets),),
                     float("inf"))
    y2p[:n] = y2
    best = torch.full((m, buckets), F.BIG)
    step = torch.full((m, buckets), -1, dtype=torch.int32)
    for t in range(cuda_fold.tc_sweep_steps(n, d, buckets)):
        v = y2p[t * buckets:(t + 1) * buckets].reshape(1, -1) \
            + s.reshape(-1, 1)
        better = v < best
        best = torch.where(better, v, best)
        step = torch.where(better, torch.tensor(t, dtype=torch.int32), step)
    cols = torch.where(step >= 0, step * buckets
                       + torch.arange(buckets, dtype=torch.int32), -1)
    return F.extract_k(best, cols.to(torch.int32), k)


@pytest.mark.parametrize("m,n,d,n_acc,k,ints", [
    (40, 8192, 9, 4, 5, False),
    (33, 50, 9, 1, 5, False),          # N below one slice of 64 buckets
    (7, 300, 25, 2, 128, False),
    (100, 1000, 14, 8, 128, False),    # one step ahead (d + 3 > 16)
    (50, 3000, 9, 4, 5, True),         # integer features: exact ties
])
def test_k8_tile_order_equals_the_plain_version(m, n, d, n_acc, k, ints):
    rng = np.random.default_rng(m * n + d)
    if ints:
        x = torch.from_numpy(rng.integers(0, 4, (m, d)).astype(np.float32))
        y2 = torch.from_numpy(rng.integers(0, 40, n).astype(np.float32))
    else:
        x = torch.from_numpy(rng.random((m, d), dtype=np.float32))
        y2 = torch.from_numpy(rng.random(n, dtype=np.float32) * 9)
    got = _k8_tile(x, y2, k, n_acc)
    want = F.nodot_fold_plain(x, y2, k=k, n_acc=n_acc,
                              tile_n=max(4096, n_acc * 128))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,n,d", [(33, 300, 9), (5, 129, 14), (130, 64, 48)])
def test_tc_operands_of_feature_major_operands(m, n, d):
    """K9's operands read through their strides are K6's of the transposed
    ones, bit for bit."""
    x, y = _inputs(m + n + d, m, n, d)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    y2 = row_sq_norm(ty)
    for buckets in (128, 1024):
        rows = cuda_fold.tc_operands(tx, ty, y2, buckets)
        feat = cuda_fold.tc_operands(tx.T.contiguous(), ty.T.contiguous(),
                                     y2, buckets, tpose=True)
        assert all(torch.equal(a, b) for a, b in zip(rows, feat))
        assert torch.equal(cuda_fold.tc_packed(rows[1]).view(torch.int16),
                           cuda_fold.tc_packed(feat[1]).view(torch.int16))
