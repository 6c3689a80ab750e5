"""K10 on the tensor-core body's raw mode (``csrc/fold.cu``, namespace
``tc``, ``kRaw``): the raw operands of ``cuda_fold.tc_operands`` give the
raw product and keep pad columns above BIG, row-major and feature-major;
the tile emulated in torch in the kernel's fragment order holds against the
plain version under ``chip_smoke.compare_fold``'s rule (exactly on integer
operands); the launch arguments with the library faked; and the wrapper
never falls back. The kernel itself runs only on the card
(``chip_smoke.py``); the JAX-against-port parity of K10's sweep arms is in
``test_torch_sweeps.py``."""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avenir_tpu_torch.ops import _build, cuda_fold
from avenir_tpu_torch.ops import fold as F

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "avenir_tpu_torch" / "csrc" / "fold.cu"

#: value c (0..15) of a k-step of lane (g, tig)'s B fragment sits at value
#: B_VALUE[c] of its packed row's k-step: logical word c // 2 lies at the
#: position TC_WORD_ORDER gives it, two values a word
B_VALUE = [2 * cuda_fold.TC_WORD_ORDER.index(c // 2) + c % 2
           for c in range(16)]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _operands(seed, m, n, w, ints=False):
    """x [m, w], y [n, w]: signed floats, or augmented small integers ([x |
    1] against [-2y | |y|²], x and y in [0, 4), y's rows drawn from an
    eighth as many) whose products and sums are exact in any order."""
    rng = np.random.default_rng(seed)
    if not ints:
        return (torch.from_numpy(rng.uniform(-1, 1, (m, w)).astype(np.float32)),
                torch.from_numpy(rng.uniform(-1, 1, (n, w)).astype(np.float32)))
    x = rng.integers(0, 4, (m, w - 1)).astype(np.float32)
    y = rng.integers(0, 4, (max(1, n // 8), w - 1)).astype(np.float32)
    y = y[rng.integers(0, y.shape[0], n)]
    xa = np.concatenate([x, np.ones((m, 1), np.float32)], 1)
    ya = np.concatenate([-2 * y, (y * y).sum(1, keepdims=True)], 1)
    return torch.from_numpy(xa), torch.from_numpy(ya)


def _layout(t, tpose):
    return t.T.contiguous() if tpose else t


# --------------------------------------------------------------------------
# (a) the raw operands
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tpose", [False, True])
@pytest.mark.parametrize("w", [1, 10, 11, 13, 14, 29, 48])
def test_raw_operands_product_is_the_raw_metric(w, tpose):
    """A·Yᵀ summed in float64 is Σ_c bf16(x)·bf16(y) on real columns, and
    above BIG on pad columns; every value is a bf16 value, the y2 parts of
    real rows are 0; K6's operands of the same x and y differ only in A's
    scale and the y2 parts."""
    m, n, buckets = 33, 300, 256
    x, y = _operands(w * 7 + int(tpose), m, n, w)
    x, y = x * 3.0, y * 5.0
    a, yp = cuda_fold.tc_operands(_layout(x, tpose), _layout(y, tpose), None,
                                  buckets, tpose=tpose)
    width = cuda_fold.tc_width(w)
    assert a.shape == (m, width)
    assert yp.shape == (cuda_fold.tc_padded_rows(n, w, buckets), width)
    for t in (a, yp):
        assert torch.equal(t, t.to(torch.bfloat16).to(torch.float32))
    assert not yp[:n, w:].any()
    assert torch.equal(a[:, w:w + 3], torch.ones((m, 3)))
    metric = a.double() @ yp.double().T
    want = F.round_bf16(x).double() @ F.round_bf16(y).double().T
    assert torch.equal(metric[:, :n], want)
    assert (metric[:, n:] > F.BIG).all()
    a6, yp6 = cuda_fold.tc_operands(x, y, (y * y).sum(1), buckets)
    assert torch.equal(a6[:, :w], -2.0 * a[:, :w])
    assert torch.equal(a6[:, w:], a[:, w:])
    assert torch.equal(yp6[:, :w], yp[:, :w]) and torch.equal(yp6[n:],
                                                              yp[n:])


@pytest.mark.parametrize("w", [10, 11, 14])
def test_raw_packed_rows_of_both_layouts_are_one(w):
    """The feature-major operands read through their strides pack to the
    row-major ones' rows bit for bit, in the kernel's word order."""
    x, y = _operands(w, 9, 700, w)
    rows = cuda_fold.tc_operands(x, y, None, 512)
    feat = cuda_fold.tc_operands(x.T.contiguous(), y.T.contiguous(), None,
                                 512, tpose=True)
    assert all(torch.equal(p, q) for p, q in zip(rows, feat))
    packed = cuda_fold.tc_packed(feat[1])
    assert torch.equal(cuda_fold.tc_packed(rows[1]).view(torch.int16),
                       packed.view(torch.int16))
    logical = feat[1].to(torch.bfloat16)
    for q in range(cuda_fold.tc_steps(w)):
        got = packed[:, 16 * q:16 * q + 16][:, B_VALUE]
        assert torch.equal(got.view(torch.int16),
                           logical[:, 16 * q:16 * q + 16].view(torch.int16))


# --------------------------------------------------------------------------
# (b) the tile in the kernel's order
# --------------------------------------------------------------------------

def _raw_tile(x, y, k, n_acc, tpose=False, pad=True):
    """K10 on the tensor-core tile in plain torch, in the kernel's order: A
    and the packed rows of ``tc_operands``' raw mode, the B operand read
    back from ``tc_packed``'s layout through the fragment map; step t
    brings columns t·B + b over the sweep's whole rounds; a pair's metric
    is its float64 sum rounded once to f32 (the tensor cores sum in their
    own order, exact products); each (row, bucket) pair keeps the first
    step at which it is strictly below its best, BIG at first; then the
    column t·B + b, or -1, and the k rounds. ``pad=False`` zeroes the pad
    rows' value."""
    xs, ys = _layout(x, tpose), _layout(y, tpose)
    m, w = x.shape
    n, buckets = y.shape[0], n_acc * F.LANES
    a, rows = cuda_fold.tc_operands(xs, ys, None, buckets, tpose=tpose)
    if not pad:
        rows[n:] = 0.0
    packed = cuda_fold.tc_packed(rows).to(torch.float64)
    idx = [16 * q + v for q in range(cuda_fold.tc_steps(w)) for v in B_VALUE]
    yb = packed[:, idx]
    a = a.double()
    best = torch.full((m, buckets), F.BIG)
    step = torch.full((m, buckets), -1, dtype=torch.int32)
    for t in range(cuda_fold.tc_sweep_steps(n, w, buckets)):
        v = (a @ yb[t * buckets:(t + 1) * buckets].T).float()
        better = v < best
        best = torch.where(better, v, best)
        step = torch.where(better, torch.tensor(t, dtype=torch.int32), step)
    cols = torch.where(step >= 0, step * buckets
                       + torch.arange(buckets, dtype=torch.int32), -1)
    return F.extract_k(best, cols.to(torch.int32), k)


@pytest.fixture(scope="module")
def compare_fold():
    return _smoke().compare_fold


@pytest.mark.parametrize("m,n,w,n_acc,k,ints,tpose", [
    (40, 300, 11, 4, 5, False, False),      # N below B
    (33, 50, 10, 1, 1, False, True),        # N below one slice of 64
    (20, 3 * 256 + 1, 11, 2, 128, False, False),   # one past a round
    (20, 2 * 1024 + 1, 14, 8, 5, False, True),     # two k-steps, rounds of 2
    (25, 1000, 48, 4, 128, False, False),   # four k-steps
    (30, 5000, 10, 8, 5, True, False),      # exact ties
    (30, 5000, 11, 1, 128, True, True),
])
def test_raw_tile_holds_against_the_plain_version(compare_fold, m, n, w,
                                                  n_acc, k, ints, tpose):
    x, y = _operands(m * n + w, m, n, w, ints)
    got = _raw_tile(x, y, k, n_acc, tpose)
    kw = dict(k=k, n_acc=n_acc, tile_n=max(4096, n_acc * F.LANES))
    want = F.raw_fold_plain(_layout(x, tpose), _layout(y, tpose),
                            tpose=tpose, **kw)
    xr, yr = F.round_bf16(x), F.round_bf16(y)

    def metric(ids):
        return (yr[ids.long()] * xr.unsqueeze(1)).sum(-1)
    c = compare_fold("K10 tile", got, want, metric,
                     xr.abs().sum(1) * yr.abs().max())
    assert (got[1] < n).all() and ((got[1] >= 0).sum(1) == min(k, n)).all()
    if ints:    # every metric exact: position by position
        assert c["differ"] == 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_acc,n", [(4, 300), (1, 3 * 128 + 1)])
def test_raw_tile_pad_columns_never_win(n_acc, n):
    """On positive operands with buckets that no real column fills, the
    pad rows' value keeps every pad column out; zeroed, a pad column's
    metric 0 beats every real one and shows as a column past N."""
    x, y = _operands(n, 12, n, 11)
    x, y = x.abs(), y.abs()
    got = _raw_tile(x, y, 5, n_acc)
    assert (got[1] < n).all()
    want = F.raw_fold_plain(x, y, k=5, n_acc=n_acc)
    assert torch.equal(got[1], want[1])
    bad = _raw_tile(x, y, 5, n_acc, pad=False)
    assert (bad[1][:, :5] >= n).all() and (bad[0][:, :5] == 0).all()


# --------------------------------------------------------------------------
# (c) the launch, the library faked
# --------------------------------------------------------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def avt_fold_raw(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_fold.raw_fold, "launches", 0)
    return lib


@pytest.mark.parametrize("tpose", [False, True])
@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
def test_k10_launch_arguments(fake_lib, body, tpose):
    """K10's launch on the host side: the body's code, the strides of the
    layout (row-major (W, 1), feature-major (1, rows)), and on the tensor
    cores the packed rows and scratch of ``tc_plan``; the count is left to
    the wrapper."""
    m, n, w, k, n_acc = 200, 700, 11, 5, 8
    x, y = torch.rand(m, w), torch.rand(n, w)
    out_d, out_i, scratch = cuda_fold._launch_raw(
        _layout(x, tpose), _layout(y, tpose), k, n_acc, tpose, body,
        torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    (args,) = fake_lib.calls
    assert args[2:9] == (m, n, w, k, n_acc, int(tpose),
                         cuda_fold.BODIES[body])
    assert args[9:13] == ((1, m, 1, n) if tpose else (w, 1, w, 1))
    if body == "cuda_cores":
        assert scratch == () and args[13:16] == (None, None, None)
    else:
        plan = cuda_fold.tc_plan(m, n, w, n_acc * 128)
        assert scratch[0].shape == (plan.n_pad, plan.width)
        assert scratch[0].dtype == torch.bfloat16
        assert [(t.shape, t.dtype) for t in scratch[1:]] == [
            (plan.scratch, torch.float32), (plan.scratch, torch.int32)]
        assert args[13:16] == tuple(t.data_ptr() for t in scratch)
    assert args[16:18] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.raw_fold.launches == 0


def test_k10_launch_refuses_what_it_does_not_take(fake_lib):
    x, y = torch.rand(8, 11), torch.rand(600, 11)
    with pytest.raises(ValueError, match="K10 runs on"):
        cuda_fold._launch_raw(x, y, 5, 4, False, "tile", torch.device("cpu"))
    with pytest.raises(ValueError, match="width"):
        cuda_fold._launch_raw(torch.rand(8, 49), torch.rand(600, 49), 5, 4,
                              False, "tensor", torch.device("cpu"))
    with pytest.raises(ValueError, match=r"\[W, M\] and \[W, N\]"):
        cuda_fold._launch_raw(x, y, 5, 4, True, "tensor", torch.device("cpu"))
    assert fake_lib.calls == []


def test_raw_fold_launches_the_tensor_cores(monkeypatch):
    """A CUDA tensor takes the tensor-core body in both layouts at every
    n_acc, bf16 operands widened first; one launch counted each."""
    calls = []

    def launch(x, y, k, n_acc, tpose, body, dev):
        calls.append((x.dtype, n_acc, tpose, body))
        return torch.empty(8, 128), torch.empty(8, 128), ()
    monkeypatch.setattr(cuda_fold, "_launch_raw", launch)
    monkeypatch.setattr(cuda_fold, "_check_operands",
                        lambda **t: torch.device("meta"))
    monkeypatch.setattr(cuda_fold.raw_fold, "launches", 0)

    def meta(*s):
        return torch.empty(s, device="meta", dtype=torch.bfloat16)
    for n_acc in F.N_ACC_CHOICES:
        cuda_fold.raw_fold(meta(8, 11), meta(600, 11), k=5, n_acc=n_acc)
        cuda_fold.raw_fold(meta(11, 8), meta(11, 600), k=5, n_acc=n_acc,
                           tpose=True)
    assert calls == [(torch.float32, a, t, "tensor")
                     for a in F.N_ACC_CHOICES for t in (False, True)]
    assert cuda_fold.raw_fold.launches == 8


def test_raw_mode_mirrors_the_kernel_source():
    """The raw mode is a compile-time flag of the pack and the sweep: A
    carries bf16(x), the pack reads no y2, K10's entry runs the raw
    instantiations through the caller's strides, refuses the sizes the
    body does not take, and keeps the CUDA-core body to its layout's
    strides."""
    src = SRC.read_text()
    assert "(kRaw ? 1.f : -2.f) * x[ax.at(r, cu)]" in src
    assert "if (!kRaw && j < n) {" in src
    assert "template <bool kIndexed, int kSteps, bool kRaw>" in src
    entry = src[src.index("int avt_fold_raw("):]
    assert "tc::fold_acc<true>(" in entry
    assert "tc::Strides{x_row, x_feat}" in entry
    assert "tc::Strides{y_row, y_feat}, nullptr" in entry
    assert "!tc_sizes_ok(m, n, d, k, n_acc)" in entry
    assert re.search(r"launch_indexed<true, true, false>", entry)
    assert re.search(r"launch_indexed<false, true, false>", entry)
    # K6 and K9 keep the mode off, K7 the pack's and the sweep's
    assert src.count("tc::fold_acc<false>(") == 2
    assert "pack<false>(" in src and "sweep_any<false, false>(" in src
    assert len(_build._SIGNATURES["avt_fold_raw"][0]) == entry[
        :entry.index(")")].count(",") + 1


# --------------------------------------------------------------------------
# (d) no silent CPU
# --------------------------------------------------------------------------

def test_raw_fold_takes_the_plain_version_only_on_the_cpu():
    """CPU tensors give the plain version, uncounted; a tensor off the CPU
    launches or raises, in both layouts and both types, and never falls
    back."""
    x, y = _operands(3, 16, 500, 11)
    before = cuda_fold.raw_fold.launches
    for tpose in (False, True):
        got = cuda_fold.raw_fold(_layout(x, tpose), _layout(y, tpose), k=5,
                                 tpose=tpose)
        want = F.raw_fold_plain(x, y, k=5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_fold.raw_fold.launches == before
    for dtype in (torch.float32, torch.bfloat16):
        for tpose in (False, True):
            shapes = ((11, 8), (11, 600)) if tpose else ((8, 11), (600, 11))
            xm, ym = (torch.empty(s, device="meta", dtype=dtype)
                      for s in shapes)
            with pytest.raises(ValueError, match="expected CUDA"):
                cuda_fold.raw_fold(xm, ym, k=5, tpose=tpose)
    assert cuda_fold.raw_fold.launches == before
