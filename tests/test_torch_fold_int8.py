"""K11 and K12 on the int8 tensor cores (``csrc/fold_int8.cu``, namespace
``tc``): the planner and the packed rows mirror the kernel, the tile
emulated in torch in the kernel's fragment order equals the plain versions
bit for bit, and the launch arguments with the library faked. The kernels
themselves run only on the card (``chip_smoke.py``)."""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avenir_tpu_torch.ops import _build, cuda_fold
from avenir_tpu_torch.ops import fold as F

torch.set_num_threads(2)

SRC = (Path(cuda_fold.__file__).resolve().parent.parent / "csrc"
       / "fold_int8.cu")

#: byte k (k = 0..31 of m16n8k32's contraction) of lane tig's B fragment
#: sits at byte B_BYTE[k] of its packed row: register 0 holds k = 4 tig ..
#: 4 tig + 3 (logical word tig), register 1 k = 16 + 4 tig .. 16 + 4 tig +
#: 3 (word tig + 4), and the two registers are the row's 8-byte pair tig
B_BYTE = [8 * (k % 16 // 4) + 4 * (k // 16) + k % 4 for k in range(32)]


def _operands(seed, m, n, w, hi=127, dup=False):
    """int8 xa [m, w], ya [n, w] in [-hi, hi]; with ``dup`` the train rows
    are drawn from n // 8 distinct ones, so that metrics tie."""
    rng = np.random.default_rng(seed)
    xa = rng.integers(-hi, hi + 1, (m, w)).astype(np.int8)
    ya = rng.integers(-hi, hi + 1, (n, w)).astype(np.int8)
    if dup:
        ya = ya[rng.integers(0, max(1, n // 8), n)]
    return torch.from_numpy(xa), torch.from_numpy(ya)


def _packed_hi(w):
    """The widest range [-hi, hi] that keeps K12's metrics below 2**18."""
    return min(127, math.isqrt((F.PACKED_METRIC_LIMIT - 1) // w))


def _int8_tile(xa, ya, y2, k, n_acc, packed=False, mask=True):
    """K11 (K12 with ``packed``) on the tensor-core tile, in plain torch in
    the kernel's order: the B operand gathered from ``int8_tc_packed``'s
    rows through the fragment map (the A fragments read the rows' bytes as
    they lie); step t brings columns t·B + b; the planner's open rounds run
    unmasked, the rest mask columns past n to INT_BIG (``mask=False``
    leaves the zero pad rows in); each (row, bucket) pair keeps the first
    step at which its int32 value is strictly below its best (K12: the
    minimum of cross·2048 + tag); then the decode and the k rounds."""
    (m, w), n = xa.shape, ya.shape[0]
    buckets, epi = n_acc * F.LANES, y2 is not None
    plan = cuda_fold.int8_tc_plan(m, n, w, buckets)
    yb = cuda_fold.int8_tc_packed(ya, plan.n_pad).to(torch.int64)[:, B_BYTE]
    a = torch.zeros((m, 32), dtype=torch.int64)
    a[:, :w] = xa
    y2p = torch.zeros(plan.n_pad, dtype=torch.int32)
    if epi:
        y2p[:n] = y2
    open_steps = (cuda_fold.int8_tc_open_rounds(n, buckets)
                  * (cuda_fold.INT8_TC_AHEAD + 1))
    bucket = torch.arange(buckets, dtype=torch.int32)
    big = torch.tensor(F.INT_BIG, dtype=torch.int32)
    best = torch.full((m, buckets), F.INT_BIG, dtype=torch.int32)
    step = torch.full((m, buckets), -1, dtype=torch.int32)
    for t in range(cuda_fold.int8_tc_sweep_steps(n, buckets)):
        cols = t * buckets + bucket
        cross = (a @ yb[t * buckets:(t + 1) * buckets].T).to(torch.int32)
        if epi:
            v = y2p[t * buckets:(t + 1) * buckets] - 2 * cross
        elif packed:
            v = cross * F.PACK + (cols >> 7)
        else:
            v = cross
        if t < open_steps:
            assert (cols < n).all()
        elif mask:
            v = torch.where(cols < n, v, big)
        if packed:
            best = torch.minimum(best, v)
        else:
            better = v < best
            best = torch.where(better, v, best)
            step = torch.where(better, torch.tensor(t, dtype=torch.int32),
                               step)
    if packed:
        found = best < F.INT_BIG
        col = torch.where(found, (best & (F.PACK - 1)) * F.LANES
                          + bucket % F.LANES, -1)
        best = torch.where(found, best >> 11, big)
    else:
        col = torch.where(step >= 0, step * buckets + bucket, -1)
    return F.extract_k(best, col.to(torch.int32), k, F.INT_BIG)


def _plain(xa, ya, y2, k, n_acc, packed=False):
    kw = dict(k=k, n_acc=n_acc, tile_n=max(4096, n_acc * F.LANES))
    if packed:
        return F.packed_fold_plain(xa, ya, **kw)
    return F.int8_fold_plain(xa, ya, y2, **kw)


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _y2(seed, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, n)
                            .astype(np.int32))


# --------------------------------------------------------------------------
# the planner and the packed rows
# --------------------------------------------------------------------------

def test_int8_tc_planner_mirrors_the_kernel_constants():
    """The planner and the packed rows mirror ``csrc/fold_int8.cu``'s tile,
    row width, word order, steps ahead and open rounds."""
    src = SRC.read_text()
    tc = src[src.index("namespace tc {"):]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", tc)
                   .group(1), 0)
    assert const("kWarpRows") * const("kWarpsR") == cuda_fold.TC_ROWS
    assert const("kWarpCols") * const("kWarpsC") == cuda_fold.TC_SLICE
    assert const("kRowBytes") == cuda_fold.INT8_TC_WIDTH \
        == cuda_fold.MAX_INT8_W
    stores = re.findall(r"make_uint4\(word\[(\d)\], word\[(\d)\], "
                        r"word\[(\d)\], word\[(\d)\]\)", tc)
    assert tuple(int(i) for s in stores for i in s) == \
        cuda_fold.TC_WORD_ORDER
    assert const("kAhead") == cuda_fold.INT8_TC_AHEAD
    assert "constexpr int kRound = kAhead + 1;" in tc
    assert "return (steps + kRound - 1) / kRound * kRound;" in tc
    assert "return (sweep_steps(n, buckets) + kAhead) * buckets;" in tc
    assert "const int open_rounds = n / buckets / kRound;" in tc
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in tc
    # K12's tag and decode
    assert "v = v * kPack + (t * n_acc + group);" in tc
    assert "d[u] = found ? v >> 11 : kIntBig;" in tc
    # the C entries' body codes: 0 the CUDA cores, 1 the tensor cores
    assert src.count("if (body == 0) {") == 2
    assert src.count("if (body != 1 || !tc_sizes_ok(") == 2
    assert cuda_fold.BODIES["cuda_cores"] == 0
    assert cuda_fold.BODIES["tensor"] == 1


@pytest.mark.parametrize("m,n,w,buckets,want", [
    # (grid, n_pad): rounds of two steps, one ahead
    (8192, 65536, 19, 512, ((64, 8), (128 + 1) * 512)),
    (8192, 65536, 9, 1024, ((64, 16), (64 + 1) * 1024)),
    (8192, 65536, 19, 2048, ((64, 32), (32 + 1) * 2048)),
    (1000, 300, 19, 512, ((8, 8), (2 + 1) * 512)),
    (1000, 1537, 9, 512, ((8, 8), (4 + 1) * 512)),
    (129, 1, 1, 128, ((2, 2), (2 + 1) * 128)),
])
def test_int8_tc_plan_shapes(m, n, w, buckets, want):
    plan = cuda_fold.int8_tc_plan(m, n, w, buckets)
    assert (plan.grid, plan.n_pad) == want
    assert plan.width == 32 and plan.scratch == (m, buckets)
    steps = cuda_fold.int8_tc_sweep_steps(n, buckets)
    ahead = cuda_fold.INT8_TC_AHEAD
    assert steps % (ahead + 1) == 0 and steps * buckets >= n
    assert (steps - ahead - 1) * buckets < n
    assert plan.n_pad == (steps + ahead) * buckets
    # the open rounds hold no column past n; at most one round is masked
    opened = cuda_fold.int8_tc_open_rounds(n, buckets) * (ahead + 1)
    assert opened * buckets <= n and steps - opened <= ahead + 1


def test_int8_tc_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n_acc"):
        cuda_fold.int8_tc_plan(8, 600, 9, 640)
    with pytest.raises(ValueError, match="width"):
        cuda_fold.int8_tc_plan(8, 600, 33, 512)
    with pytest.raises(ValueError, match="no rows"):
        cuda_fold.int8_tc_plan(0, 600, 9, 512)


def test_int8_tc_packed_word_order():
    """Lane tig's B fragment, logical words tig and tig + 4 of a row, is
    the 8-byte pair tig of the packed row; bytes past w and rows past n are
    zero."""
    n, w, n_pad = 5, 19, 8
    ya = (torch.arange(n * w).remainder(251) - 125).to(torch.int8) \
        .reshape(n, w)
    packed = cuda_fold.int8_tc_packed(ya, n_pad)
    assert packed.shape == (n_pad, 32) and packed.dtype == torch.int8
    logical = torch.zeros((n_pad, 32), dtype=torch.int8)
    logical[:n, :w] = ya
    words = logical.view(torch.int32)
    pairs = packed.view(torch.int32).reshape(n_pad, 4, 2)
    for tig in range(4):
        assert torch.equal(pairs[:, tig, 0], words[:, tig])
        assert torch.equal(pairs[:, tig, 1], words[:, tig + 4])
    assert (packed[n:] == 0).all()
    # the fragment map reads the logical row back
    assert torch.equal(packed[:, B_BYTE], logical)


# --------------------------------------------------------------------------
# the tile, emulated, against the plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 4, 9, 16, 17, 19, 32])
@pytest.mark.parametrize("fold", ["cross", "epi", "packed"])
def test_int8_tile_equals_the_plain_version(w, fold):
    """Every width edge at every n_acc (16 for K12 too), with N ragged,
    below B and a whole number of steps plus one, bit for bit."""
    packed = fold == "packed"
    hi = _packed_hi(w) if packed else 127
    choices = F.PACKED_N_ACC_CHOICES if packed else F.N_ACC_CHOICES
    for i, n_acc in enumerate(choices):
        buckets = n_acc * F.LANES
        n = (700, 3 * buckets + 1, buckets - 3, 2 * buckets + 77,
             buckets + 1)[i]
        xa, ya = _operands(w * 100 + i, 37, n, w, hi)
        y2 = _y2(w + i, n) if fold == "epi" else None
        k = (5, 16, 128, 8, 16)[i]
        _assert_equal(_int8_tile(xa, ya, y2, k, n_acc, packed),
                      _plain(xa, ya, y2, k, n_acc, packed))


@pytest.mark.parametrize("fold", ["cross", "packed"])
@pytest.mark.parametrize("n_acc,n", [(4, 300), (4, 1537), (1, 129),
                                     (16, 2049), (8, 1025)])
def test_int8_tile_pad_columns_never_win(fold, n_acc, n):
    """Positive metrics, N below B or one past a whole number of steps:
    the zero pad rows' cross term 0 would beat them. With the mask the
    tile equals the plain version; without it, it does not."""
    packed = fold == "packed"
    if n_acc == 16 and not packed:
        n_acc = 8
    rng = np.random.default_rng(n + n_acc)
    xa = torch.from_numpy(rng.integers(1, 60, (40, 19)).astype(np.int8))
    ya = torch.from_numpy(rng.integers(1, 60, (n, 19)).astype(np.int8))
    want = _plain(xa, ya, None, 16, n_acc, packed)
    _assert_equal(_int8_tile(xa, ya, None, 16, n_acc, packed), want)
    bare = _int8_tile(xa, ya, None, 16, n_acc, packed, mask=False)
    assert not torch.equal(bare[1], want[1])
    assert (bare[0][:, 0] == 0).all()       # the pad's 0 wins unmasked


@pytest.mark.parametrize("fold", ["cross", "epi", "packed"])
def test_int8_tile_ties_and_negative_metrics(fold):
    """Duplicated train rows of small integers tie everywhere: the lowest
    column wins; centered operands give negative metrics."""
    packed = fold == "packed"
    y2 = None
    for n_acc in (1, 4, 8):
        xa, ya = _operands(n_acc, 50, 3000, 9, hi=3, dup=True)
        if fold == "epi":
            y2 = (ya.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
        want = _plain(xa, ya, y2, 16, n_acc, packed)
        _assert_equal(_int8_tile(xa, ya, y2, 16, n_acc, packed), want)
        if fold != "epi":
            assert (want[0][:, 0] < 0).all()


def test_int8_tile_at_the_operand_and_metric_extremes():
    """K11 with every operand at ±127 (|cross| up to 32·127²), K12 with
    metrics reaching ±(2**18 − 1), the most its packed int32 holds."""
    rng = np.random.default_rng(7)
    xa = torch.from_numpy((rng.integers(0, 2, (45, 32)) * 254 - 127)
                          .astype(np.int8))
    ya = torch.from_numpy((rng.integers(0, 2, (1100, 32)) * 254 - 127)
                          .astype(np.int8))
    ya[5] = 127
    xa[3] = 127
    xa[4] = -127
    for y2 in (_y2(3, 1100), None):
        want = _plain(xa, ya, y2, 16, 2)
        _assert_equal(_int8_tile(xa, ya, y2, 16, 2), want)
    assert want[0][4, 0] == -32 * 127 ** 2       # all -127 against all 127
    # per-column ranges whose bound is 16·127² + 127·32 + 15·1 = 2**18 − 1
    hi_x = torch.tensor([127] * 17 + [15], dtype=torch.int32)
    hi_y = torch.tensor([127] * 16 + [32, 1], dtype=torch.int32)
    sx = torch.from_numpy(rng.integers(0, 2, (45, 18)) * 2 - 1)
    sy = torch.from_numpy(rng.integers(0, 2, (1100, 18)) * 2 - 1)
    xa, ya = (sx * hi_x).to(torch.int8), (sy * hi_y).to(torch.int8)
    xa[3], xa[4], ya[5] = hi_x.to(torch.int8), -hi_x.to(torch.int8), \
        hi_y.to(torch.int8)
    assert F.packed_metric_bound(xa, ya) == F.PACKED_METRIC_LIMIT - 1
    for n_acc in (2, 16):
        want = _plain(xa, ya, None, 16, n_acc, packed=True)
        _assert_equal(_int8_tile(xa, ya, None, 16, n_acc, packed=True), want)
        assert want[0][4, 0] == -(F.PACKED_METRIC_LIMIT - 1)


def _warp_extract(vals, cols, k, big):
    """``tc_extract_kernel`` (``csrc/fold_extract.cuh``) in numpy, a row at
    a time: lane l owns buckets 4 (l + 32 q) + e and keeps its smallest
    (value, column) pair; a round takes the smallest of the lanes' pairs,
    the owner marks it taken (its value above every value) and the owner's
    next smallest is found again. The kernel rescans the owner's segment
    with the whole warp; this scans it in one go."""
    above = np.iinfo(np.int32).max if vals.dtype == np.int32 else np.inf
    m, b = vals.shape
    per = b // 32
    lane_of = np.array([(u // 4) % 32 for u in range(b)])
    out_d = np.full((m, 128), big, dtype=vals.dtype)
    out_i = np.full((m, 128), -1, dtype=np.int32)
    for r in range(m):
        v, x = vals[r].copy(), cols[r]
        segs = [np.flatnonzero(lane_of == lane) for lane in range(32)]
        assert all(len(seg) == per for seg in segs)

        def smallest(seg):
            return min(seg, key=lambda u: (v[u], x[u]))
        best = [smallest(seg) for seg in segs]
        for slot in range(k):
            owner = min(range(32), key=lambda lane: (v[best[lane]],
                                                     x[best[lane]]))
            u = best[owner]
            out_d[r, slot], out_i[r, slot] = v[u], x[u]
            v[u] = above
            best[owner] = smallest(segs[owner])
    return out_d, out_i


@pytest.mark.parametrize("buckets,k,ints", [(128, 128, True), (512, 16, True),
                                            (2048, 16, True), (1024, 5, False),
                                            (256, 100, False)])
def test_warp_extraction_equals_extract_k(buckets, k, ints):
    """The extraction's lane segments and owner rescans take the pairs in
    ``extract_k``'s order, empty (big, -1) buckets and ties included, up
    to every bucket of a row (k = B = 128)."""
    rng = np.random.default_rng(buckets + k)
    m = 6
    big = F.INT_BIG if ints else F.BIG
    dtype = np.int32 if ints else np.float32
    vals = rng.integers(-50, 50, (m, buckets)).astype(dtype)
    cols = np.tile(rng.permutation(buckets * 3)[:buckets], (m, 1)) \
        .astype(np.int32)
    empty = rng.random((m, buckets)) < 0.3
    vals[empty], cols[empty] = big, -1
    got = _warp_extract(vals, cols, k, big)
    want = F.extract_k(torch.from_numpy(vals), torch.from_numpy(cols), k,
                       big)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


def test_warp_extraction_mirrors_the_kernel():
    """The emulation's layout is the kernel's: 16-byte loads of buckets 4
    (lane + 32 q) + e into a padded segment a lane, a marked pair's value
    set above every value."""
    src = (SRC.parent / "fold_extract.cuh").read_text()
    assert "constexpr int kStride = kPer + 1;" in src
    assert "const V4 f = vr[lane + 32 * q];" in src
    assert "T* dv = seg_v + lane * kStride + 4 * q;" in src
    assert "if (lane == owner) seg_v[lane * kStride + lu] = above_all<T>();" \
        in src
    assert "const int u = lane + 32 * q;" in src


# --------------------------------------------------------------------------
# the wrappers and their launches (the library faked)
# --------------------------------------------------------------------------

class _FakeInt8Lib:
    """Stands in for the kernels' library: records each K11/K12 launch."""

    def __init__(self):
        self.calls = []

    def avt_fold_int8(self, *args):
        self.calls.append(("int8", args))
        return 0

    def avt_fold_packed(self, *args):
        self.calls.append(("packed", args))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeInt8Lib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
@pytest.mark.parametrize("epi", [False, True])
def test_k11_launch_arguments(fake_lib, body, epi):
    """K11's launch: the body's code; on the tensor cores the packed rows,
    y2 padded (with the epilogue) and the (metric, column) scratch of its
    plan; the count is left to the wrapper."""
    m, n, w, k, n_acc = 300, 1000, 19, 16, 4
    xa, ya = _operands(1, m, n, w)
    y2 = _y2(2, n) if epi else None
    before = cuda_fold.int8_fold.launches
    out_d, out_i, scratch = cuda_fold._launch_int8(
        xa, ya, y2, k, n_acc, body, torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    assert out_d.dtype == out_i.dtype == torch.int32
    ((kind, args),) = fake_lib.calls
    assert kind == "int8"
    assert args[2] == (y2.data_ptr() if epi else None)
    assert args[3:9] == (m, n, w, k, n_acc, cuda_fold.BODIES[body])
    if body == "cuda_cores":
        assert scratch == () and args[9:13] == (None,) * 4
    else:
        plan = cuda_fold.int8_tc_plan(m, n, w, n_acc * 128)
        yp, y2p, vals, cols = scratch
        assert (yp.shape, yp.dtype) == ((plan.n_pad, 32), torch.int8)
        assert (y2p is not None) == epi
        if epi:
            assert (y2p.shape, y2p.dtype) == ((plan.n_pad,), torch.int32)
        assert [(t.shape, t.dtype) for t in (vals, cols)] == [
            (plan.scratch, torch.int32)] * 2
        assert args[9:13] == tuple(None if t is None else t.data_ptr()
                                   for t in scratch)
    assert args[13:15] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.int8_fold.launches == before
    with pytest.raises(ValueError, match="K11 runs on"):
        cuda_fold._launch_int8(xa, ya, y2, k, n_acc, "tile",
                               torch.device("cpu"))


@pytest.mark.parametrize("body", ["cuda_cores", "tensor"])
@pytest.mark.parametrize("n_acc", [4, 16])
def test_k12_launch_arguments(fake_lib, body, n_acc):
    m, n, w, k = 200, 3000, 19, 16
    xa, ya = _operands(3, m, n, w, _packed_hi(w))
    before = cuda_fold.packed_fold.launches
    out_d, out_i, scratch = cuda_fold._launch_packed(
        xa, ya, k, n_acc, body, torch.device("cpu"))
    assert out_d.shape == out_i.shape == (m, 128)
    ((kind, args),) = fake_lib.calls
    assert kind == "packed"
    assert args[2:8] == (m, n, w, k, n_acc, cuda_fold.BODIES[body])
    if body == "cuda_cores":
        assert scratch == () and args[8:11] == (None,) * 3
    else:
        plan = cuda_fold.int8_tc_plan(m, n, w, n_acc * 128)
        yp, y2p, vals, cols = scratch
        assert y2p is None and yp.shape == (plan.n_pad, 32)
        assert [(t.shape, t.dtype) for t in (vals, cols)] == [
            (plan.scratch, torch.int32)] * 2
        assert args[8:11] == (yp.data_ptr(), vals.data_ptr(),
                              cols.data_ptr())
    assert args[11:13] == (out_d.data_ptr(), out_i.data_ptr())
    assert cuda_fold.packed_fold.launches == before
    with pytest.raises(ValueError, match="K12 runs on"):
        cuda_fold._launch_packed(xa, ya, k, n_acc, "cuda", torch.device("cpu"))


def test_int8_folds_launch_the_tensor_cores(monkeypatch):
    """A CUDA tensor takes the int8 tensor-core body through both wrappers
    at every n_acc they take; one launch counted each."""
    calls = []

    def launch(name):
        def run(*args):
            calls.append((name, args[-3], args[-2]))     # n_acc, body
            return torch.empty(8, 128), torch.empty(8, 128), ()
        return run
    monkeypatch.setattr(cuda_fold, "_launch_int8", launch("K11"))
    monkeypatch.setattr(cuda_fold, "_launch_packed", launch("K12"))
    monkeypatch.setattr(cuda_fold, "_check_int8",
                        lambda xa, ya, y2=None: (torch.device("meta"),
                                                 *xa.shape[:1], *ya.shape))
    monkeypatch.setattr(cuda_fold.int8_fold, "launches", 0)
    monkeypatch.setattr(cuda_fold.packed_fold, "launches", 0)
    meta = lambda *s: torch.empty(s, dtype=torch.int8,  # noqa: E731
                                  device="meta")
    for n_acc in F.PACKED_N_ACC_CHOICES:
        if n_acc in F.N_ACC_CHOICES:
            cuda_fold.int8_fold(meta(8, 19), meta(600, 19), k=5,
                                n_acc=n_acc, tile_n=2048)
        cuda_fold.packed_fold(meta(8, 19), meta(600, 19), k=16, n_acc=n_acc,
                              tile_n=2048, metric_bound=0)
    assert calls == [c for a in F.PACKED_N_ACC_CHOICES
                     for c in ((("K11", a, "tensor"),) if a < 16 else ())
                     + (("K12", a, "tensor"),)]
    assert cuda_fold.int8_fold.launches == 4
    assert cuda_fold.packed_fold.launches == 5


def test_int8_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors give the plain versions, uncounted; a tensor off the CPU
    launches or raises, and never falls back."""
    xa, ya = _operands(9, 20, 500, 19, _packed_hi(19))
    before = (cuda_fold.int8_fold.launches, cuda_fold.packed_fold.launches)
    _assert_equal(cuda_fold.int8_fold(xa, ya, k=5),
                  F.int8_fold_plain(xa, ya, k=5))
    _assert_equal(cuda_fold.packed_fold(xa, ya, k=16),
                  F.packed_fold_plain(xa, ya, k=16))
    assert (cuda_fold.int8_fold.launches,
            cuda_fold.packed_fold.launches) == before
    meta = lambda *s: torch.empty(s, dtype=torch.int8,  # noqa: E731
                                  device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.int8_fold(meta(8, 9), meta(600, 9), k=5)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.packed_fold(meta(8, 9), meta(600, 9), k=5, metric_bound=0)


def test_fold_split_runs_every_configuration_and_needs_a_card():
    """``scripts/fold_split.py`` builds one call of each fold configuration
    (the plain versions on the CPU) and refuses to time on the CPU."""
    from avenir_tpu_torch.scripts import _sweep, fold_split
    x, y = _sweep.make_data(16, 4096, torch.device("cpu"))
    calls = fold_split.configurations(x, y)
    assert list(calls) == [
        "K6 n_acc=1", "K6 n_acc=4", "K6 n_acc=8", "K8 n_acc=4", "K9 n_acc=8",
        "augbf16", "augv2", "tpose_aug", "int8epi", "int8aug", "int8rr", "int8pk", "int8pk8", "int8pk16"]
    for call in calls.values():
        out_d, out_i = call()
        assert out_d.shape == out_i.shape == (16, 128)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fold_split.main(["--device", "cpu", "--m", "8", "--n", "4096"])
