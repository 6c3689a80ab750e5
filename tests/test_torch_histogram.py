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


@pytest.mark.parametrize("weighted", [False, True])
def test_moments_are_exact_past_f32_integers(weighted):
    """Integer features up to 600 (the elearn shape): per-class sums of
    squares pass 2^24, where f32 sums in any order lose the last units.
    The moments must equal the exact sums (float64 of integers, exact in
    any order) rounded to f32 once, with integer weights and without."""
    rng = np.random.default_rng(9)
    n, f, c = 6000, 4, 3
    vals = rng.integers(0, 601, size=(n, f)).astype(np.float32)
    labels = rng.integers(-1, c, size=n).astype(np.int32)   # -1 drops
    w = rng.integers(0, 4, size=n).astype(np.float32) if weighted else None
    got = th.per_class_moments(torch.from_numpy(vals),
                               torch.from_numpy(labels), c,
                               None if w is None else torch.from_numpy(w))
    oh = (labels[:, None] == np.arange(c)[None, :]).astype(np.float64)
    if w is not None:
        oh = oh * w.astype(np.float64)[:, None]
    v64 = vals.astype(np.float64)
    want = (oh.T @ np.ones_like(v64), oh.T @ v64, oh.T @ (v64 * v64))
    assert want[2].min() > 2 ** 24
    for t, e in zip(got, want):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), e.astype(np.float32))


# --------------------------------------------------------------------------
# K4 over many pairs: the plain version pair by pair against the JAX
# package, and the group planner
# --------------------------------------------------------------------------

def _multi_case(kind, n, rng):
    """(ids [K, N] int32, pairs, cards) of one case; ids two below and
    two past each column's range drop out where ``kind`` asks for it."""
    if kind == "one pair":
        cards, pairs = [9, 18], [(0, 1)]
    elif kind == "MI F=4":
        cards = [5] * 4 + [10] * 4
        pairs = [(f, 4 + g) for f in range(4) for g in range(4)]
    else:                       # mixed cardinalities, columns used again
        cards = [3, 7, 1, 12]
        pairs = [(0, 1), (1, 0), (2, 3), (3, 3), (0, 1), (1, 1)]
    lo, hi = (-2, 2) if kind != "one pair" else (0, 0)
    ids = np.stack([rng.integers(lo, c + hi, size=n) for c in cards]) \
        .astype(np.int32)
    return ids, pairs, cards


MULTI_CASES = [("one pair", 500), ("MI F=4", 300), ("mixed", 257),
               ("mixed", 0)]


@pytest.mark.parametrize("kind,n", MULTI_CASES)
@pytest.mark.parametrize("wkind", [None, "01", "float"])
def test_pair_counts_multi_plain_vs_jax(kind, n, wkind):
    rng = np.random.default_rng(n + len(kind))
    ids, pairs, cards = _multi_case(kind, n, rng)
    w = _weights(rng, n, wkind)
    flat = cuda_histogram.pair_counts_multi(
        torch.from_numpy(ids), pairs, cards,
        None if w is None else torch.from_numpy(w))
    total = cuda_histogram.pair_offsets(pairs, cards)[-1]
    assert flat.shape == (total,) and flat.dtype == torch.float32
    jw = None if w is None else jnp.asarray(w)
    blocks = cuda_histogram.split_pairs(flat, pairs, cards)
    for block, (a, b) in zip(blocks, pairs):
        ja, jb = jnp.asarray(ids[a]), jnp.asarray(ids[b])
        ref = np.asarray(jh._pair_counts_jnp(ja, jb, cards[a], cards[b], jw))
        pal = np.asarray(jp.pair_counts(ja, jb, cards[a], cards[b], jw,
                                        interpret=True))
        if wkind == "float":
            # one f64 sum rounded to f32 against f32 sums in another order
            np.testing.assert_allclose(block.numpy(), ref, rtol=1e-5)
            np.testing.assert_allclose(block.numpy(), pal, rtol=1e-5)
        else:
            assert np.array_equal(block.numpy(), ref)
            assert np.array_equal(block.numpy(), pal)


def test_pair_counts_multi_cpu_path_and_refusals():
    rng = np.random.default_rng(11)
    ids, pairs, cards = _multi_case("mixed", 200, rng)
    before = cuda_histogram.pair_counts_multi.launches
    # int64 ids through the dispatcher's cast
    got = th.pair_counts_multi(torch.from_numpy(ids.astype(np.int64)), pairs,
                               cards)
    assert torch.equal(got, cuda_histogram.pair_counts_multi_plain(
        torch.from_numpy(ids), pairs, cards))
    assert cuda_histogram.pair_counts_multi.launches == before
    t = torch.from_numpy(ids)
    with pytest.raises(ValueError, match="outside"):
        cuda_histogram.pair_counts_multi(t, [(0, 4)], cards)
    with pytest.raises(ValueError, match="cards must name 4"):
        cuda_histogram.pair_counts_multi(t, pairs, cards[:3])
    with pytest.raises(ValueError, match=">= 1"):
        cuda_histogram.pair_counts_multi(t, pairs, [3, 0, 1, 2])
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        cuda_histogram.pair_counts_multi(t[0], pairs, cards)
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_histogram.pair_counts_multi(meta, pairs, cards)
    assert cuda_histogram.pair_counts_multi(t, [], cards).shape == (0,)


def _check_plan(pairs, cards, weighted, budget):
    """Every pair in exactly one group, the groups in order, each naming
    its pairs' columns and fitting ``budget``; the kernel's table agrees."""
    groups = cuda_histogram.plan_pair_groups(pairs, cards, weighted, budget)
    assert [p for g in groups for p in g.pairs] == list(range(len(pairs)))
    for g in groups:
        named = {c for p in g.pairs for c in pairs[p]}
        assert set(g.columns) == named and len(g.columns) == len(named)
        assert g.cells == sum(cards[pairs[p][0]] * cards[pairs[p][1]]
                              for p in g.pairs)
        assert g.smem <= budget or (g.copies == 0 and len(g.pairs) == 1)
        assert 0 <= g.copies <= cuda_histogram.WARPS
        if g.copies == 0:
            assert len(g.pairs) == 1
        assert g.smem == cuda_histogram._group_smem(
            len(g.pairs), len(g.columns), g.cells, g.copies, weighted)
    table = cuda_histogram._plan_table(pairs, cards, groups)
    offsets = cuda_histogram.pair_offsets(pairs, cards)
    body = table[8 * len(groups):8 * len(groups) + 4 * len(pairs)]
    slots = table[8 * len(groups) + 4 * len(pairs):]
    for gi, g in enumerate(groups):
        head = table[8 * gi:8 * gi + 8]
        assert list(head[:2]) == [g.pairs.start, g.pairs.stop]
        cols = list(slots[head[2]:head[3]])
        assert cols == list(g.columns)
        assert list(head[4:]) == [g.cells, g.copies, offsets[g.pairs.start],
                                  g.tile_rows]
        for p in g.pairs:
            x, n_a, n_b, off = body[4 * p:4 * p + 4]
            a, b = pairs[p]
            assert (cols[x & 0xFFFF], cols[x >> 16]) == (a, b)
            assert (n_a, n_b) == (cards[a], cards[b])
            assert off == offsets[p] - offsets[g.pairs.start]
    return groups


def test_plan_mi_job_is_one_group():
    pairs = [(f, 10 + g) for f in range(10) for g in range(10)]
    groups = _check_plan(pairs, [9] * 10 + [18] * 10, False,
                         cuda_histogram.MAX_SHARED_BYTES)
    assert len(groups) == 1 and groups[0].copies == 1
    assert groups[0].cells == 100 * 9 * 18


def test_plan_splits_wide_pairs_and_isolates_oversized_ones():
    wide = [(a, 8 + b) for a in range(8) for b in range(8)]
    groups = _check_plan(wide, [32] * 8 + [64] * 8, True,
                         cuda_histogram.MAX_SHARED_BYTES)
    assert len(groups) >= 3 and all(g.copies >= 1 for g in groups)
    cards = [256, 512, 4, 3]
    groups = _check_plan([(2, 3), (0, 1), (2, 2), (1, 1)], cards, False,
                         cuda_histogram.MAX_SHARED_BYTES)
    assert [(list(g.pairs), g.copies) for g in groups] == [
        ([0], 8), ([1], 0), ([2], 8), ([3], 0)]
    # one small pair keeps a histogram copy for each warp
    (one,) = _check_plan([(0, 1)], [9, 18], False,
                         cuda_histogram.MAX_SHARED_BYTES)
    assert one.copies == cuda_histogram.WARPS


@pytest.mark.parametrize("seed", range(6))
def test_plan_random_pair_lists_under_small_budgets(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 12))
    cards = [int(c) for c in rng.integers(1, 60, size=k)]
    pairs = [tuple(int(c) for c in rng.integers(0, k, size=2))
             for _ in range(int(rng.integers(1, 80)))]
    budget = int(rng.integers(8_000, 60_000))
    weighted = bool(seed % 2)
    groups = _check_plan(pairs, cards, weighted, budget)
    # greedy: each group's first pair did not fit into the group before it
    for g, h in zip(groups, groups[1:]):
        if g.copies and h.copies:
            a, b = pairs[h.pairs.start]
            assert cuda_histogram._group_smem(
                len(g.pairs) + 1, len(set(g.columns) | {a, b}),
                g.cells + cards[a] * cards[b], 1, weighted) > budget


def test_planner_mirrors_the_kernel_constants():
    """The planner sizes shared memory as ``csrc/hist.cu`` lays it out: the
    constants it mirrors are the source's."""
    import re
    from pathlib import Path
    src = (Path(cuda_histogram.__file__).resolve().parent.parent / "csrc"
           / "hist.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+)", src)
                   .group(1))
    assert const("kMaxSharedBytes") == cuda_histogram.MAX_SHARED_BYTES
    assert const("kThreads") // 32 == cuda_histogram.WARPS
    assert const("kMinPairTileRows") == cuda_histogram.PAIR_TILE_MIN_ROWS
    assert const("kPairTilePad") == cuda_histogram.PAIR_TILE_PAD
    assert [cuda_histogram.pair_tile_rows(p) for p in (1, 4, 5, 10, 32, 100)] \
        == [2048, 2048, 1792, 1024, 256, 256]


class _FakeLib:
    """Stands in for the kernels' library: records each launch's arguments
    and reports success."""

    def __init__(self):
        self.calls = []

    def avt_pair_counts_multi(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["separate", "matrix"])
def test_k4_launch_addresses_the_columns(monkeypatch, layout, weighted):
    """One K4 launch on the host side, the library faked: the kernel finds
    column k at the ids' storage plus k * ld elements — two separate
    tensors through ``pair_counts``, or the rows of a [K, N] matrix
    through ``pair_counts_multi``; the count is left to the wrapper that
    launched."""
    from types import SimpleNamespace
    from avenir_tpu_torch.ops import _build
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_histogram.pair_counts, "launches", 0)
    monkeypatch.setattr(cuda_histogram.pair_counts_multi, "launches", 0)
    n = 37
    w = torch.ones(n) if weighted else None
    if layout == "separate":
        a = torch.zeros(n, dtype=torch.int32)
        b = torch.zeros(n + 7, dtype=torch.int32)[7:]
        base, pair, ld = a, (0, 1), (b.data_ptr() - a.data_ptr()) // 4
        cards = (9, 18)
    else:
        ids = torch.zeros((3, n), dtype=torch.int32)
        a, b = ids[2], ids[0]
        base, pair, ld, cards = ids, (2, 0), n, (18, 5, 9)
    out = cuda_histogram._launch(base, ld, n, (pair,), cards, w)
    assert out.dtype == torch.float32 and out.shape == (9 * 18,)
    (args,) = lib.calls
    assert args[:4] == (base.data_ptr(), ld,
                        None if w is None else w.data_ptr(), n)
    assert base.data_ptr() + 4 * pair[0] * ld == a.data_ptr()
    assert base.data_ptr() + 4 * pair[1] * ld == b.data_ptr()
    # the plan's column list names the pair's columns, in its order
    groups = cuda_histogram.plan_pair_groups((pair,), cards, weighted)
    table = cuda_histogram._plan_table((pair,), cards, groups)
    assert list(table[-2:]) == list(pair)
    assert (cuda_histogram.pair_counts.launches,
            cuda_histogram.pair_counts_multi.launches) == (0, 0)
