"""The slice as a whole: the port's exp_fold and roofline_knn harnesses on
the CPU, their recalls against the JAX experiment's route (its fold kernel
in interpret mode, its exact top-k by ``lax.top_k``), and the harnesses'
rules."""

import ast
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from avenir_tpu_torch.scripts import _timing, exp_fold, roofline_knn

from _torch_fold_ref import jax_fold

torch.set_num_threads(2)

PORT_SCRIPTS = Path(__file__).resolve().parent.parent / "avenir_tpu_torch" \
    / "scripts"
M, N = 128, 8192


def _jax_recalls(m, n, d, k):
    """(recall, recall without bf16) per configuration, as the JAX
    experiment computes them (scripts/exp_fold.py:123-139) on the same
    seeded inputs, with its kernel in interpret mode."""
    rng = np.random.default_rng(0)
    test = rng.random((m, d), dtype=np.float32)
    train = rng.random((n, d), dtype=np.float32)
    t, y = jnp.asarray(test), jnp.asarray(train)
    full = (jnp.sum(t * t, axis=1, keepdims=True)
            + jnp.sum(y * y, axis=1)[None, :] - 2 * t @ y.T)
    exact = np.asarray(lax.top_k(-full, k)[1])
    out = []
    for n_acc, tile_n in exp_fold.CONFIGS:
        pair = []
        for use_bf16 in (True, False):
            ids = jax_fold("acc", test, train, k=k, tile_m=128,
                           tile_n=tile_n, n_acc=n_acc,
                           use_bf16=use_bf16)[1][:, :k]
            hits = sum(len(set(a) & set(b)) for a, b in zip(exact, ids))
            pair.append(hits / (m * k))
        out.append(tuple(pair))
    return out


def test_exp_fold_recalls_equal_the_jax_route(capsys):
    results = exp_fold.main(["--device", "cpu", "--m", str(M), "--n",
                             str(N)])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("n_acc=")]
    assert len(lines) == len(results) == 5
    want = _jax_recalls(M, N, 9, 5)
    for line, row, (r_bf16, r_f32) in zip(lines, results, want):
        assert f"n_acc={row['n_acc']} " in line
        assert f"recall={r_bf16:.4f}" in line
        assert row["recall"] == pytest.approx(r_bf16, abs=1e-12)
        assert row["recall_f32"] == pytest.approx(r_f32, abs=1e-12)
        assert row["ms"] > 0 and row["ms_f32"] > 0
        assert f"f32 {row['ms_f32']:.4f} ms" in line
    # the rounding costs recall: the finding the experiment exists for
    assert all(r_bf16 < r_f32 for r_bf16, r_f32 in want)


def test_roofline_prints_one_line_per_variant(capsys):
    results = roofline_knn.main(["--device", "cpu", "--m", "64", "--n",
                                 "4096"])
    out = capsys.readouterr().out
    assert [r["variant"] for r in results] == list(roofline_knn.VARIANTS)
    for variant in roofline_knn.VARIANTS:
        assert re.search(rf"^{variant}\s+[0-9.]+ ms .* pairs/s", out,
                         re.MULTILINE), variant
    assert "host clock, cpu" in out and "not measured (cpu)" in out
    assert "# split by kernel: not measured (cpu)" in out
    assert all(r["ms"] > 0 for r in results)


def test_roofline_variants_compute_their_functions():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((48, 9), dtype=np.float32))
    y = torch.from_numpy(rng.random((3000, 9), dtype=np.float32))
    full_d, full_i = roofline_knn.launch("full", x, y)
    plain_d, plain_i = roofline_knn.launch("plain", x, y)
    _, lib_i = roofline_knn.launch("library", x, y)
    assert full_i.shape == plain_i.shape == lib_i.shape == (48, 5)
    assert torch.equal(full_i.long(), lib_i)
    sweep, none = roofline_knn.launch("full-sweep", x, y)
    assert none is None and sweep.shape == (48,)
    assert torch.allclose(sweep, full_d[:, 0], rtol=0, atol=1e-6)
    nodot_d, nodot_i = roofline_knn.launch("full-nodot", x, y)
    assert nodot_d.shape == nodot_i.shape == (48, 5)
    dotmin, none = roofline_knn.launch("dotmin", x, y)
    assert none is None and dotmin.shape == (48, 128)
    # the fold's winner of each row is the row's best (a bucket minimum)
    for variant in ("nodot", "tpose"):
        d, i = roofline_knn.launch(variant, x, y)
        assert d.shape == i.shape == (48, 128)
    tpose_d, _ = roofline_knn.launch("tpose", x, y)
    assert torch.allclose(tpose_d.min(dim=1).values,
                          dotmin.min(dim=1).values, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown variant"):
        roofline_knn.launch("xla", x, y)


@pytest.mark.parametrize("m,n,k", [(40, 3000, 5), (7, 300, 8), (33, 9, 1)])
def test_k2_ablations_plain_versions(m, n, k):
    """K2 without its product: the k smallest ``|y2[j] − Σ x[r]|`` by
    (value, id); without its selection: each row's smallest metric — both
    against float64 on the CPU, which takes the plain versions."""
    from avenir_tpu_torch.ops import cuda_distance as D
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.random((m, 9), dtype=np.float32))
    y = torch.from_numpy(rng.random((n, 9), dtype=np.float32))
    y2 = D.row_sq_norm(y)
    x64, y64 = x.double().numpy(), y.double().numpy()
    y2_64 = (y64 * y64).sum(1)
    before = D.topk_nodot_raw.launches, D.topk_sweep_min.launches
    nd, ni = D.topk_nodot_raw(x, y2, k)
    want = np.abs(y2_64[None, :] - x64.sum(1)[:, None])
    order = np.argsort(want, axis=1, kind="stable")[:, :k]
    rows = np.arange(m)[:, None]
    assert ni.shape == (m, k)
    assert np.abs(nd.numpy() - want[rows, order]).max() <= 1e-5
    differ = ni.numpy() != order
    assert (np.abs(want[rows, ni.numpy()] - want[rows, order])[differ]
            <= 1e-5).all()
    sweep = D.topk_sweep_min(x, y, y2)
    metric = y2_64[None, :] - 2.0 * x64 @ y64.T
    assert sweep.shape == (m,)
    assert np.abs(sweep.numpy() - metric.min(1)).max() <= 1e-5
    assert (D.topk_nodot_raw.launches, D.topk_sweep_min.launches) == before
    meta = torch.empty((8, 9), device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        D.topk_nodot_raw(meta, torch.empty(600, device="meta"), 5)
    with pytest.raises(ValueError, match="expected CUDA"):
        D.topk_sweep_min(meta, torch.empty((600, 9), device="meta"),
                         torch.empty(600, device="meta"))


def test_smoke_pair_bound_takes_the_rate_of_the_operands_type(monkeypatch):
    """bf16-rounded operands: the product at the tensor cores' rate beside
    the CUDA cores' per-pair instructions; f32: both on the CUDA cores;
    no product: the instructions alone; else the bytes."""
    smoke = _chip_smoke()
    lane = 132 * 128 * 1.98e9
    monkeypatch.setattr(roofline_knn, "lane_ops_per_s", lambda dev: lane)
    m, n, d = 8192, 65536, 9
    pairs_ms = m * n * 4 / lane * 1e3
    assert smoke.pair_bound_ms(None, m, n, d, 0, "bf16", 4) == \
        pytest.approx((pairs_ms, "operations"))
    # the bf16 product alone is 0.010 ms, below the fold's instructions
    assert 2 * m * n * d / 989e12 * 1e3 < pairs_ms
    assert smoke.pair_bound_ms(None, m, n, d, 0, None, 4) == \
        pytest.approx((pairs_ms, "operations"))
    f32 = smoke.pair_bound_ms(None, m, n, d, 0, "f32", 2)
    assert f32 == pytest.approx((2 * m * n * d / 67e12 * 1e3 + pairs_ms / 2,
                                 "operations"))
    assert smoke.pair_bound_ms(None, 8, 8, d, 3.35e9, "bf16", 4) == \
        pytest.approx((1.0, "bytes"))


# chained device times at the bench shape recorded in PERF.md (H100 80GB
# HBM3, 700 W): K2 and its ablations, K7, K6 for tpose (the same function
# and body), K8 and the plain and library calls as PR 9 measured them
_RECORDED_MS = {"full": 0.8717, "full-sweep": 0.5658, "full-nodot": 0.4662,
                "dotmin": 0.0622, "nodot": 0.2046, "tpose": 0.1622,
                "plain": 50.6, "library": 10.45}


def test_roofline_shares_stay_within_the_ceilings():
    """Each variant read against the units that do its work, at 132 SMs
    and 1.98 GHz: no share above 100%, and no share where a ceiling does
    not apply (no product: nodot, full-nodot; no instructions counted: K2,
    plain, library)."""
    m, n, d = 8192, 65536, 9
    got = {v: roofline_knn.shares(132, 1.98e9, v, m, n, d, ms)
           for v, ms in _RECORDED_MS.items()}
    assert set(got) == set(roofline_knn.VARIANTS)
    for variant, row in got.items():
        for key, share in row.items():
            assert share is None or 0 < share <= 1.0, (variant, key, share)
    none = {v for v, row in got.items() if row["product"] is None}
    assert none == {"nodot", "full-nodot"}
    assert {v for v, row in got.items() if row["ops"] is None} == {
        "full", "plain", "library"}
    pairs = m * n / (0.0622e-3)
    # dotmin: bf16 on the tensor cores over one k-step of 16, 2 instructions
    assert got["dotmin"]["product"] == pytest.approx(
        pairs / (989e12 / 32))
    assert got["dotmin"]["ops"] == pytest.approx(
        pairs * 2 / (132 * 128 * 1.98e9))
    assert got["dotmin"]["ops"] == pytest.approx(0.516, abs=1e-3)
    # K2 on the f32 CUDA cores: 2·D flops a pair
    assert got["full"]["product"] == pytest.approx(
        m * n / 0.8717e-3 / (67e12 / 18))
    # the fault repaired: the f32 product and a 4-instruction fold read
    # dotmin above 100%
    assert pairs / (67e12 / 18) > 2.3 and pairs * 4 / (
        132 * 128 * 1.98e9) > 1.0
    assert roofline_knn.share_text(None).strip() == "—"
    assert roofline_knn.share_text(0.5162).strip() == "51.6%"


def test_roofline_work_is_the_smoke_bounds_table():
    """One table of each kernel's product type and instructions a pair:
    the script reads it for its variants and chip_smoke.py for its bounds,
    which keep no copy of their own."""
    assert roofline_knn.WORK["K6"] == roofline_knn.WORK["K9"] == ("bf16", 4)
    assert roofline_knn.WORK["K7"] == ("bf16", 2)
    assert roofline_knn.WORK["K8"] == (None, 4)
    for variant, kernel in roofline_knn.VARIANT_KERNELS.items():
        assert roofline_knn.variant_work(variant) == roofline_knn.WORK[kernel]
    src = (PORT_SCRIPTS.parent.parent / "chip_smoke.py").read_text()
    assert src.count("*WORK[name]") == 2
    assert '"bf16", 4)' not in src.split("def sweep_configs")[0]


def test_chain_ms_differences_out_the_fixed_cost(monkeypatch):
    monkeypatch.setattr(_timing, "REPEATS", 2)
    calls = []

    def call():
        calls.append(1)
        time.sleep(0.004)
    assert _timing.chain_ms(call, "cpu") > 0
    # a warm-up, one call that sizes R (50 ms / ~4 ms: R ≤ 13), then 2
    # chains of R and 2 of 4R
    reps = (len(calls) - 2) // 10
    assert len(calls) == 2 + 10 * reps and 2 <= reps <= 13
    assert _timing.clock_label("cpu") == "host clock, cpu"


def test_the_port_scripts_import_no_jax():
    """The purity walk of test_torch_cli covers ``avenir_tpu_torch/scripts``
    too (it globs the package); the same rule, here for these files."""
    files = sorted(PORT_SCRIPTS.glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "_timing.py",
                                       "exp_fold.py", "roofline_knn.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "avenir_tpu"), (path, name)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", PORT_SCRIPTS.parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _slots(values, ids):
    """One row of raw fold output: the given slots, then (BIG, -1)."""
    from avenir_tpu_torch.ops.fold import BIG
    d = torch.full((1, 128), BIG)
    i = torch.full((1, 128), -1, dtype=torch.int32)
    d[0, :len(values)] = torch.tensor(values)
    i[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return d, i


# the metric of columns 0..4: columns 0, 1 tie at 1, columns 2, 3 at 4
_GATE_METRIC = torch.tensor([1., 1., 4., 4., 9.])


@pytest.mark.parametrize("plain,got,match", [
    (([1., 4.], [0, 2]), ([1., 4.], [0, 2]), None),
    (([1., 4.], [0, 2]), ([1., 4.], [1, 2]), None),       # near-tie column
    (([1., 4.], [0, 2]), ([1., 4.], [0, 4]), "not those of its columns"),
    (([1., 4.], [0, 2]), ([1., 9.], [0, 4]), "beyond 1e-5 relative"),
    (([4., 4.], [2, 3]), ([4., 4.], [2, 2]), "repeats"),
    (([1., 4.], [0, 2]), ([1.], [0]), "empty slots differ"),
])
def test_smoke_fold_gate(plain, got, match):
    """The card's fold gate takes the plain answer and near-tie columns,
    and refuses other metrics, metrics not of their columns, repeated
    columns and misplaced empty slots."""
    smoke = _chip_smoke()

    def metric_of(ids):
        return _GATE_METRIC[ids.long()]
    args = (_slots(*got), _slots(*plain), metric_of, torch.zeros(1))
    if match is None:
        check = smoke.compare_fold("gate", *args)
        assert check["differ"] == (got != plain)
    else:
        with pytest.raises(AssertionError, match=match):
            smoke.compare_fold("gate", *args)


@pytest.mark.parametrize("demangled,want", [
    ("(anonymous namespace)::tc::tc_sweep_kernel<true, 1>(float const*, "
     "(anonymous namespace)::tc::Strides, uint2 const*, int, int, int, int, "
     "float*, int*)", "tc_sweep_kernel<true, 1>"),
    ("void (anonymous namespace)::tc::tc_sweep_kernel<false, 4>((anonymous "
     "namespace)::tc::Strides)", "tc_sweep_kernel<false, 4>"),
    ("void (anonymous namespace)::fold_kernel<false, true, false, true, "
     "1024>(float const*, float const*, int)",
     "fold_kernel<false, true, false, true, 1024>"),
    ("avt::pair_counts_multi_kernel(int const*, long long)",
     "pair_counts_multi_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_kernel_names_drop_namespaces_and_parameters(demangled, want):
    """The names chip_smoke.py's phase 1 gives each kernel's registers and
    HMMA count, and the split each kernel's time: a namespace inside the
    parameters must not stand in for the name (the eight sweep
    instantiations then fell together under one key)."""
    assert roofline_knn.kernel_name(demangled) == want


def test_smoke_fold_gate_lanes():
    smoke = _chip_smoke()
    plain, _ = _slots([1., 2.], [])
    check = smoke.compare_fold("lanes", (plain.clone(), None), (plain, None),
                               None, torch.zeros(1))
    assert check == {"differ": 0, "err": 0.0}
    with pytest.raises(AssertionError, match="empty slots"):
        smoke.compare_fold("lanes", (_slots([1.], [])[0], None),
                           (plain, None), None, torch.zeros(1))
