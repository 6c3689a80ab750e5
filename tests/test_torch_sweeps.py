"""The kernel-restructure sweeps of the port (sweep11_vmem to
sweep18_tpose_fold) against their JAX counterparts under scripts/.

Each variant of sweeps 16, 16b, 16c and 18 runs once through its script's
own launcher in Pallas interpret mode (small tiles, ``load_sweep``), with
the launcher recorded. That one run is held three ways: the operands the
JAX encoder made against ``_sweep.py``'s (equal exactly); the raw kernel
output against the port's plain fold on those very operands (int8 and
packed: equal exactly; f32: within 1e-5, columns differing only at
near-ties); the variant's result against the port's whole function."""

import functools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu_torch import interop
from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops import fold as F
from avenir_tpu_torch.scripts import (
    _sweep, _timing, sweep11_vmem, sweep14_tpose, sweep16_kernels,
    sweep16b_kernels, sweep16c_kernels, sweep17_tpose_protocol,
    sweep18_tpose_fold)

from _torch_fold_ref import (
    assert_fold_close, bf16_round, load_sweep, recorded_call)

torch.set_num_threads(2)

M, N, D, K = 40, 2048, 9, 5
_PK8 = sweep16c_kernels.make_int8pk(8, 512, 8)
_PK16 = sweep16c_kernels.make_int8pk(16, 512, 16)

# variant: (script, its launcher, its tiles here, the JAX variant, the
# port's, the port's encoder or None where the operands are x and y
# themselves)
VARIANTS = {
    "augbf16": ("sweep16_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
                lambda mod, x, y: (mod.augbf16_topk, dict(k=K)),
                lambda x, y: sweep16_kernels.augbf16_topk(x, y, k=K), None),
    "int8epi": ("sweep16_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
                lambda mod, x, y: (mod.int8epi_topk, dict(k=K)),
                lambda x, y: sweep16_kernels.int8epi_topk(x, y, k=K),
                lambda x, y: _sweep.quant(x, y, 127.0)),
    "int8aug": ("sweep16_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
                lambda mod, x, y: (mod.int8aug_topk, dict(k=K)),
                lambda x, y: sweep16_kernels.int8aug_topk(x, y, k=K),
                _sweep.int8_aug_operands),
    "tagfold": ("sweep16b_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
                lambda mod, x, y: (mod.tagfold_topk, dict(k=K)),
                lambda x, y: sweep16b_kernels.tagfold_topk(x, y, k=K), None),
    "augv2": ("sweep16b_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
              lambda mod, x, y: (mod.augv2_topk, dict(k=K)),
              lambda x, y: sweep16b_kernels.augv2_topk(x, y, k=K),
              _sweep.aug_operands),
    "int8rr": ("sweep16b_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
               lambda mod, x, y: (mod.int8rr_topk, dict(k=K)),
               lambda x, y: sweep16b_kernels.int8rr_topk(x, y, k=K),
               _sweep.int8_aug_operands),
    "int8pk": ("sweep16b_kernels", "_launch", dict(TILE_M=16, TILE_N=512),
               lambda mod, x, y: (mod.int8pk_topk, dict(k=K)),
               lambda x, y: sweep16b_kernels.int8pk_topk(x, y, k=K),
               _sweep.int8_aug_operands),
    "int8pk8": ("sweep16c_kernels", "_launch_packed", dict(TILE_N=1024),
                lambda mod, x, y: (mod.make_int8pk(8, 16, 8), dict(k=K)),
                lambda x, y: _PK8(x, y, k=K), _sweep.int8_centered_operands),
    "int8pk16": ("sweep16c_kernels", "_launch_packed", dict(TILE_N=2048),
                 lambda mod, x, y: (mod.make_int8pk(16, 16, 16), dict(k=K)),
                 lambda x, y: _PK16(x, y, k=K),
                 _sweep.int8_centered_operands),
    "tpose_tag": ("sweep18_tpose_fold", "_launch_t",
                  dict(TILE_M=16, TILE_N=512),
                  lambda mod, x, y: (mod.tpose_tag_topk, {}),
                  sweep18_tpose_fold.tpose_tag_topk, None),
    "tpose_tag8": ("sweep18_tpose_fold", "_launch_t",
                   dict(TILE_M=16, TILE_N=1024),
                   lambda mod, x, y: (mod.tpose_tag8_topk, {}),
                   sweep18_tpose_fold.tpose_tag8_topk, None),
    "tpose_aug": ("sweep18_tpose_fold", "_launch_t",
                  dict(TILE_M=16, TILE_N=512),
                  lambda mod, x, y: (mod.tpose_aug_topk, {}),
                  sweep18_tpose_fold.tpose_aug_topk, _sweep.aug_operands),
}
INT_VARIANTS = ("int8epi", "int8aug", "int8rr", "int8pk", "int8pk8",
                "int8pk16")
F32_VARIANTS = tuple(v for v in VARIANTS if v not in INT_VARIANTS)


def _inputs(m=M, n=N, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random((m, D), dtype=np.float32),
            rng.random((n, D), dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _jax_case(variant, n=N, **consts):
    """One interpret run of the JAX variant, its launcher recorded:
    (x, y, result, launcher operands, launcher keywords, raw outputs)."""
    script, launcher, tiles, pick, _, _ = VARIANTS[variant]
    x, y = _inputs(n=n)
    mod = load_sweep(script, **{**tiles, **consts})
    fn, kw = pick(mod, x, y)
    out, calls = recorded_call(mod, launcher, fn, jnp.asarray(x),
                               jnp.asarray(y), **kw)
    (operands, keywords, raw), = calls
    return x, y, out, operands, keywords, raw


def _port_operands(variant, n=N, **consts):
    """The recorded JAX operands as the port's tensors (the train pad cut)
    and the launch they belong to: (xa, ya, scale, y2, launch keywords)."""
    _, _, _, operands, kw, _ = _jax_case(variant, n, **consts)
    tpose = variant.startswith("tpose")
    y2 = kw.get("y2")
    xa, ya, _, y2 = interop.sweep_operands_from_numpy(
        operands[0], operands[1], n=n, y2=y2, tpose=tpose, device="cpu")
    if tpose:
        xa = xa[:, :M].contiguous()
    launch = dict(k=kw.get("k", kw.get("c_out", K)),
                  n_acc=kw.get("n_acc", 4))
    return xa, ya, y2, launch, bool(kw.get("packed")
                                    or variant.startswith("int8pk"))


def _port_fold(variant, n=N, **consts):
    xa, ya, y2, launch, packed = _port_operands(variant, n, **consts)
    if variant.startswith("tpose"):
        if y2 is None:
            return cuda_fold.raw_fold(xa, ya, tpose=True, tile_n=4096,
                                      **launch)
        return cuda_fold.tpose_fold(xa, ya, y2, tile_n=4096, **launch)
    return _sweep.launch_fold(xa, ya, y2=y2, packed=packed, **launch)


def _metric64(variant, n=N, **consts):
    """The f32 variants' metric in float64 over the operands as the kernel
    rounds them."""
    xa, ya, y2, _, _ = _port_operands(variant, n, **consts)
    if variant.startswith("tpose"):
        xa, ya = xa.T, ya.T
    x64 = bf16_round(xa.float().numpy()).astype(np.float64)
    y64 = bf16_round(ya.float().numpy()).astype(np.float64)
    if y2 is None:
        return x64 @ y64.T
    return y2.double().numpy()[None, :] - 2.0 * x64 @ y64.T


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if VARIANTS[v][5] is not None])
def test_operand_encoders_equal_the_jax_ones(variant):
    x, y, _, operands, _, _ = _jax_case(variant)
    built = VARIANTS[variant][5](torch.from_numpy(x), torch.from_numpy(y))
    for got, want in zip(built[:2], operands[:2]):
        want = np.asarray(want)
        if variant == "tpose_aug":      # [D + 2, M padded] feature-major
            want = want.T[:got.shape[0]]
        if want.dtype.name == "bfloat16":
            got = got.to(torch.bfloat16).float()
            want = want.astype(np.float32)
        assert str(got.dtype) == f"torch.{want.dtype.name}"
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", INT_VARIANTS)
def test_int_fold_plain_equals_the_interpret_kernel(variant):
    raw_d, raw_i = _jax_case(variant)[5]
    before = (cuda_fold.int8_fold.launches, cuda_fold.packed_fold.launches)
    got_d, got_i = _port_fold(variant)
    assert (cuda_fold.int8_fold.launches,
            cuda_fold.packed_fold.launches) == before   # CPU: plain version
    assert got_d.dtype == got_i.dtype == torch.int32
    assert np.array_equal(got_d.numpy(), raw_d[:M])
    assert np.array_equal(got_i.numpy(), raw_i[:M])


@pytest.mark.parametrize("variant", F32_VARIANTS)
def test_f32_fold_plain_vs_the_interpret_kernel(variant):
    raw_d, raw_i = _jax_case(variant)[5]
    got = _port_fold(variant)
    assert got[0].shape == got[1].shape == (M, 128)
    assert_fold_close(got, (raw_d[:M], raw_i[:M]), _metric64(variant))
    assert (got[1][:, :K] >= 0).all() and (got[1][:, K:] == -1).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_whole_function_vs_the_jax_route(variant):
    """Encoder → fold → finalize or re-rank, 40 × 2,048 × 9: the ids are
    the JAX route's but for near-ties (recall of one against the other at
    least 0.99), and the scaled distances of the shared ids within 1."""
    x, y, (want_d, want_i), _, _, _ = _jax_case(variant)
    got_d, got_i = VARIANTS[variant][4](torch.from_numpy(x),
                                        torch.from_numpy(y))
    assert got_d.shape == got_i.shape == (M, K)
    assert got_d.dtype == got_i.dtype == torch.int32
    want_i = torch.from_numpy(np.array(want_i[:M]))
    want_d = torch.from_numpy(np.array(want_d[:M]))
    assert _sweep.recall_of(want_i, got_i) >= 0.99
    same = got_i.unsqueeze(2) == want_i.unsqueeze(1)
    diff = (got_d.unsqueeze(2) - want_d.unsqueeze(1)).abs()
    assert same.any() and int(diff[same].max()) <= 1


def test_ragged_f32_pad_never_wins():
    """N = 300, below the 512 buckets, tile 512: the JAX launcher pads 212
    rows with BIG in the y2hi column; for the port they do not exist. The
    outputs agree in full: empty buckets on both sides."""
    n = 300
    raw_d, raw_i = _jax_case("augv2", n)[5]
    got = _port_fold("augv2", n)
    assert_fold_close(got, (raw_d[:M], raw_i[:M]), _metric64("augv2", n))
    assert (got[1][:, :K] >= 0).all() and (got[1][:, :K] < n).all()


@pytest.mark.parametrize("variant", ["int8rr", "int8pk"])
def test_ragged_int8_pad_is_found_on_the_tpu_only(variant):
    """N = 100 with 128 candidates: the JAX launcher's 412 pad rows encode
    a metric of 144,018, below INT_BIG, and are found in the buckets no
    real column reaches, with columns ≥ N. The port has no such columns:
    the slots that real columns fill are equal, the rest are empty."""
    n = 100
    raw_d, raw_i = _jax_case(variant, n, K_CAND=128)[5]
    got_d, got_i = _port_fold(variant, n, K_CAND=128)
    assert np.array_equal(got_d.numpy()[:, :n], raw_d[:M, :n])
    assert np.array_equal(got_i.numpy()[:, :n], raw_i[:M, :n])
    assert (raw_i[:M, n:] >= n).all() and (raw_d[:M, n:] == 144018).all()
    assert (got_i[:, n:] == -1).all() and (got_d[:, n:] == F.INT_BIG).all()


def test_bf16_of_big_stays_big():
    """The y2hi pad of the JAX launchers, bf16(BIG), must not round below
    BIG, or the strict ``<`` against an empty bucket would admit it."""
    big = torch.tensor(F.BIG, dtype=torch.float32)
    assert float(big.to(torch.bfloat16).to(torch.float32)) >= float(big)
    assert float(F.round_bf16(big)) >= float(big)


def test_packed_fold_equals_the_tag_fold_in_its_range():
    rng = np.random.default_rng(3)
    xa = torch.from_numpy(rng.integers(-126, 127, (24, 19)).astype(np.int8))
    ya = torch.from_numpy(rng.integers(-63, 64, (3000, 19)).astype(np.int8))
    for n_acc, k in ((1, 128), (4, 16), (8, 8)):
        want = F.int8_fold_plain(xa, ya, k=k, n_acc=n_acc,
                                 tile_n=n_acc * 128)
        got = F.packed_fold_plain(xa, ya, k=k, n_acc=n_acc,
                                  tile_n=n_acc * 128)
        assert (want[0][:, 0] < 0).any()                # negative metrics
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = cuda_fold.packed_fold(xa, ya, k=16, n_acc=16, tile_n=2048)
    assert (got[1][:, :16] >= 0).all()


def test_packed_fold_ranges_raise():
    one = torch.ones((1, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="at most 262144 train rows"):
        cuda_fold.packed_fold(one, torch.ones((262145, 1), dtype=torch.int8),
                              k=1)
    wide = torch.full((2, 19), 127, dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\*\\*18"):
        cuda_fold.packed_fold(wide, wide, k=1)
    with pytest.raises(ValueError, match="2\\*\\*18"):
        cuda_fold.packed_fold(one, one, k=1, metric_bound=2 ** 18)
    assert F.packed_metric_bound(wide, wide) == 19 * 127 * 127
    assert _sweep.AUG_METRIC_BOUND < F.PACKED_METRIC_LIMIT
    xa, ya, _ = _sweep.int8_aug_operands(*map(torch.from_numpy, _inputs()))
    assert F.packed_metric_bound(xa, ya) <= _sweep.AUG_METRIC_BOUND
    # 16 accumulator blocks are the packed fold's alone
    with pytest.raises(ValueError, match="n_acc"):
        cuda_fold.int8_fold(one, one, k=1, n_acc=16, tile_n=2048)
    with pytest.raises(ValueError, match="n_acc"):
        cuda_fold.raw_fold(torch.ones(1, 2), torch.ones(3, 2), k=1,
                           n_acc=16, tile_n=2048)


def test_exact_rerank_takes_the_lowest_position_on_ties():
    y = torch.tensor([[0.0] * D, [0.5] * D, [0.5] * D, [1.0] * D])
    x = torch.zeros((1, D))
    cand = torch.tensor([[3, 2, 1, -1, 0]], dtype=torch.int32)
    d, i = _sweep.exact_rerank(x, y, cand, 4)
    assert i.tolist() == [[0, 2, 1, 3]]
    assert d.tolist() == [[0, 500, 500, 1000]]
    d, i = _sweep.exact_rerank(x, y, cand[:, 3:4], 1)
    assert (d.tolist(), i.tolist()) == ([[F.INT_BIG]], [[-1]])


def test_gate_counts_as_the_jax_gate(capsys):
    """The same candidate lists through the JAX sweep's ``_gate`` and the
    port's: recall, distance error and matches are equal."""
    x, y = _inputs(m=48, n=1024)
    mod = load_sweep("sweep16c_kernels")
    rng = np.random.default_rng(5)
    d_ex, i_ex = (np.asarray(a) for a in mod.pairwise_topk(
        jnp.asarray(x), jnp.asarray(y), k=K, mode="exact"))
    i_c = i_ex.copy()
    i_c[rng.random(i_c.shape) < 0.2] = 1023              # some misses
    d_c = d_ex + rng.integers(-30, 31, d_ex.shape)
    cand = np.concatenate([i_c, i_ex[:, :2]], axis=1)
    ok = mod._gate("arm", lambda t, tr: (jnp.asarray(d_c), jnp.asarray(i_c)),
                   jnp.asarray(x), jnp.asarray(y),
                   lambda t, tr: (None, None, jnp.asarray(cand)))
    want = re.search(r"recall=([0-9.]+) dist_err=(\d+) \(n=(\d+)\) "
                     r"candidate_coverage=([0-9.]+)", capsys.readouterr().out)
    got = _sweep.gate(
        "arm", lambda t, tr: (torch.from_numpy(d_c), torch.from_numpy(i_c)),
        torch.from_numpy(x), torch.from_numpy(y),
        lambda t, tr: (None, None, torch.from_numpy(cand)))
    out = capsys.readouterr().out
    assert f"{got['recall']:.4f}" == want.group(1)
    assert (got["dist_err"], got["matched"]) == (int(want.group(2)),
                                                 int(want.group(3)))
    assert f"{got['coverage']:.4f}" == want.group(4)
    assert got["ok"] == bool(ok) and "candidate_coverage=" in out


def test_differential_rounds_interleave_and_ratio():
    order = []
    arms = {"prod": lambda: order.append("p"), "arm": lambda: order.append("a")}
    per_round = _timing.differential_rounds(arms, "cpu", rounds=2, lo=1,
                                            hi=3)
    assert {k: len(v) for k, v in per_round.items()} == {"prod": 2, "arm": 2}
    warm = "ppaa"                                   # a call, a timed call
    assert "".join(order) == warm + "p" * 4 + "a" * 4 + "p" * 4 + "a" * 4
    del order[:]
    _timing.differential_rounds(arms, "cpu", rounds=1, lo=1, hi=3,
                                by_phase=True)
    assert "".join(order) == warm + "pa" + "ppp" + "aaa"
    ratios = _timing.ratio_medians({"prod": [2.0, 4.0, 9.0],
                                    "arm": [1.0, 4.0, 3.0]}, "prod")
    assert ratios == {"prod": 1.0, "arm": 2.0}


HARNESSES = {
    "sweep11_vmem": (sweep11_vmem, ["xla", "prod_1024x4096"]
                     + [f"vmem_{tm}x{tn}" for tm, tn in sweep11_vmem.CONFIGS]),
    "sweep14_tpose": (sweep14_tpose, ["tpose"]),
    "sweep17_tpose_protocol": (sweep17_tpose_protocol, ["tpose"]),
    "sweep16_kernels": (sweep16_kernels, list(sweep16_kernels.ARMS)),
    "sweep16b_kernels": (sweep16b_kernels, list(sweep16b_kernels.ARMS)),
    "sweep16c_kernels": (sweep16c_kernels, ["prod", "int8pk8", "int8pk16"]),
    "sweep18_tpose_fold": (sweep18_tpose_fold,
                           list(sweep18_tpose_fold.ARMS) + ["tpose_aug"]),
}


@pytest.mark.parametrize("name", list(HARNESSES))
def test_harness_prints_one_line_per_arm(name, capsys, monkeypatch):
    module, arms = HARNESSES[name]
    monkeypatch.setattr(_sweep, "ITERS_LO", 1)
    monkeypatch.setattr(_sweep, "ITERS_HI", 2)
    monkeypatch.setattr(module, "ROUNDS", 1)
    if hasattr(module, "ITERS"):
        monkeypatch.setattr(module, "ITERS", 1)
    result = module.main(["--device", "cpu", "--m", "64", "--n", "4096"])
    out = capsys.readouterr().out
    assert f"# {name}: 64 test x 4096 train" in out and "host clock" in out
    for arm in arms:
        assert re.search(rf"^(gate )?{arm}\b.*(recall|RECALL|ms|us/iter)", out,
                         re.MULTILINE), (arm, out)
    if "gates" in result:
        assert result["gates"]["prod"]["ok"]
        assert {row["arm"] for row in result["timed"]} == {
            a for a, g in result["gates"].items()
            if (g["ok"] or name == "sweep16c_kernels") and a != "tpose_aug"}
        # the re-ranked int8 arms keep the exact neighbors at this size
        for arm in ("int8rr", "int8pk", "int8pk8", "int8pk16"):
            if arm in result["gates"]:
                assert result["gates"][arm]["recall"] >= 0.985


def test_sweep14_times_a_passing_arm(capsys, monkeypatch):
    """At 256 train rows the rounded fold keeps every neighbor, so the
    gate passes and both protocols run to their report."""
    monkeypatch.setattr(_sweep, "ITERS_LO", 1)
    monkeypatch.setattr(_sweep, "ITERS_HI", 2)
    monkeypatch.setattr(sweep14_tpose, "ITERS", 1)
    monkeypatch.setattr(sweep14_tpose, "ROUNDS", 1)
    monkeypatch.setattr(sweep17_tpose_protocol, "ROUNDS", 2)
    argv = ["--device", "cpu", "--m", "16", "--n", "256"]
    r14 = sweep14_tpose.main(argv)
    r17 = sweep17_tpose_protocol.main(argv)
    out = capsys.readouterr().out
    assert r14["recall"] >= 0.985 and r14["tpose_us"] is not None
    assert r17["ratio"] is not None and "median tpose speedup" in out
    assert re.search(r"^tpose .* us/iter .*x prod$", out, re.MULTILINE)
    d, i = sweep14_tpose.tpose_topk(*map(torch.from_numpy, _inputs()), k=K)
    assert d.dtype == torch.float32 and d.shape == i.shape == (M, K)
    assert (d < 0).any()            # the raw metric: no |x|², no clamp


def test_interop_carries_the_types_and_cuts_the_pad():
    _, _, _, operands, kw, _ = _jax_case("augv2", 300)
    assert operands[1].shape[0] == 512 and operands[1].dtype.name == "bfloat16"
    xa, ya, s, y2 = interop.sweep_operands_from_numpy(
        operands[0], operands[1], n=300, scale=np.float32(63.0),
        device="cpu")
    assert xa.dtype == ya.dtype == torch.bfloat16 and y2 is None
    assert ya.shape == (300, D + 2) and float(s) == 63.0
    assert np.array_equal(ya.float().numpy(),
                          operands[1][:300].astype(np.float32))
    x8, y8, _, y2 = interop.sweep_operands_from_numpy(
        np.ones((2, 3), np.int8), np.ones((3, 8), np.int8), n=5,
        y2=np.arange(8, dtype=np.int32)[None, :], tpose=True, device="cpu")
    assert y8.shape == (3, 5) and y8.dtype == torch.int8
    assert y2.tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(TypeError, match="sweep operands"):
        interop.sweep_operands_from_numpy(np.ones((2, 3)), np.ones((3, 3)),
                                          n=3, device="cpu")


def test_cuda_tensors_launch_or_raise_and_no_silent_cpu():
    """A tensor off the CPU takes the launch branch, which takes CUDA
    tensors only; the harnesses run on CUDA by default."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.raw_fold(meta(8, 11), meta(600, 11), k=5)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.raw_fold(meta(11, 8, dtype=torch.bfloat16),
                           meta(11, 600, dtype=torch.bfloat16), k=5,
                           tpose=True)
    i8 = dict(dtype=torch.int8)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.int8_fold(meta(8, 19, **i8), meta(600, 19, **i8), k=5)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.int8_fold(meta(8, 9, **i8), meta(600, 9, **i8),
                            meta(600, dtype=torch.int32), k=5)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_fold.packed_fold(meta(8, 19, **i8), meta(600, 19, **i8), k=16,
                              n_acc=16, tile_n=2048, metric_bound=1000)
    # the tile rule comes before the device
    with pytest.raises(ValueError, match="multiple of n_acc"):
        cuda_fold.int8_fold(meta(8, 19, **i8), meta(600, 19, **i8), k=5,
                            tile_n=1000)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    for module in (sweep11_vmem, sweep14_tpose, sweep16_kernels,
                   sweep16b_kernels, sweep16c_kernels,
                   sweep17_tpose_protocol, sweep18_tpose_fold):
        with pytest.raises(RuntimeError, match="device cpu"):
            module.main(["--m", "8", "--n", "600"])
