#!/usr/bin/env python3
"""Drive avenir_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. card and build: the ``nvidia-smi`` name and power limit,
   ``torch.version.cuda``, and the time to build ``avenir_tpu_torch/csrc/*.cu``
   with nvcc for sm_90a;
2. each kernel against its plain version on the card, with times:
   K1 (NB joint counts) at 1,048,576 churn-shaped rows — unweighted and
   0/1-weighted counts exactly equal, float weights within rtol 1e-5 — plus
   the global-atomics variant; K2 (staged top-k) at 8,192 test x 65,536
   train x 9 (the bench shape) and 65,536 test x 1,048,576 train x 9, with
   small k=128 and width-512 cases; K3 (fused top-k) bit-identical to K2
   on the normalized rows. The top-k gate (``compare_topk``): the ids are
   distinct train rows carrying the metrics reported, the metrics equal
   the plain version's within 1e-5 relative, every id that differs sits
   in a near-tie of the plain list (the (k+1)-th included), and the scaled
   ints are within 1;
3. the CLI path, in-process through ``avenir_tpu_torch.cli.main.main`` on
   CSVs written from the port's generators: BayesianDistribution +
   BayesianPredictor on churn (200,000 train / 50,000 test), NearestNeighbor
   on elearn (100,000 / 20,000) staged (K2) and chunked (K3) with
   byte-identical outputs, NearestNeighbor on churn with class-conditional
   weighting (K1 + K2), and small card-vs-CPU runs that must agree. Each
   job's validation accuracy must clear the tutorials' planted-signal bar,
   and each kernel must have launched in this phase. Every kernel call a
   job makes is recorded and held against its plain version on the same
   operands — the job's own shapes, each 4,096-row chunk and the ragged
   tail — and timed there.

Then one JSON line of per-kernel numbers, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SEED = 20261016
# the CLI phase's data sizes
CHURN_TRAIN, CHURN_TEST = 200_000, 50_000
ELEARN_TRAIN, ELEARN_TEST = 100_000, 20_000
FEED_CHUNK_ROWS = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_k1(dev, rng):
    from avenir_tpu_torch.ops import cuda_histogram as H
    n, f, c, b = 1_048_576, 5, 2, 5
    bins = rng.integers(-1, b + 1, size=(n, f)).astype(np.int32)  # some drop
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[rng.random(n) < 0.01] = c                              # some drop
    tb = torch.from_numpy(bins).to(dev)
    tl = torch.from_numpy(labels).to(dev)
    w01 = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    err = 0.0
    for name, w in (("unweighted", None), ("0/1 weights", w01)):
        got = H.class_feature_bin_counts(tb, tl, c, b, w)
        want = H.class_feature_bin_counts_plain(tb, tl, c, b, w)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {name} counts differ from plain")
    got = H.class_feature_bin_counts(tb, tl, c, b, wf)
    want = H.class_feature_bin_counts_plain(tb, tl, c, b, wf)
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError("K1 float-weighted counts beyond rtol 1e-5")
    err = float((got - want).abs().max())
    # the global-atomics variant: 64 * 8 * 128 int32 cells exceed 227 KB
    gb = torch.randint(-1, 129, (200_000, 64), dtype=torch.int32, device=dev)
    gl = torch.randint(0, 8, (200_000,), dtype=torch.int32, device=dev)
    if not torch.equal(H.class_feature_bin_counts(gb, gl, 8, 128),
                       H.class_feature_bin_counts_plain(gb, gl, 8, 128)):
        raise AssertionError("K1 global-atomics variant differs from plain")

    ms = cuda_ms(lambda: H.class_feature_bin_counts(tb, tl, c, b), 20)
    plain_ms = cuda_ms(lambda: H.class_feature_bin_counts_plain(tb, tl, c, b),
                       5)
    combined = (torch.arange(f, device=dev).reshape(1, f) * (c * b)
                + tl.long().reshape(n, 1) * b + tb.long())
    valid = (tb >= 0) & (tb < b) & (tl.reshape(n, 1) < c)
    flat = combined[valid]
    library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=f * c * b), 20)
    bound, by = bound_ms(n * (f + 1) * 4 + f * c * b * 4, n * f)
    log(f"phase 2 K1 counts n={n} f={f} c={c} b={b}: exact (unweighted, 0/1),"
        f" float weights max abs err {err:.3g} (rtol 1e-5), global variant "
        f"exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bincount "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "cfb_counts (K1)", "route": "cuda",
            "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def compare_topk(label, got, plain, x, y, y2, n_attrs):
    """Hold a kernel's top-k (metric [M, k], ids [M, k]) against its plain
    version on the same (normalized) operands. ``plain`` carries one column
    more than ``got`` wherever the train rows allow it: the (k+1)-th, for
    the near-tie rule. The tolerance of a row is 1e-5 relative to the scale
    of its terms, ``|x|² + |metric|``. Required:

    - the kernel's ids are distinct train rows, and the metric it reports
      for each is that row's metric recomputed here;
    - its metrics equal the plain version's, position by position;
    - every position where its id differs from the plain id is a near-tie
      of the plain list (within tolerance of the plain metric before or
      after it), and a row whose id set differs has its plain k-th and
      (k+1)-th metrics within tolerance;
    - the finalized scaled ints are within 1.

    Returns the counts of rows with other ids and with another id set, the
    max |metric| difference and the max |scaled int| difference."""
    from avenir_tpu_torch.ops.cuda_distance import finalize
    from avenir_tpu_torch.ops.distance import row_sq_norm
    kd, ki = got
    k = kd.shape[1]
    pd_all, pi_all = plain
    pd, pi = pd_all[:, :k], pi_all[:, :k]
    x2 = row_sq_norm(x)
    tol = 1e-5 * (x2.reshape(-1, 1) + pd_all.abs())
    if not torch.isfinite(kd).all():
        raise AssertionError(f"{label}: non-finite kernel metrics")
    if ((ki < 0) | (ki >= y.shape[0])).any():
        raise AssertionError(f"{label}: kernel ids outside the train rows")
    ids_sorted = ki.sort(dim=1).values
    if (ids_sorted[:, 1:] == ids_sorted[:, :-1]).any():
        raise AssertionError(f"{label}: a kernel id repeats within a row")
    rows = ki.long()
    recomputed = y2[rows] - 2.0 * (y[rows] * x.unsqueeze(1)).sum(-1)
    if not ((kd - recomputed).abs() <= tol[:, :k]).all():
        raise AssertionError(f"{label}: kernel metrics are not those of "
                             "its ids")
    if not ((kd - pd).abs() <= tol[:, :k]).all():
        raise AssertionError(f"{label}: metrics beyond 1e-5 relative")
    inf = torch.full_like(pd[:, :1], float("inf"))
    gap_prev = torch.cat([inf, pd[:, 1:] - pd[:, :-1]], dim=1)
    gap_next = (pd_all[:, 1:k + 1] - pd if pd_all.shape[1] > k else
                torch.cat([pd[:, 1:] - pd[:, :-1], inf], dim=1))
    tied = (gap_prev <= tol[:, :k]) | (gap_next <= tol[:, :k])
    differ = ki != pi
    if (differ & ~tied).any():
        raise AssertionError(
            f"{label}: {int((differ & ~tied).any(dim=1).sum())} rows with "
            "other ids where the plain metrics are no near-tie")
    set_differ = (ids_sorted != pi.sort(dim=1).values).any(dim=1)
    if set_differ.any():
        if pd_all.shape[1] == k:
            raise AssertionError(f"{label}: other id set with k = N")
        boundary = (pd_all[:, k] - pd_all[:, k - 1]) <= tol[:, k]
        if (set_differ & ~boundary).any():
            raise AssertionError(
                f"{label}: {int((set_differ & ~boundary).sum())} rows with "
                "another id set where the plain k-th and (k+1)-th metrics "
                "are no near-tie")
    ks, _ = finalize(kd, ki, x2, n_attrs, 1000)
    ps, _ = finalize(pd, pi, x2, n_attrs, 1000)
    err = int((ks - ps).abs().max())
    if err > 1:
        raise AssertionError(f"{label}: scaled ints differ by {err}")
    return {"rows": int(differ.any(dim=1).sum()),
            "sets": int(set_differ.sum()),
            "metric_err": float((kd - pd).abs().max()), "int_err": err}


def summary(c) -> str:
    return (f"{c['rows']} rows with other ids, all near-ties ({c['sets']} "
            f"with another id set), metric err {c['metric_err']:.3g}, "
            f"scaled-int err {c['int_err']}")


def plain_with_next(fn, x, y, y2, k, *scales):
    """A plain top-k with the (k+1)-th column where N allows it."""
    return fn(x, y, y2, *scales, min(k + 1, y.shape[0]))


def check_k2_k3(dev):
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_fused as F
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d, k = 9, 5
    results = {}

    def operands(m, n, width=d):
        x = torch.rand((m, width), generator=gen, device=dev)
        y = torch.rand((n, width), generator=gen, device=dev)
        return x, y, D.row_sq_norm(y)

    # bench shape: 8,192 test x 65,536 train
    m, n = 8192, 65536
    x, y, y2 = operands(m, n)
    c2 = compare_topk("K2 bench", D.topk_raw(x, y, y2, k),
                      plain_with_next(D.topk_raw_plain, x, y, y2, k),
                      x, y, y2, d)
    ms = cuda_ms(lambda: D.topk_raw(x, y, y2, k), 20)
    plain_ms = cuda_ms(lambda: D.topk_raw_plain(x, y, y2, k), 3)

    def library():
        return torch.topk(torch.cdist(x, y), k, dim=1, largest=False)

    library_ms = cuda_ms(library, 5)
    flops = 2.0 * m * n * d
    bound, by = bound_ms((m * d + n * d + n) * 4 + m * k * 8, flops)
    log(f"phase 2 K2 bench shape m={m} n={n} d={d} k={k}: {summary(c2)}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cdist+topk "
        f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by})")
    results["K2"] = {"name": "topk_staged (K2)", "route": "cuda",
                     "source": "avenir_tpu_torch/csrc/topk.cu",
                     "replaces": "avenir_tpu/ops/pallas_distance.py:165",
                     "max_abs_err": c2["metric_err"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms}

    # K3 on raw rows against K2 on the normalized rows: bit-identical
    mins = torch.rand(d, generator=gen, device=dev) * 50.0
    span = torch.rand(d, generator=gen, device=dev) * 200.0 + 1.0
    raw = torch.round(x * span + mins)
    staged = F.normalize(raw, mins, span)
    fd, fi = F.fused_topk_raw(raw, y, y2, mins, span, k)
    sd, si = D.topk_raw(staged, y, y2, k)
    if not (torch.equal(fd, sd) and torch.equal(fi, si)):
        raise AssertionError("K3 on raw rows is not bit-identical to K2 on "
                             "normalized rows")
    c3 = compare_topk("K3 bench", (fd, fi),
                      plain_with_next(F.fused_topk_raw_plain, raw, y, y2, k,
                                      mins, span), staged, y, y2, d)
    ms3 = cuda_ms(lambda: F.fused_topk_raw(raw, y, y2, mins, span, k), 20)
    plain3 = cuda_ms(lambda: F.fused_topk_raw_plain(raw, y, y2, mins, span,
                                                    k), 3)
    bound3, by3 = bound_ms((m * d + n * d + n + 2 * d) * 4 + m * k * 8,
                           flops + 2.0 * m * d)
    log(f"phase 2 K3 bench shape: bit-identical to K2 on normalized rows; "
        f"vs plain {summary(c3)}; kernel {ms3:.3f} ms, plain {plain3:.3f} "
        f"ms, bound {bound3:.3f} ms ({by3})")
    results["K3"] = {"name": "topk_fused (K3)", "route": "cuda",
                     "source": "avenir_tpu_torch/csrc/topk.cu",
                     "replaces": "avenir_tpu/ops/pallas_fused.py:52",
                     "max_abs_err": c3["metric_err"], "ms": ms3,
                     "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
                     "library_ms": None}

    # deployment scale: 65,536 test x 1,048,576 train
    m, n = 65536, 1_048_576
    x, y, y2 = operands(m, n)
    got = D.topk_raw(x, y, y2, k)
    t0 = time.perf_counter()
    want = plain_with_next(D.topk_raw_plain, x, y, y2, k)
    torch.cuda.synchronize()
    plain_big = (time.perf_counter() - t0) * 1e3
    c = compare_topk("K2 big", got, want, x, y, y2, d)
    ms_big = cuda_ms(lambda: D.topk_raw(x, y, y2, k), 3)
    bound_big, _ = bound_ms((m * d + n * d + n) * 4 + m * k * 8,
                            2.0 * m * n * d)
    log(f"phase 2 K2 scale m={m} n={n} d={d} k={k}: {summary(c)}; kernel "
        f"{ms_big:.2f} ms, plain (one call, host clock) {plain_big:.0f} ms, "
        f"bound {bound_big:.2f} ms (operations)")
    del x, y, y2, got, want

    # the edges of the supported range: k = 128, encoded width 512
    for m, n, width, kk in ((2048, 16384, d, 128), (1024, 8192, 512, 5),
                            (1024, 8192, 512, 128)):
        x, y, y2 = operands(m, n, width)
        c = compare_topk(f"K2 k={kk} width={width}", D.topk_raw(x, y, y2, kk),
                         plain_with_next(D.topk_raw_plain, x, y, y2, kk),
                         x, y, y2, width)
        mins = torch.rand(width, generator=gen, device=dev)
        span = torch.rand(width, generator=gen, device=dev) + 0.5
        raw = x * span + mins
        fused = F.fused_topk_raw(raw, y, y2, mins, span, kk)
        staged = D.topk_raw(F.normalize(raw, mins, span), y, y2, kk)
        if not all(torch.equal(a, b) for a, b in zip(fused, staged)):
            raise AssertionError(f"K3 != K2 at k={kk} width={width}")
        log(f"phase 2 K2/K3 m={m} n={n} width={width} k={kk}: {summary(c)}"
            "; K3 bit-identical to K2")
    return results


# --------------------------------------------------------------------------
# phase 3: the CLI path
# --------------------------------------------------------------------------

def write_csv(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")


def run_cli(args):
    """Run one CLI job in-process; return its last stdout JSON line."""
    from avenir_tpu_torch.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    if rc != 0:
        raise AssertionError(f"CLI {args[0]} returned {rc}")
    lines = [line for line in buf.getvalue().splitlines() if line.strip()]
    return json.loads(lines[-1]) if lines else {}


@contextlib.contextmanager
def recording(calls):
    """Record every call of the three kernel wrappers while the main path
    runs — its operands and the result the path went on with — so that
    each can be held against its plain version afterwards. The wrappers
    themselves run unchanged and count their launches: they count through
    their module-level name, which names the stand-in meanwhile, so the
    stand-in carries the count and hands it back on exit."""
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    sites = [(cuda_histogram, "class_feature_bin_counts", "K1"),
             (cuda_distance, "topk_raw", "K2"),
             (cuda_fused, "fused_topk_raw", "K3")]
    originals = [getattr(module, attr) for module, attr, _ in sites]

    def recorder(fn, name):
        signature = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append((name, dict(bound.arguments), out))
            return out
        call.launches = fn.launches
        return call

    stand_ins = [recorder(fn, name)
                 for (_, _, name), fn in zip(sites, originals)]
    for (module, attr, _), stand_in in zip(sites, stand_ins):
        setattr(module, attr, stand_in)
    try:
        yield
    finally:
        for (module, attr, _), fn, stand_in in zip(sites, originals,
                                                   stand_ins):
            fn.launches = stand_in.launches
            setattr(module, attr, fn)


def host_ms(fn):
    """Wall time of one call of ``fn``, the card synchronized around it,
    and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def hold_main_path(label, calls, n_attrs):
    """Hold each kernel call a job made against the plain version on the
    same operands (K1 exact, K2/K3 by ``compare_topk``, K3 also
    bit-identical to K2 on the normalized chunk), and time the kernels at
    the job's own shapes."""
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_fused as F
    from avenir_tpu_torch.ops import cuda_histogram as H
    for name in ("K1", "K2", "K3"):
        mine = [(a, out) for n, a, out in calls if n == name]
        if not mine:
            continue
        ms = plain_ms = n_bytes = n_ops = 0.0
        shapes, checks = [], []
        for a, out in mine:
            if name == "K1":
                n, f = a["bins"].shape
                cells = f * a["n_classes"] * a["n_bins"]
                n_bytes += n * (f + 1) * 4 + cells * 4
                n_ops += n * f
                w = a["weights"]
                plain_t, want = host_ms(
                    lambda: H.class_feature_bin_counts_plain(
                        a["bins"], a["labels"], a["n_classes"], a["n_bins"],
                        w))
                exact = w is None or bool(((w == 0) | (w == 1)).all())
                same = (torch.equal(out, want) if exact else
                        torch.allclose(out, want, rtol=1e-5, atol=0.0))
                if not same:
                    raise AssertionError(f"{label}: K1 counts differ from "
                                         "plain on the path's operands")
                ms += cuda_ms(lambda: H.class_feature_bin_counts(
                    a["bins"], a["labels"], a["n_classes"], a["n_bins"], w),
                    5)
                shapes.append("x".join(map(str, a["bins"].shape)))
                checks.append("exact" if exact else "rtol 1e-5")
                plain_ms += plain_t
                continue
            y, y2, k = a["y"], a["y2"], a["k"]
            if name == "K2":
                x = a["x"]
                plain_t, want = host_ms(lambda: plain_with_next(
                    D.topk_raw_plain, x, y, y2, k))
                ms += cuda_ms(lambda: D.topk_raw(x, y, y2, k), 5)
            else:
                raw, mins, span = a["x_raw"], a["mins"], a["span"]
                x = F.normalize(raw, mins, span)
                if not all(torch.equal(p, q) for p, q in
                           zip(out, D.topk_raw(x, y, y2, k))):
                    raise AssertionError(f"{label}: K3 is not bit-identical"
                                         " to K2 on the normalized chunk")
                plain_t, want = host_ms(lambda: plain_with_next(
                    F.fused_topk_raw_plain, raw, y, y2, k, mins, span))
                ms += cuda_ms(lambda: F.fused_topk_raw(raw, y, y2, mins,
                                                       span, k), 5)
            plain_ms += plain_t
            checks.append(compare_topk(f"{label} {name}", out, want, x, y,
                                       y2, n_attrs))
            (m, d), n = x.shape, y.shape[0]
            n_bytes += (m * d + n * d + n) * 4 + m * k * 8
            n_ops += 2.0 * m * n * d
            if name == "K3":
                n_bytes += 2 * d * 4
                n_ops += 2.0 * m * d
            shapes.append(f"{m}x{n}x{d}")
        if name == "K1":
            verdict = ", ".join(sorted(set(checks)))
        else:
            verdict = summary({
                "rows": sum(c["rows"] for c in checks),
                "sets": sum(c["sets"] for c in checks),
                "metric_err": max(c["metric_err"] for c in checks),
                "int_err": max(c["int_err"] for c in checks)})
            if name == "K3":
                verdict += "; bit-identical to K2 on each normalized chunk"
        bound, by = bound_ms(n_bytes, n_ops)
        log(f"phase 3 {label}: {name} on the path's operands, {len(mine)} "
            f"call(s) [{', '.join(shapes)}]: {verdict}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms (host clock), bound {bound:.3f} ms "
            f"({by})")


def cli_phase(work: str):
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    counters = {"K1": cuda_histogram.class_feature_bin_counts,
                "K2": cuda_distance.topk_raw,
                "K3": cuda_fused.fused_topk_raw}
    totals = {name: 0 for name in counters}

    def job(label, args, bar, must_launch, n_attrs=None):
        calls = []
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with recording(calls):
            report = run_cli(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        for name, c in counts.items():
            totals[name] += c
        missing = [name for name in must_launch if counts[name] < 1]
        if missing:
            raise AssertionError(f"{label}: {missing} not launched")
        acc = report.get("Validation.Accuracy")
        if bar is not None and not (acc is not None and acc > bar):
            raise AssertionError(f"{label}: accuracy {acc} not above {bar}")
        log(f"phase 3 {label}: {secs:.2f} s, launches {counts}"
            + (f", accuracy {acc:.4f} (bar {bar})" if bar else ""))
        hold_main_path(label, calls, n_attrs)
        return report

    p = lambda name: os.path.join(work, name)  # noqa: E731
    churn = G.churn_rows(CHURN_TRAIN + CHURN_TEST, seed=SEED)
    write_csv(p("churn_train.csv"), churn[:CHURN_TRAIN])
    write_csv(p("churn_test.csv"), churn[CHURN_TRAIN:])
    write_csv(p("churn_small.csv"), churn[:2000])
    with open(p("churn.json"), "w") as fh:
        json.dump(G._CHURN_SCHEMA_JSON, fh)
    with open(p("churn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\nfield.delim=,\n"
                 f"feature.schema.file.path={p('churn.json')}\n"
                 f"bayesian.model.file.path={p('model.txt')}\n"
                 f"train.data.path={p('churn_train.csv')}\n"
                 "validation.mode=true\npositive.class.value=closed\n"
                 "laplace.smoothing=1.0\n")
    elearn = G.elearn_rows(ELEARN_TRAIN + ELEARN_TEST, seed=SEED)
    write_csv(p("elearn_train.csv"), elearn[:ELEARN_TRAIN])
    write_csv(p("elearn_test.csv"), elearn[ELEARN_TRAIN:])
    with open(p("elearn.json"), "w") as fh:
        json.dump(G.elearn_schema_json(), fh)
    with open(p("knn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\n"
                 f"feature.schema.file.path={p('elearn.json')}\n"
                 f"train.data.path={p('elearn_train.csv')}\n"
                 "top.match.count=5\nkernel.function=none\n"
                 "distance.scale=1000\nvalidation.mode=true\n"
                 "positive.class.value=fail\n")
    from avenir_tpu_torch.utils.schema import FeatureSchema
    churn_attrs = len(FeatureSchema.from_json(
        G._CHURN_SCHEMA_JSON).get_feature_fields())
    elearn_attrs = len(FeatureSchema.from_json(
        G.elearn_schema_json()).get_feature_fields())
    churn_conf = ["--conf", p("churn.properties")]
    knn_conf = ["--conf", p("knn.properties")]

    # the tutorials' planted-signal bars (tests/test_tutorials.py)
    job(f"BayesianDistribution churn {CHURN_TRAIN} rows",
        ["BayesianDistribution", p("churn_train.csv"), p("model.txt")]
        + churn_conf, None, ["K1"])
    job(f"BayesianPredictor churn {CHURN_TEST} rows",
        ["BayesianPredictor", p("churn_test.csv"), p("pred.txt")]
        + churn_conf, 0.75, [])
    shape = f"{ELEARN_TRAIN}x{ELEARN_TEST}"
    job(f"NearestNeighbor elearn {shape} staged",
        ["NearestNeighbor", p("elearn_test.csv"), p("knn_staged.txt")]
        + knn_conf, 0.8, ["K2"], n_attrs=elearn_attrs)
    job(f"NearestNeighbor elearn {shape} feed.chunk.rows={FEED_CHUNK_ROWS}",
        ["NearestNeighbor", p("elearn_test.csv"), p("knn_fused.txt")]
        + knn_conf + ["-D", f"feed.chunk.rows={FEED_CHUNK_ROWS}"], 0.8,
        ["K3"], n_attrs=elearn_attrs)
    with open(p("knn_staged.txt"), "rb") as a, \
            open(p("knn_fused.txt"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("staged (K2) and fused (K3) KNN outputs "
                                 "differ")
    log("phase 3 staged (K2) and chunked fused (K3) outputs byte-identical")
    job(f"NearestNeighbor churn {CHURN_TRAIN}x{CHURN_TEST} "
        "class.condtion.weighted",
        ["NearestNeighbor", p("churn_test.csv"), p("knn_churn.txt")]
        + churn_conf + ["-D", "class.condtion.weighted=true"], 0.75,
        ["K1", "K2"], n_attrs=churn_attrs)

    # card against CPU on a small input: same files
    small = G.elearn_rows(2500, seed=SEED + 1)
    write_csv(p("small_train.csv"), small[:2000])
    write_csv(p("small_test.csv"), small[2000:])
    outs = {}
    for dev in ("cuda", "cpu"):
        from avenir_tpu_torch.cli.main import main
        with contextlib.redirect_stdout(io.StringIO()):
            main(["NearestNeighbor", p("small_test.csv"), p(f"s_{dev}.txt"),
                  *knn_conf, "-D", f"train.data.path={p('small_train.csv')}",
                  "--device", dev])
            main(["BayesianDistribution", p("churn_small.csv"),
                  p(f"m_{dev}.txt"), *churn_conf, "--device", dev])
        outs[dev] = [open(p(f"{name}_{dev}.txt")).read()
                     for name in ("s", "m")]
    knn_rows = list(zip(outs["cuda"][0].splitlines(),
                        outs["cpu"][0].splitlines()))
    n_diff = sum(a != b for a, b in knn_rows)
    if n_diff > 0.01 * len(knn_rows) or outs["cuda"][1] != outs["cpu"][1]:
        raise AssertionError(f"card and CPU disagree: {n_diff} KNN rows, "
                             f"model equal {outs['cuda'][1] == outs['cpu'][1]}")
    log(f"phase 3 card vs CPU (elearn 2000x500 KNN, churn 2000-row NB): "
        f"KNN rows differing {n_diff}, NB model files identical")
    log(f"kernels {json.dumps(totals)}")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({lib_path.name} "
        f"from {len(_build.sources())} sources, sm_90a)")

    rng = np.random.default_rng(SEED)
    k1 = check_k1(dev, rng)
    k23 = check_k2_k3(dev)
    work = tempfile.mkdtemp(prefix="smoke-", dir=str(_build.BUILD_DIR))
    try:
        launches = cli_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name, entry in (("K1", k1), ("K2", k23["K2"]), ("K3", k23["K3"])):
        entry = dict(entry)
        entry["launches"] = launches[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
