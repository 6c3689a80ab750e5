"""What the kernel-restructure sweeps share (``sweep11_vmem`` to
``sweep18_tpose_fold``): the one copy of what their JAX counterparts under
``scripts/`` each repeat.

- the shape and the data: 8,192 test × 65,536 train × 9 uniform features
  from ``numpy.random.default_rng(0)``, train drawn first;
- the operand encoders: :func:`quant` (symmetric int8), the augmented int8
  operands whose product is ``y² − 2·x·y`` itself
  (:func:`int8_aug_operands`, :func:`int8_centered_operands`) and the bf16
  hi + lo split of ``y²`` (:func:`bf16_hi_lo`);
- :func:`launch_fold`, which sends a pair of built operands to the fold
  kernel of their type (K6, K10, K11 or K12);
- what runs outside any kernel: :func:`finalize_f32`, :func:`finalize_int`,
  :func:`exact_rerank`;
- :func:`gate`: recall and matched-neighbor distance error against the
  exact top-k on the first 512 test rows, with 16c's candidate coverage;
- :func:`time_arms` and :func:`print_medians`: the interleaved differential
  timing (:mod:`avenir_tpu_torch.scripts._timing`) and its report.

The encoders are written as the JAX ones, operation by operation in f32 and
int32, so that the same inputs give the same encoded operands. They pad
nothing: for the fold kernels columns past N do not exist
(:mod:`avenir_tpu_torch.ops.cuda_fold`).
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops.cuda_distance import pairwise_topk_cuda
from avenir_tpu_torch.ops.distance import INT_BIG, pairwise_topk, row_sq_norm
from avenir_tpu_torch.scripts import _timing
from avenir_tpu_torch.scripts.exp_fold import recall as recall_of
from avenir_tpu_torch.utils.device import resolve_device

N_TRAIN = 65536
M_TEST = 8192
D = 9
K = 5
#: candidates the int8 arms hand to the exact re-rank
K_CAND = 16
ITERS_LO, ITERS_HI = 25, 100
TILE_M, TILE_N, N_ACC = 1024, 4096, 4
SCALE = 1000
GATE_ROWS = 512
RECALL_GATE = 0.985
DIST_ERR_GATE = 25
#: int8 columns that carry ``y² div 127`` against a constant 127
Y2_DIGITS = 9
#: the largest |metric| the augmented int8 operands can give: −2·x8 within
#: ±126 against y8 within ±63, the remainder below 127 against 1, the digits
#: up to 127 against 127 — below the packed fold's 2**18
AUG_METRIC_BOUND = D * 126 * 63 + 126 + Y2_DIGITS * 127 * 127

TopK = Callable[[torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


def parse_args(doc: str, argv: Optional[List[str]]):
    """The harnesses' arguments: (device, m, n)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=M_TEST)
    p.add_argument("--n", type=int, default=N_TRAIN)
    args = p.parse_args(argv)
    return resolve_device(args.device), args.m, args.n


def make_data(m: int, n: int, dev: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(test ``[m, 9]``, train ``[n, 9]``) on ``dev``, as the JAX sweeps
    draw them: seed 0, train first."""
    rng = np.random.default_rng(0)
    train = torch.from_numpy(rng.random((n, D), dtype=np.float32)).to(dev)
    test = torch.from_numpy(rng.random((m, D), dtype=np.float32)).to(dev)
    return test, train


def prod_topk(x: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchor of every sweep: the production top-k, K2."""
    return pairwise_topk_cuda(x, y, k=K)


# --------------------------------------------------------------------------
# operand encoders
# --------------------------------------------------------------------------

def quant(x: torch.Tensor, y: torch.Tensor, qmax: float):
    """Symmetric int8 quantization of both sides at one scale:
    ``(x8, y8, s)``, ``s = qmax / max(|x|, |y|)``."""
    s = qmax / torch.maximum(x.abs().max(), y.abs().max())
    return (torch.round(x * s).to(torch.int8),
            torch.round(y * s).to(torch.int8), s)


def _int8_sq_norm(a8: torch.Tensor) -> torch.Tensor:
    a = a8.to(torch.int32)
    return (a * a).sum(dim=1, dtype=torch.int32)


def _augment_int8(x8: torch.Tensor, y8: torch.Tensor):
    """Quantized rows within ±63 → the width-19 operands whose product is
    ``y2 − 2·x8·y8``: xa = ``[−2·x8 | 1 | 127 × 9]``, ya = ``[y8 | y2 mod
    127 | (y2 div 127 + i) div 9, i = 0..8]``. The nine digits sum to
    ``y2 div 127`` exactly, each at most 127."""
    m = x8.shape[0]
    dev = x8.device
    xa = torch.cat([
        (-2 * x8.to(torch.int32)).to(torch.int8),
        torch.ones((m, 1), dtype=torch.int8, device=dev),
        torch.full((m, Y2_DIGITS), 127, dtype=torch.int8, device=dev)], dim=1)
    y2 = _int8_sq_norm(y8)
    q = torch.div(y2, 127, rounding_mode="floor")
    r = y2 - q * 127
    digits = torch.stack([torch.div(q + i, Y2_DIGITS, rounding_mode="floor")
                          for i in range(Y2_DIGITS)], dim=1)
    ya = torch.cat([y8, r.to(torch.int8).reshape(-1, 1),
                    digits.to(torch.int8)], dim=1)
    return xa.contiguous(), ya.contiguous()


def int8_aug_operands(x: torch.Tensor, y: torch.Tensor):
    """``(xa, ya, s)``: quantized at scale 63 (the −2 rides the x side, so
    ±126 must fit) and augmented (:func:`_augment_int8`)."""
    x8, y8, s = quant(x, y, 63.0)
    return (*_augment_int8(x8, y8), s)


def int8_centered_operands(x: torch.Tensor, y: torch.Tensor):
    """As :func:`int8_aug_operands` after centering both sides jointly:
    squared distance does not see a translation, and the range ±63 then
    spans the data's whole extent."""
    lo = torch.minimum(x.min(), y.min())
    hi = torch.maximum(x.max(), y.max())
    mid = 0.5 * (lo + hi)
    s = 63.0 / torch.clamp(0.5 * (hi - lo), min=1e-12)
    x8 = torch.round((x - mid) * s).to(torch.int8)
    y8 = torch.round((y - mid) * s).to(torch.int8)
    return (*_augment_int8(x8, y8), s)


def bf16_hi_lo(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → (hi, lo), both bf16-representable and kept in f32: hi the
    value rounded to bf16, lo the rounded remainder; hi + lo is within 2⁻¹⁶
    relative of the value."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    lo = (v - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def aug_operands(x: torch.Tensor, y: torch.Tensor):
    """The f32 augmented operands of ``augv2`` and ``tpose_aug``, width
    D + 2: xa = ``[x | 1 | 1]``, ya = ``[−2·y | y2hi | y2lo]``, so that
    their product is ``y2 − 2·x·y`` with ``y2`` to 16 bits."""
    ones = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    y2hi, y2lo = bf16_hi_lo(row_sq_norm(y).reshape(-1, 1))
    return (torch.cat([x, ones, ones], dim=1),
            torch.cat([-2.0 * y, y2hi, y2lo], dim=1))


def launch_fold(xa: torch.Tensor, ya: torch.Tensor, *, k: int,
                y2: Optional[torch.Tensor] = None, packed: bool = False,
                n_acc: int = N_ACC
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Built operands → raw ``[M, 128]`` fold outputs, by their type: int8
    to K11 (``y2``: its int32 epilogue) or, ``packed``, K12; f32 or bf16
    with ``y2`` to K6 (the product metric with an f32 epilogue), without
    to K10 (the raw product)."""
    tiles = dict(k=k, n_acc=n_acc, tile_n=TILE_N)
    if xa.dtype == torch.int8:
        if packed:
            return cuda_fold.packed_fold(xa, ya, metric_bound=AUG_METRIC_BOUND,
                                         **tiles)
        return cuda_fold.int8_fold(xa, ya, y2, **tiles)
    if y2 is not None:
        return cuda_fold.acc_fold(xa, ya, y2, **tiles)
    return cuda_fold.raw_fold(xa, ya, **tiles)


# --------------------------------------------------------------------------
# outside the kernels
# --------------------------------------------------------------------------

def _scaled(sq: torch.Tensor, found: torch.Tensor, ids: torch.Tensor):
    scaled = torch.round(torch.sqrt(sq) * SCALE).to(torch.int32)
    return (torch.where(found, scaled, torch.full_like(scaled, INT_BIG)),
            torch.where(found, ids, torch.full_like(ids, -1)))


def finalize_f32(raw_d: torch.Tensor, raw_i: torch.Tensor, x2: torch.Tensor):
    """Raw f32 metric ``[M, k]`` → scaled-int distances ``rint(sqrt(max(d +
    |x|², 0) / D) · 1000)``; (INT_BIG, −1) where nothing was found."""
    sq = torch.clamp(raw_d + x2.reshape(-1, 1), min=0.0) / D
    return _scaled(sq, raw_i >= 0, raw_i)


def finalize_int(raw_d: torch.Tensor, raw_i: torch.Tensor, x2_i: torch.Tensor,
                 s: torch.Tensor):
    """Raw int32 metric of operands quantized at scale ``s`` → the same
    scaled-int distances."""
    sq = torch.clamp(raw_d + x2_i.reshape(-1, 1), min=0) \
        .to(torch.float32) / (s * s) / D
    return _scaled(sq, raw_i >= 0, raw_i)


def exact_rerank(x: torch.Tensor, y: torch.Tensor, cand_i: torch.Tensor,
                 k: int):
    """Exact f32 distances of each row's candidates ``[M, C]`` (−1: none),
    then the true top-k of them. A stable sort takes the lowest candidate
    position on ties, as ``lax.top_k`` does."""
    g = y[cand_i.clamp(min=0).long()]                        # [M, C, D]
    d2 = ((x.unsqueeze(1) - g) ** 2).sum(dim=2)
    d2 = torch.where(cand_i >= 0, d2, torch.full_like(d2, float("inf")))
    best, sel = torch.sort(d2, dim=1, stable=True)
    best, sel = best[:, :k], sel[:, :k]
    idx = torch.gather(cand_i, 1, sel)
    return _scaled(torch.clamp(best, min=0.0) / D, idx >= 0, idx)


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

def exact_topk(test: torch.Tensor, train: torch.Tensor):
    """The exact top-k the gates compare with, on the first 512 test rows:
    (scaled-int distances, ids)."""
    return pairwise_topk(test[:GATE_ROWS], train, k=K, mode="exact")


def gate(name: str, topk: TopK, test: torch.Tensor, train: torch.Tensor,
         cand_fn: Optional[Callable] = None) -> Dict[str, object]:
    """Run ``topk`` on the first 512 test rows and hold it against the
    exact top-k: ``recall`` (≥ 0.985 to pass) and ``dist_err``, the largest
    difference of scaled distance over the neighbors both lists name (≤ 25
    to pass; ``matched`` counts them). ``cand_fn`` returns (d, i,
    candidates): ``coverage`` is then the share of exact neighbors among
    the candidates handed to the re-rank. Prints one line."""
    d_ex, i_ex = exact_topk(test, train)
    d_c, i_c = topk(test[:GATE_ROWS], train)
    same = i_c.unsqueeze(2) == i_ex.unsqueeze(1)             # [R, kc, ke]
    diff = (d_c.unsqueeze(2).to(torch.float64)
            - d_ex.unsqueeze(1).to(torch.float64)).abs().round()
    err = int(diff[same].max()) if same.any() else 0
    out = {"name": name, "recall": recall_of(i_ex, i_c), "dist_err": err,
           "matched": int(same.any(dim=2).sum())}
    line = (f"gate {name:10s} recall={out['recall']:.4f} dist_err={err} "
            f"(n={out['matched']})")
    if cand_fn is not None:
        out["coverage"] = recall_of(i_ex, cand_fn(test[:GATE_ROWS],
                                                  train)[2])
        line += f" candidate_coverage={out['coverage']:.4f}"
    out["ok"] = out["recall"] >= RECALL_GATE and err <= DIST_ERR_GATE
    print(line, flush=True)
    return out


def gate_arms(arms: Mapping[str, TopK], test, train) -> Dict[str, dict]:
    """Every arm through :func:`gate`; the anchor ``prod`` must pass."""
    gates = {name: gate(name, fn, test, train) for name, fn in arms.items()}
    if not gates["prod"]["ok"]:
        raise SystemExit("anchor failed its own gate")
    return gates


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_arms(arms: Mapping[str, TopK], test, train, *, rounds: int,
              by_phase: bool = False) -> Dict[str, List[float]]:
    """Microseconds a call of each arm's whole function (operand encoders, kernel,
    finalize or re-rank, as the JAX sweeps time them) in each round, by the
    interleaved differential protocol; prints each round."""
    per_round = _timing.differential_rounds(
        {name: (lambda fn=fn: fn(test, train)) for name, fn in arms.items()},
        test.device, rounds=rounds, lo=ITERS_LO, hi=ITERS_HI,
        by_phase=by_phase)
    for r in range(rounds):
        print(f"round {r}: " + "  ".join(
            f"{name} {times[r]:8.1f}" for name, times in per_round.items())
            + " us/iter", flush=True)
    return per_round


def print_medians(per_round: Mapping[str, List[float]], m: int,
                  marks: Optional[Mapping[str, str]] = None) -> List[dict]:
    """One line an arm, fastest first: median µs a call, the median of the
    per-round ratios against ``prod``, test rows a second; the rows as
    dicts."""
    ratios = _timing.ratio_medians(per_round, "prod")
    med = {name: statistics.median(t) for name, t in per_round.items()}
    rows = []
    for name in sorted(med, key=med.get):
        line = (f"{name:10s} {med[name]:8.1f} us/iter   med-ratio "
                f"{ratios[name]:5.3f}x prod   {m / med[name]:7.2f}M rows/s")
        if marks:
            line += f"   [{marks[name]}]"
        print(line, flush=True)
        rows.append({"arm": name, "us": med[name], "ratio": ratios[name]})
    return rows
