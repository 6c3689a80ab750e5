"""Roofline decomposition of the KNN kernel on the card.

Times K2, the production distance top-k, beside kernels that each isolate
one part of its work, at the JAX decomposition's shape, and reports each
against the H100's ceilings:

  full        K2 (``ops.cuda_distance.topk_raw``): f32 dot + exact top-k
  full-sweep  K2 without its selection (``topk_sweep_min``): K2's launch,
              tiles and product sweep, one running minimum per row
  full-nodot  K2 without its product (``topk_nodot_raw``): K2's launch,
              top-k lists, splits and merge over ``|y2[col] − Σ x[r]|``,
              whose order of the columns differs from row to row
  dotmin      K7: the bf16-rounded dot with the cheapest consumption, one
              minimum per (row, column), no index
  nodot       K8: the indexed bucket fold and extraction, the product
              replaced by a broadcast ``y2[col] + Σ x[r]``
  tpose       K9: the bucket fold over feature-major operands
  plain       ``ops.distance.pairwise_topk(mode="fast")``, the plain
              PyTorch path (it stands where the JAX script's ``xla``
              stood); it repeats the arithmetic and is no yardstick of speed
  library     ``torch.cdist`` + ``torch.topk``, timed beside the kernels
              and never called by the port

A ``full-sweep`` close to ``full`` puts K2's time in its product sweep, a
``full-nodot`` close to ``full`` in its selection. ``dotmin``, ``nodot``
and ``tpose`` split the JAX experiment's fold kernels the same way, with
designs of their own (``csrc/fold.cu``), so they speak of the fold
family, not of K2: ``dotmin`` runs its product on the tensor cores (bf16
``mma.sync``, the minimum on the accumulator fragments), the product + the
cheapest fold on this card; ``nodot`` and ``tpose`` keep one thread per
bucket on the CUDA cores.

Ceilings, computed at run time on the card: the f32 product at 67 TFLOP/s
on the CUDA cores, ``67e12 / (2·D)`` pairs/s; the fold at SMs × 128 lanes ×
the maximum SM clock (``nvidia-smi``) over ``FOLD_OPS_PER_PAIR``; device
memory at 3.35 TB/s over the bytes each variant must move (inputs read
once, outputs written once — the train set's re-reads are served by the
50 MB L2 where it fits).

    python -m avenir_tpu_torch.scripts.roofline_knn [--device cpu] ...
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_distance, cuda_fold
from avenir_tpu_torch.ops.distance import pairwise_topk, row_sq_norm
from avenir_tpu_torch.ops.fold import LANES
from avenir_tpu_torch.scripts._timing import chain_ms, clock_label
from avenir_tpu_torch.utils.device import resolve_device

N_TRAIN = 65536
M_TEST = 8192
D = 9
K = 5
TILE_N, N_ACC = 4096, 4
VARIANTS = ("full", "full-sweep", "full-nodot", "dotmin", "nodot", "tpose",
            "plain", "library")

# H100 SXM (NVIDIA data sheet): f32 off the tensor cores, HBM3, L2
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
#: the fold's f32 instructions per (row, column) pair: the metric (one op
#: once the dot is summed), the compare, the value select, the index select
FOLD_OPS_PER_PAIR = 4


def launch(variant: str, x: torch.Tensor, y: torch.Tensor, *,
           y2: Optional[torch.Tensor] = None,
           xt: Optional[torch.Tensor] = None,
           yt: Optional[torch.Tensor] = None):
    """One call of ``variant`` on test x ``[M, D]`` and train y ``[N, D]``
    (``y2 = |y|²`` and the feature-major ``xt``, ``yt`` are derived when not
    given): its outputs, (values, ids or None)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    if y2 is None:
        y2 = row_sq_norm(y)
    if variant == "full":
        return cuda_distance.topk_raw(x, y, y2, K)
    if variant == "full-sweep":
        return cuda_distance.topk_sweep_min(x, y, y2), None
    if variant == "full-nodot":
        return cuda_distance.topk_nodot_raw(x, y2, K)
    if variant == "dotmin":
        return cuda_fold.dotmin(x, y, y2), None
    if variant == "nodot":
        return cuda_fold.nodot_fold(x, y2, k=K, n_acc=N_ACC, tile_n=TILE_N)
    if variant == "tpose":
        xt = x.T.contiguous() if xt is None else xt
        yt = y.T.contiguous() if yt is None else yt
        return cuda_fold.tpose_fold(xt, yt, y2, k=K, n_acc=N_ACC,
                                    tile_n=TILE_N)
    if variant == "plain":
        return pairwise_topk(x, y, k=K, mode="fast")
    values, ids = torch.topk(torch.cdist(x, y), K, dim=1, largest=False)
    return values, ids


def moved_bytes(variant: str, m: int, n: int, d: int) -> float:
    """Bytes the variant must move: each input read once, each output
    written once."""
    x_bytes, y_bytes, y2_bytes = m * d * 4, n * d * 4, n * 4
    if variant == "full-sweep":
        return x_bytes + y_bytes + y2_bytes + m * 4
    if variant == "full-nodot":
        return x_bytes + y2_bytes + m * K * 8
    if variant == "dotmin":
        return x_bytes + y_bytes + y2_bytes + m * LANES * 4
    if variant == "nodot":
        return x_bytes + y2_bytes + m * LANES * 8
    if variant == "tpose":
        return x_bytes + y_bytes + y2_bytes + m * LANES * 8
    return x_bytes + y_bytes + y2_bytes + m * K * 8


def max_sm_clock_hz(dev: torch.device) -> float:
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def lane_ops_per_s(dev: torch.device) -> float:
    """f32 instructions a second on the card's CUDA cores: SMs × 128 lanes
    × the maximum SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 128 * max_sm_clock_hz(dev)


def ceilings(dev: torch.device, d: int) -> dict:
    """The card's pairs/s ceilings for the product and the fold."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lane = lane_ops_per_s(dev)
    return {"dot_pairs_per_s": PEAK_F32_FLOPS / (2 * d),
            "fold_pairs_per_s": lane / FOLD_OPS_PER_PAIR,
            "sms": sms, "clock_hz": lane / (sms * 128)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=M_TEST)
    p.add_argument("--n", type=int, default=N_TRAIN)
    p.add_argument("--d", type=int, default=D)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, d = args.m, args.n, args.d
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dev)
    x = torch.from_numpy(rng.random((m, d), dtype=np.float32)).to(dev)
    operands = {"y2": row_sq_norm(y), "xt": x.T.contiguous(),
                "yt": y.T.contiguous()}
    ceil = ceilings(dev, d) if dev.type == "cuda" else None
    train_mb = n * d * 4 / 1e6
    print(f"# roofline_knn: {m} test x {n} train, D={d}, k={K}, n_acc="
          f"{N_ACC}, tile_n={TILE_N}; {clock_label(dev)}", flush=True)
    if ceil:
        print(f"# ceilings: f32 dot {ceil['dot_pairs_per_s']:.3e} pairs/s "
              f"(67 TFLOP/s / 2D), fold {ceil['fold_pairs_per_s']:.3e} "
              f"pairs/s ({ceil['sms']} SMs x 128 lanes x "
              f"{ceil['clock_hz'] / 1e9:.3f} GHz / {FOLD_OPS_PER_PAIR} ops), "
              f"memory 3.35 TB/s; train set {train_mb:.1f} MB "
              f"{'in' if train_mb * 1e6 <= L2_BYTES else 'beyond'} the "
              "50 MB L2", flush=True)
    results = []
    for variant in VARIANTS:
        ms = chain_ms(lambda: launch(variant, x, y, **operands), dev)
        pairs = m * n / (ms / 1e3)
        row = {"variant": variant, "ms": ms, "rows_per_s": m / (ms / 1e3),
               "pairs_per_s": pairs}
        line = (f"{variant:10s} {ms:9.4f} ms  {row['rows_per_s'] / 1e6:8.3f} "
                f"M rows/s  {pairs:.3e} pairs/s")
        if ceil:
            row["dot_share"] = pairs / ceil["dot_pairs_per_s"]
            row["fold_share"] = pairs / ceil["fold_pairs_per_s"]
            row["memory_share"] = (moved_bytes(variant, m, n, d)
                                   / PEAK_BYTES_PER_S) / (ms / 1e3)
            line += (f"  {row['dot_share']:6.1%} f32-dot  "
                     f"{row['fold_share']:6.1%} fold  "
                     f"{row['memory_share']:6.2%} memory")
        else:
            line += "  shares not measured (cpu)"
        if variant == "plain":
            line += "  (plain PyTorch, no yardstick)"
        elif variant == "library":
            line += "  (cdist + topk, never called by the port)"
        print(line, flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
