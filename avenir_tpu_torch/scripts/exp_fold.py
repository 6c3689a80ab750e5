"""The lane-bucket fold top-k experiment, on the port: K6
(``ops.cuda_fold.acc_fold``) in place of the TPU's ``_acc_kernel``.

Instead of k exact extractions per train tile, keep ``n_acc·128``
lane-bucketed running minima (value and train column) over the whole train
sweep and extract k once. For each (n_acc, tile_n) configuration of the
JAX experiment this prints the rows/s of the kernel on resident operands
and its recall against the exact f32 top-k (the port's exact plain top-k on
the CPU, K2 on the card), with the operands rounded to bf16 before the
product (as the experiment runs it) and without, and the time a call of
each arm (on the card: bf16 on the tensor cores, f32 on the CUDA cores).

    python -m avenir_tpu_torch.scripts.exp_fold [--device cpu] [--m M] ...
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_distance, cuda_fold
from avenir_tpu_torch.ops.distance import pairwise_topk_raw, row_sq_norm
from avenir_tpu_torch.scripts._timing import chain_ms, clock_label
from avenir_tpu_torch.utils.device import resolve_device

M, N, D, K = 8192, 65536, 9, 5
#: (n_acc, tile_n), as the JAX experiment runs them
CONFIGS = ((2, 4096), (4, 4096), (4, 6144), (8, 4096), (4, 8192))


def _operand(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(dev).contiguous()


def acc_topk(x, y, *, k: int, tile_m: int = 512, tile_n: int = 4096,
             n_acc: int = 4, use_bf16: bool = True, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest ``|y|² − 2·x·y`` of each test row by the lane-bucket
    fold: (metric ``[m, k]`` f32, train column ``[m, k]`` int32). x
    ``[m, D]`` and y ``[N, D]`` are tensors or arrays; they run on
    ``device``, by default x's device (``cuda`` for an array). ``tile_m``
    and ``tile_n`` are the JAX kernel's tiles: ``tile_n`` must be a
    multiple of ``n_acc·128``, and neither changes the result."""
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    x, y = _operand(x, dev), _operand(y, dev)
    out_d, out_i = cuda_fold.acc_fold(x, y, row_sq_norm(y), k=k,
                                      n_acc=n_acc, tile_n=tile_n,
                                      use_bf16=use_bf16)
    return out_d[:, :k], out_i[:, :k]


def exact_ids(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """Train columns of the exact f32 top-k: K2 on the card, the exact
    plain top-k on the CPU."""
    if x.device.type == "cuda":
        return cuda_distance.topk_raw(x, y, row_sq_norm(y), k)[1]
    return pairwise_topk_raw(x, y, k=k, mode="exact")[1]


def recall(exact: torch.Tensor, got: torch.Tensor) -> float:
    """Share of the exact ids found among ``got``, row by row (``got`` may
    hold more columns than ``exact``, and an id more than once)."""
    hits = (exact.unsqueeze(2) == got.unsqueeze(1)).any(dim=2).sum()
    return float(hits) / exact.numel()


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=M)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--d", type=int, default=D)
    p.add_argument("--k", type=int, default=K)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, d, k = args.m, args.n, args.d, args.k
    rng = np.random.default_rng(0)
    x = _operand(rng.random((m, d), dtype=np.float32), dev)
    y = _operand(rng.random((n, d), dtype=np.float32), dev)
    y2 = row_sq_norm(y)
    exact = exact_ids(x, y, k)
    print(f"# exp_fold: {m} test x {n} train, D={d}, k={k}; "
          f"{clock_label(dev)}", flush=True)
    results = []
    for n_acc, tile_n in CONFIGS:
        r_bf16 = recall(exact, acc_topk(x, y, k=k, tile_n=tile_n,
                                        n_acc=n_acc)[1])
        r_f32 = recall(exact, acc_topk(x, y, k=k, tile_n=tile_n,
                                       n_acc=n_acc, use_bf16=False)[1])
        ms, ms_f32 = (chain_ms(lambda bf16=bf16: cuda_fold.acc_fold(
            x, y, y2, k=k, n_acc=n_acc, tile_n=tile_n, use_bf16=bf16), dev)
            for bf16 in (True, False))
        rows = m / (ms / 1e3)
        print(f"n_acc={n_acc} tile_n={tile_n:5d}  {rows / 1e6:8.3f} M rows/s"
              f"  {ms:.4f} ms  recall={r_bf16:.4f}  f32 {ms_f32:.4f} ms  "
              f"recall_f32={r_f32:.4f}", flush=True)
        results.append({"n_acc": n_acc, "tile_n": tile_n, "ms": ms,
                        "ms_f32": ms_f32, "rows_per_s": rows,
                        "recall": r_bf16, "recall_f32": r_f32})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
