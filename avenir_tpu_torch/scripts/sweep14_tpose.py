"""Sweep 14 on the port: the transposed-contraction fold against the
production top-k.

The JAX sweep re-judged ``_tpose_kernel`` (feature-major operands ``[D, M]``
and ``[D, N]``, cast to bf16 inside the kernel) with transport-free timing.
Its function on the card is K9 (``ops.cuda_fold.tpose_fold``).
:func:`tpose_topk` is the sweep's own entry: the raw metric ``y² − 2·x·y``
and the columns, cut to k, with no finalize (and so no clamp). It is gated
on recall against the exact top-k of the first 512 test rows; a pass is
timed against K2 differentially, chains of 50 and 200 calls, the best of 5.

    python -m avenir_tpu_torch.scripts.sweep14_tpose [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import K, N_ACC, TILE_N

ITERS = 50
ROUNDS = 5


def tpose_topk(x: torch.Tensor, y: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw metric ``[m, k]`` f32, train column ``[m, k]`` int32) of the
    fold over the operands transposed to feature-major."""
    out_d, out_i = cuda_fold.tpose_fold(
        x.T.contiguous(), y.T.contiguous(), row_sq_norm(y), k=k,
        n_acc=N_ACC, tile_n=TILE_N)
    return out_d[:, :k], out_i[:, :k]


def tpose_recall(test: torch.Tensor, train: torch.Tensor) -> float:
    """Recall of :func:`tpose_topk` against the exact top-k on the first
    512 test rows; prints it."""
    _, i_ex = _sweep.exact_topk(test, train)
    _, i_tp = tpose_topk(test[:_sweep.GATE_ROWS], train, k=K)
    recall = _sweep.recall_of(i_ex, i_tp)
    print(f"tpose recall vs exact: {recall:.4f}", flush=True)
    return recall


def diff_time(fn, dev: torch.device) -> float:
    """Seconds a call: the best chain of ``4·ITERS`` calls less the best
    of ``ITERS``, over their difference in calls."""
    n_lo, n_hi = ITERS, 4 * ITERS
    fn()
    host_s = _timing.queue_seconds(fn, dev)
    t_lo = min(_timing.chain_total_ms(fn, n_lo, dev, host_s)
               for _ in range(ROUNDS))
    t_hi = min(_timing.chain_total_ms(fn, n_hi, dev, host_s)
               for _ in range(ROUNDS))
    return (t_hi - t_lo) / (n_hi - n_lo) / 1e3


def main(argv: Optional[List[str]] = None) -> dict:
    dev, m, n = _sweep.parse_args(__doc__, argv)
    test, train = _sweep.make_data(m, n, dev)
    print(f"# sweep14_tpose: {m} test x {n} train, D={_sweep.D}, k={K}; "
          f"{_timing.clock_label(dev)}", flush=True)
    result = {"recall": tpose_recall(test, train), "prod_us": None,
              "tpose_us": None}
    if result["recall"] < _sweep.RECALL_GATE:
        print("GATE FAIL — not adoptable", flush=True)
        return result
    t_prod = diff_time(lambda: _sweep.prod_topk(test, train), dev)
    t_tp = diff_time(lambda: tpose_topk(test, train, k=K), dev)
    print(f"prod  {t_prod * 1e6:7.1f} us/iter  {m / t_prod / 1e6:6.2f} "
          "M rows/s (kernel)", flush=True)
    print(f"tpose {t_tp * 1e6:7.1f} us/iter  {m / t_tp / 1e6:6.2f} "
          f"M rows/s (kernel)  {t_prod / t_tp:.2f}x prod", flush=True)
    result.update(prod_us=t_prod * 1e6, tpose_us=t_tp * 1e6)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
