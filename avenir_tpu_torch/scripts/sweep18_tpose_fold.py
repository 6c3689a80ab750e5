"""Sweep 18 on the port: the transposed contraction together with the
cheaper folds.

The JAX sweep stacked what sweeps 16 and 17 had timed apart: the
feature-major product and a fold with fewer instructions a pair. Arms:

  prod        the production top-k, K2                          (anchor)
  tpose_tag   feature-major operands cast to bf16 in the kernel, f32 ``y²``
              epilogue, the production finalize with its clamp (K9)
  tpose_tag8  the same with n_acc 8, 1,024 buckets (K9)
  tpose_aug   the epilogue inside the product: ``[x | 1 | 1]`` against
              ``[−2y | y²hi | y²lo]`` as D + 2 feature-major rows, f32
              values that bf16 holds exactly for the two ``y²`` rows, cast
              in the kernel (K10)

Sweep 14's ``tpose`` arm is not here: its entry has no finalize, and so no
scaled distance to gate. ``tpose_aug`` is gated and reported but stays out
of the timed arms, as in the JAX sweep's ``main``. The timed arms that pass
the gate run the interleaved differential protocol, 6 rounds.

    python -m avenir_tpu_torch.scripts.sweep18_tpose_fold [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import (
    K, N_ACC, TILE_N, aug_operands, finalize_f32)

ROUNDS = 6


def _tpose_tag_launch(x: torch.Tensor, y: torch.Tensor, n_acc: int):
    raw_d, raw_i = cuda_fold.tpose_fold(
        x.T.contiguous(), y.T.contiguous(), row_sq_norm(y), k=K,
        n_acc=n_acc, tile_n=TILE_N)
    return finalize_f32(raw_d[:, :K], raw_i[:, :K], row_sq_norm(x))


def tpose_tag_topk(x: torch.Tensor, y: torch.Tensor):
    return _tpose_tag_launch(x, y, N_ACC)


def tpose_tag8_topk(x: torch.Tensor, y: torch.Tensor):
    return _tpose_tag_launch(x, y, 8)


def tpose_aug_topk(x: torch.Tensor, y: torch.Tensor):
    xa, ya = aug_operands(x, y)
    raw_d, raw_i = cuda_fold.raw_fold(
        xa.T.contiguous(), ya.T.contiguous(), k=K, n_acc=N_ACC,
        tile_n=TILE_N, tpose=True)
    return finalize_f32(raw_d[:, :K], raw_i[:, :K], row_sq_norm(x))


ARMS = {"prod": _sweep.prod_topk, "tpose_tag": tpose_tag_topk,
        "tpose_tag8": tpose_tag8_topk}


def main(argv: Optional[List[str]] = None) -> dict:
    dev, m, n = _sweep.parse_args(__doc__, argv)
    test, train = _sweep.make_data(m, n, dev)
    print(f"# sweep18_tpose_fold: {m} test x {n} train, D={_sweep.D}, "
          f"k={K}; {_timing.clock_label(dev)}", flush=True)
    gates = _sweep.gate_arms({**ARMS, "tpose_aug": tpose_aug_topk}, test,
                             train)
    for name in ARMS:
        if not gates[name]["ok"]:
            print(f"{name}: FAILED gate, dropped", flush=True)
    print("tpose_aug: gated only, not in the timed arms", flush=True)
    timed = {name: fn for name, fn in ARMS.items() if gates[name]["ok"]}
    per_round = _sweep.time_arms(timed, test, train, rounds=ROUNDS)
    return {"gates": gates, "timed": _sweep.print_medians(per_round, m)}


if __name__ == "__main__":
    main(sys.argv[1:])
