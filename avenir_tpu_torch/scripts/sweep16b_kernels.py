"""Sweep 16b on the port: the kernel candidates of sweep 16, repaired for
recall.

Sweep 16's arms reorder the rank-5 and rank-6 neighbors by the bias each
puts on a candidate's metric (a bf16 ``y²``, the int8 grid). The repairs:

  prod      the production top-k, K2                            (anchor)
  tagfold   the production numerics (bf16 product cast by the caller, f32
            ``y²`` epilogue) through the bucket fold (K6)
  augv2     ``y²`` as two bf16 columns, hi + lo, so that the epilogue rides
            the product without losing ``y²``'s low bits: ``[x | 1 | 1]``
            against ``[−2y | y²hi | y²lo]`` (K10)
  int8rr    the augmented int8 product of sweep 16, 16 candidates a row
            from the buckets, then an exact f32 re-rank of them outside the
            kernel (K11)
  int8pk    the same through the packed single-accumulator fold, ``metric ·
            2048 + tag`` under one ``min`` (K12)

Gate, drop and timing as sweep 16.

    python -m avenir_tpu_torch.scripts.sweep16b_kernels [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import _sweep
from avenir_tpu_torch.scripts._sweep import (
    K, K_CAND, aug_operands, exact_rerank, finalize_f32, int8_aug_operands,
    launch_fold)
from avenir_tpu_torch.scripts.sweep16_kernels import run

ROUNDS = 5


def tagfold_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    raw_d, raw_i = launch_fold(x.to(torch.bfloat16), y.to(torch.bfloat16),
                               k=k, y2=row_sq_norm(y))
    return finalize_f32(raw_d[:, :k], raw_i[:, :k], row_sq_norm(x))


def augv2_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    xa, ya = aug_operands(x, y)
    raw_d, raw_i = launch_fold(xa.to(torch.bfloat16), ya.to(torch.bfloat16),
                               k=k)
    return finalize_f32(raw_d[:, :k], raw_i[:, :k], row_sq_norm(x))


def int8rr_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    xa, ya, _ = int8_aug_operands(x, y)
    _, raw_i = launch_fold(xa, ya, k=K_CAND)
    return exact_rerank(x, y, raw_i[:, :K_CAND], k)


def int8pk_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    xa, ya, _ = int8_aug_operands(x, y)
    _, raw_i = launch_fold(xa, ya, k=K_CAND, packed=True)
    return exact_rerank(x, y, raw_i[:, :K_CAND], k)


ARMS = {
    "prod": _sweep.prod_topk,
    "tagfold": lambda t, tr: tagfold_topk(t, tr, k=K),
    "augv2": lambda t, tr: augv2_topk(t, tr, k=K),
    "int8rr": lambda t, tr: int8rr_topk(t, tr, k=K),
    "int8pk": lambda t, tr: int8pk_topk(t, tr, k=K),
}


def main(argv: Optional[List[str]] = None) -> dict:
    return run("sweep16b_kernels", __doc__, ARMS, ROUNDS, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
