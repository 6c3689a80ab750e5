"""Sweep 16 on the port: KNN kernel-restructure candidates against the
production top-k.

Two attacks on the production kernel's per-pair work, as the JAX sweep
framed them: cheaper operands for the product (int8 with int32 sums), and
an epilogue ``y² − 2·x·y`` that rides the product as augmented columns, so
that the fold consumes the product as it comes. Arms:

  prod      the production top-k, K2                            (anchor)
  augbf16   bf16 product of ``[x | 1]`` and ``[−2y | y²]``, cast by the
            caller, no epilogue (K10)
  int8epi   int8 product at scale 127, int32 epilogue ``y² − 2·cross``
            (K11)
  int8aug   int8 product of augmented columns: the −2 rides the x side at
            scale 63, ``y²`` is split exactly into 10 int8 columns, no
            epilogue (K11)

Each arm is gated against the exact top-k of the first 512 test rows
(recall ≥ 0.985, matched distances within 25); an arm that fails is
dropped. The rest are timed by the interleaved differential protocol
(chains of 25 and 100 calls, 5 rounds, the arms in turn), whole function:
operand encoders, kernel and finalize.

    python -m avenir_tpu_torch.scripts.sweep16_kernels [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import (
    K, _int8_sq_norm, finalize_f32, finalize_int, int8_aug_operands,
    launch_fold, quant)

ROUNDS = 5


def augbf16_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    ones = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    xa = torch.cat([x, ones], dim=1).to(torch.bfloat16)
    y2 = row_sq_norm(y).reshape(-1, 1)
    ya = torch.cat([-2.0 * y, y2], dim=1).to(torch.bfloat16)
    raw_d, raw_i = launch_fold(xa, ya, k=k)
    return finalize_f32(raw_d[:, :k], raw_i[:, :k], row_sq_norm(x))


def int8epi_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    x8, y8, s = quant(x, y, 127.0)
    raw_d, raw_i = launch_fold(x8, y8, k=k, y2=_int8_sq_norm(y8))
    return finalize_int(raw_d[:, :k], raw_i[:, :k], _int8_sq_norm(x8), s)


def int8aug_topk(x: torch.Tensor, y: torch.Tensor, *, k: int):
    xa, ya, s = int8_aug_operands(x, y)
    raw_d, raw_i = launch_fold(xa, ya, k=k)
    # |x8|² from the −2·x8 columns of xa
    x2_i = _int8_sq_norm(xa[:, :_sweep.D]) // 4
    return finalize_int(raw_d[:, :k], raw_i[:, :k], x2_i, s)


ARMS = {
    "prod": _sweep.prod_topk,
    "augbf16": lambda t, tr: augbf16_topk(t, tr, k=K),
    "int8epi": lambda t, tr: int8epi_topk(t, tr, k=K),
    "int8aug": lambda t, tr: int8aug_topk(t, tr, k=K),
}


def run(name: str, doc: str, arms, rounds: int,
        argv: Optional[List[str]]) -> dict:
    """Gate every arm, drop those that fail, time the rest against
    ``prod``: the protocol sweeps 16 and 16b share."""
    dev, m, n = _sweep.parse_args(doc, argv)
    test, train = _sweep.make_data(m, n, dev)
    print(f"# {name}: {m} test x {n} train, D={_sweep.D}, k={K}; "
          f"{_timing.clock_label(dev)}", flush=True)
    gates = _sweep.gate_arms(arms, test, train)
    for name, g in gates.items():
        if not g["ok"]:
            print(f"{name}: FAILED gate, dropped", flush=True)
    timed = {name: fn for name, fn in arms.items() if gates[name]["ok"]}
    per_round = _sweep.time_arms(timed, test, train, rounds=rounds)
    return {"gates": gates, "timed": _sweep.print_medians(per_round, m)}


def main(argv: Optional[List[str]] = None) -> dict:
    return run("sweep16_kernels", __doc__, ARMS, ROUNDS, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
