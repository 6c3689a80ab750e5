"""Sweep 16c on the port: the packed int8 fold, engineered for recall.

Sweep 16b's packed arm loses recall to bucket collisions (16 candidates
from 512 buckets) and to a quantizer that spends half the int8 range on
features that are never negative. Here the features are centered jointly
before quantizing (squared distance does not see a translation), the
buckets are doubled and doubled again, and the candidates are re-ranked
exactly:

  prod      the production top-k, K2                            (anchor)
  int8pk8   packed fold (K12), centered, 8 candidates, n_acc 8
  int8pk16  the same with 16 candidates and n_acc 16, 2,048 buckets

The gate also prints the candidate coverage (the share of exact neighbors
among the candidates), which tells a loss in the fold from a loss in the
re-rank. Every arm is timed, gate or no gate, and the report marks which
passed: the sweep asks whether the int8 line is worth more engineering.
``tile_m`` is the JAX launcher's test tile; it changes nothing here.

    python -m avenir_tpu_torch.scripts.sweep16c_kernels [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import (
    K, exact_rerank, int8_centered_operands, launch_fold)

ROUNDS = 5


def make_int8pk(c_out: int, tile_m: int, n_acc: int):
    """The packed-fold top-k with ``c_out`` candidates from ``n_acc·128``
    buckets: ``topk(x, y, k=, with_cand=False)``."""
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")

    def topk(x: torch.Tensor, y: torch.Tensor, *, k: int,
             with_cand: bool = False):
        xa, ya, _ = int8_centered_operands(x, y)
        _, raw_i = launch_fold(xa, ya, k=c_out, packed=True, n_acc=n_acc)
        cand = raw_i[:, :c_out]
        d, i = exact_rerank(x, y, cand, k)
        return (d, i, cand) if with_cand else (d, i)
    return topk


def main(argv: Optional[List[str]] = None) -> dict:
    dev, m, n = _sweep.parse_args(__doc__, argv)
    test, train = _sweep.make_data(m, n, dev)
    print(f"# sweep16c_kernels: {m} test x {n} train, D={_sweep.D}, k={K}; "
          f"{_timing.clock_label(dev)}", flush=True)
    pk8 = make_int8pk(8, 512, 8)
    pk16 = make_int8pk(16, 512, 16)
    arms = {"prod": _sweep.prod_topk,
            "int8pk8": lambda t, tr: pk8(t, tr, k=K),
            "int8pk16": lambda t, tr: pk16(t, tr, k=K)}
    cands = {"prod": None,
             "int8pk8": lambda t, tr: pk8(t, tr, k=K, with_cand=True),
             "int8pk16": lambda t, tr: pk16(t, tr, k=K, with_cand=True)}
    gates = {name: _sweep.gate(name, fn, test, train, cands[name])
             for name, fn in arms.items()}
    per_round = _sweep.time_arms(arms, test, train, rounds=ROUNDS)
    marks = {name: "PASS" if g["ok"] else "gate-FAIL"
             for name, g in gates.items()}
    return {"gates": gates,
            "timed": _sweep.print_medians(per_round, m, marks)}


if __name__ == "__main__":
    main(sys.argv[1:])
