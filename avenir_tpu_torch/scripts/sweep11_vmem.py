"""Sweep 11 on the port: the production fold at larger tiles.

The JAX sweep raised Pallas's scoped-VMEM limit to run ``_topk_kernel`` at
tiles from (1024, 8192) to (2048, 16384): fewer grid steps at the same fold
work. On the card that kernel's function is K6 (``ops.cuda_fold.acc_fold``,
bf16-rounded operands, ``n_acc = 4``), and the tiles change nothing in it
while ``tile_n`` is a multiple of 512: a block owns whole test rows and
sweeps all of N, so there is no grid step to save and no memory limit to
raise (its shared memory is fixed by the kernel). The sweep keeps its six
configurations and its method: each is gated on recall against the exact
top-k of the first 512 test rows (≥ 0.985, else dropped), then the arms run
in turn, 50 calls a chain, the best of 5 rounds counting.

  xla             the plain PyTorch path ``pairwise_topk(mode="fast")``; it
                  stands where the XLA ``approx_min_k`` path stood, repeats
                  the arithmetic and is no yardstick of speed
  prod_1024x4096  the production top-k, K2
  vmem_TMxTN      K6 at tile_m TM, tile_n TN

    python -m avenir_tpu_torch.scripts.sweep11_vmem [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops.distance import pairwise_topk, row_sq_norm
from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import K

ITERS = 50
ROUNDS = 5
#: (tile_m, tile_n), as the JAX sweep runs them
CONFIGS = ((1024, 8192), (2048, 4096), (1024, 16384), (2048, 8192),
           (4096, 8192), (2048, 16384))


def launch(x: torch.Tensor, y: torch.Tensor, *, tile_m: int, tile_n: int,
           n_acc: int):
    """``_topk_kernel`` at the given tiles: raw ``[m, 128]`` (metric,
    column) of K6 with bf16-rounded operands."""
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    return cuda_fold.acc_fold(x, y, row_sq_norm(y), k=K, n_acc=n_acc,
                              tile_n=tile_n, use_bf16=True)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    dev, m, n = _sweep.parse_args(__doc__, argv)
    test, train = _sweep.make_data(m, n, dev)
    _, i_exact = _sweep.exact_topk(test, train)
    print(f"# sweep11_vmem: {m} test x {n} train, D={_sweep.D}, k={K}; "
          f"{_timing.clock_label(dev)}", flush=True)

    arms = {
        "xla": lambda: pairwise_topk(test, train, k=K, mode="fast"),
        "prod_1024x4096": lambda: _sweep.prod_topk(test, train),
    }
    recalls = {}
    for tm, tn in CONFIGS:
        name = f"vmem_{tm}x{tn}"
        _, i_got = launch(test[:_sweep.GATE_ROWS], train, tile_m=tm,
                          tile_n=tn, n_acc=4)
        recalls[name] = _sweep.recall_of(i_exact, i_got[:, :K])
        if recalls[name] < _sweep.RECALL_GATE:
            print(f"{name:18s} RECALL FAIL {recalls[name]:.4f}", flush=True)
            continue
        arms[name] = (lambda tm=tm, tn=tn: launch(
            test, train, tile_m=tm, tile_n=tn, n_acc=4))
        print(f"{name:18s} recall {recalls[name]:.4f} ok", flush=True)

    host_s = {name: 0.0 for name in arms}
    for name, fn in arms.items():
        fn()
        host_s[name] = _timing.queue_seconds(fn, dev)
    best = {name: float("inf") for name in arms}
    for _ in range(ROUNDS):
        for name, fn in arms.items():
            best[name] = min(best[name], _timing.chain_total_ms(
                fn, ITERS, dev, host_s[name]))
    print(f"# {ITERS} calls a chain, best of {ROUNDS} interleaved rounds",
          flush=True)
    results = []
    for name, ms in sorted(best.items(), key=lambda kv: kv[1]):
        rows = m * ITERS / (ms / 1e3)
        line = (f"{name:18s} {ms:8.1f} ms  {rows / 1e6:7.3f} M rows/s  "
                f"{best['prod_1024x4096'] / ms:5.2f}x prod")
        if name == "xla":
            line += "  (plain PyTorch, no yardstick)"
        print(line, flush=True)
        results.append({"arm": name, "ms": ms, "rows_per_s": rows,
                        "recall": recalls.get(name)})
    for name, r in recalls.items():
        if name not in best:
            results.append({"arm": name, "ms": None, "rows_per_s": None,
                            "recall": r})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
