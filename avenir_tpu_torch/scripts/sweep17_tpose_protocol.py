"""Sweep 17 on the port: the transposed-contraction fold against the
production top-k by the interleaved protocol.

One run of the JAX sweep's protocol for sweep 14's kernel
(:func:`sweep14_tpose.tpose_topk`, K9): per round the four chains run as
prod 25, tpose 25, prod 100, tpose 100 calls, each arm's differential is
taken inside the round, and the round's ratio prod / tpose is the
statistic, so that what drifts between rounds cancels. The run's
result is the median ratio over 6 rounds. The arm is gated on recall first.

    python -m avenir_tpu_torch.scripts.sweep17_tpose_protocol [--device cpu] ...
"""

from __future__ import annotations

import sys
from typing import List, Optional

from avenir_tpu_torch.scripts import _sweep, _timing
from avenir_tpu_torch.scripts._sweep import K
from avenir_tpu_torch.scripts.sweep14_tpose import tpose_recall, tpose_topk

ROUNDS = 6


def main(argv: Optional[List[str]] = None) -> dict:
    dev, m, n = _sweep.parse_args(__doc__, argv)
    test, train = _sweep.make_data(m, n, dev)
    print(f"# sweep17_tpose_protocol: {m} test x {n} train, D={_sweep.D}, "
          f"k={K}; {_timing.clock_label(dev)}", flush=True)
    result = {"recall": tpose_recall(test, train), "ratio": None}
    if result["recall"] < _sweep.RECALL_GATE:
        print("GATE FAIL", flush=True)
        return result
    arms = {"prod": _sweep.prod_topk,
            "tpose": lambda t, tr: tpose_topk(t, tr, k=K)}
    per_round = _sweep.time_arms(arms, test, train, rounds=ROUNDS,
                                 by_phase=True)
    result["ratio"] = _timing.ratio_medians(per_round, "prod")["tpose"]
    print(f"# median tpose speedup: {result['ratio']:.3f}x",
          flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
