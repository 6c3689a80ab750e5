"""Per-call time of a kernel call on resident operands, with the fixed
costs taken out.

:func:`chain_ms` runs a chain of R calls and one of 4R calls and returns
``(t_4R − t_R) / 3R``: the cost of starting a chain (the events, the first
launch) drops out of the difference. On a CUDA device the chains run
between two CUDA events with no host synchronization inside, and each
chain is queued behind a device-side sleep that outlasts the host's work
of queueing it, so the card runs the chain's kernels back to back: the
wrapper's host work (argument checks, allocation, the ctypes call) drops
out too, and a kernel shorter than its wrapper is timed as the card runs
it. On the CPU the same difference is taken on the host clock.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

#: cycles a second the sleep is sized by: at or above an H100's SM clock,
#: so that the sleep lasts at least as long as asked
_SLEEP_HZ = 2.0e9
#: R is sized so that a chain of R calls lasts about this long (2 ≤ R ≤ 200)
TARGET_MS = 50.0
#: chains of each length; the fastest counts
REPEATS = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chain_ms(fn: Callable[[], object], device) -> float:
    """Milliseconds per call of ``fn`` on ``device``: the best of
    ``REPEATS`` chains of R and of 4R calls, differenced, R sized by
    ``TARGET_MS``."""
    dev = torch.device(device)
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0       # queueing one call
    _sync(dev)
    one_s = time.perf_counter() - t0        # one call, end to end
    reps = min(200, max(2, math.ceil(TARGET_MS / 1e3 / max(one_s, 1e-9))))

    def run(n: int) -> float:
        if dev.type != "cuda":
            t = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the card sleeps while the host queues the chain
        torch.cuda._sleep(int((2.0 * host_s * n + 1e-3) * _SLEEP_HZ))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    t_lo = min(run(reps) for _ in range(REPEATS))
    t_hi = min(run(4 * reps) for _ in range(REPEATS))
    if t_hi - t_lo < 0.2 * t_hi:     # noise guard: the bulk rate
        return t_hi / (4 * reps)
    return (t_hi - t_lo) / (3 * reps)


def clock_label(device) -> str:
    """What :func:`chain_ms` measured on ``device``, for a result line."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"device time, CUDA events, {torch.cuda.get_device_name(dev)}"
    return "host clock, cpu"
