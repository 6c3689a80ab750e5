"""Per-call time of a kernel call on resident operands, with the fixed
costs taken out.

:func:`chain_ms` runs a chain of R calls and one of 4R calls and returns
``(t_4R − t_R) / 3R``: the cost of starting a chain (the events, the first
launch) drops out of the difference. On a CUDA device the chains run
between two CUDA events with no host synchronization inside, and each
chain is queued behind a device-side sleep that outlasts the host's work
of queueing it, so the card runs the chain's kernels back to back: the
wrapper's host work (argument checks, allocation, the ctypes call) drops
out too, as long as the launch queue holds the whole chain. On the CPU the
same difference is taken on the host clock.

:func:`graph_ms` runs :func:`chain_ms` over replays of a CUDA graph that
holds one call, for a call whose host work outlasts its device work: a
chain of hundreds of such calls, several launches each, fills the launch
queue while the card sleeps, and the host then paces the rest of it (K1's
wrapper read 0.030-0.050 ms chained and 0.014 ms from graph replays on an
H100).

:func:`differential_rounds` is the interleaved differential protocol of
the kernel-restructure sweeps (``scripts/sweep16_kernels.py`` to
``sweep18_tpose_fold.py``): every arm is timed as a chain of ``lo`` and a
chain of ``hi`` calls in every round, the arms in turn inside the round,
and ``(t_hi − t_lo) / (hi − lo)`` is the arm's time a call in that round.
Whatever drifts between rounds (clocks, power, neighbours) then falls on
all arms alike; :func:`ratio_medians` takes each arm's per-round ratio
against the anchor and the median over the rounds.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List, Mapping

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


def queue_seconds(fn: Callable[[], object], dev: torch.device) -> float:
    """Seconds the host takes to queue one call of ``fn`` (the device is
    idle before and after)."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    _sync(dev)
    return host_s


def chain_total_ms(fn: Callable[[], object], n: int, dev: torch.device,
                    host_s: float) -> float:
    """Milliseconds of one chain of ``n`` calls; ``host_s`` is the time the
    host takes to queue one call."""
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
        return chain_total_ms(fn, n, dev, host_s)

    t_lo = min(run(reps) for _ in range(REPEATS))
    t_hi = min(run(4 * reps) for _ in range(REPEATS))
    if t_hi - t_lo < 0.2 * t_hi:     # noise guard: the bulk rate
        return t_hi / (4 * reps)
    return (t_hi - t_lo) / (3 * reps)


def graph_ms(fn: Callable[[], object], device) -> float:
    """Milliseconds per call of ``fn``'s device work: :func:`chain_ms` over
    replays of a CUDA graph that holds one call (:func:`_graphed`), so that
    the host's work per call (argument checks, allocation, ctypes) is not
    timed even where it outlasts the device's, as it does for a small
    kernel's wrapper queued many times over. On the CPU, :func:`chain_ms`
    of ``fn``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return chain_ms(fn, dev)
    return chain_ms(_graphed(fn, dev), dev)


def _graphed(fn: Callable[[], object], dev: torch.device
             ) -> Callable[[], None]:
    """``fn``'s device work captured once into a CUDA graph; the replay it
    returns runs all of it with one call from the host. An arm of a sweep
    is a whole function of some forty small launches around its kernel
    (operand encoders, finalize or re-rank): replayed, it is timed as the
    card runs it, as the JAX sweeps time a jitted chain, however slow the
    host is at queueing. ``fn`` must not wait for the device."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()                      # builds, loads and warms outside capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def differential_rounds(arms: Mapping[str, Callable[[], object]], device,
                        *, rounds: int, lo: int = 25, hi: int = 100,
                        by_phase: bool = False) -> Dict[str, List[float]]:
    """Microseconds a call of every arm in every round: ``(t_hi − t_lo) /
    (hi − lo)`` of a chain of ``lo`` and a chain of ``hi`` calls. Inside a
    round the arms take turns: each arm's two chains one after the other,
    or with ``by_phase`` every arm's ``lo`` chain and then every arm's
    ``hi`` chain. Every arm is called once before the first round; on a
    CUDA device it is captured into a CUDA graph first and the chains
    replay it (:func:`_graphed`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        arms = {name: _graphed(fn, dev) for name, fn in arms.items()}
    host_s = {}
    for name, fn in arms.items():
        fn()
        host_s[name] = queue_seconds(fn, dev)
    per_round: Dict[str, List[float]] = {name: [] for name in arms}
    for _ in range(rounds):
        total = {}
        order = ([(name, n) for n in (lo, hi) for name in arms] if by_phase
                 else [(name, n) for name in arms for n in (lo, hi)])
        for name, n in order:
            total[name, n] = chain_total_ms(arms[name], n, dev,
                                             host_s[name])
        for name in arms:
            per_round[name].append((total[name, hi] - total[name, lo])
                                   / (hi - lo) * 1e3)
    return per_round


def ratio_medians(per_round: Mapping[str, List[float]], anchor: str
                  ) -> Dict[str, float]:
    """Each arm's median over the rounds of ``anchor's time / arm's time``
    in the same round: above 1, the arm is faster than the anchor."""
    return {name: statistics.median(a / t for a, t in
                                    zip(per_round[anchor], times))
            for name, times in per_round.items()}


def clock_label(device) -> str:
    """What :func:`chain_ms` measured on ``device``, for a result line."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"device time, CUDA events, {torch.cuda.get_device_name(dev)}"
    return "host clock, cpu"
