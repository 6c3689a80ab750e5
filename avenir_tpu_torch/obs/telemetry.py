"""Spans and fixed-bucket latency histograms: the tracer half of ``obs``.

Counterpart of ``avenir_tpu/obs/telemetry.py`` (pure stdlib, copied):
``span("knn.predict")`` records the wall time of its block into a log2
bucket histogram keyed by the span's nesting path (``outer/inner``),
thread-safe. A disabled tracer's ``span`` returns one shared no-op
context manager: no allocation, no clock read, no lock. Percentiles are
estimated from bucket edges when exported, so recording never sorts; the
bucket bounds are fixed, so histograms of different processes merge
bucket for bucket.

Spans time the host: a kernel queued inside a span may still run after
it closes, and nothing here synchronizes with the card.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# log2-spaced bucket UPPER bounds in milliseconds: 0.001ms .. ~134s.
# 28 finite buckets + one overflow; fixed forever so histograms from
# different processes/runs merge and compare bucket-for-bucket.
BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(
    0.001 * 2.0 ** i for i in range(28))

# snapshot bucket keys are repr(bound); the merge path maps them back
_BOUND_INDEX = {repr(b): i for i, b in enumerate(BUCKET_BOUNDS_MS)}

_PCTS = (50, 95, 99)


def percentiles(values: Sequence[float],
                qs: Sequence[int] = _PCTS) -> Dict[int, float]:
    """Nearest-rank percentiles of raw samples (shared with StepTimer).

    Empty input yields 0.0 for every requested percentile — summaries stay
    total functions, like ``StepTimer.summary`` on an unused timer.
    """
    out = {q: 0.0 for q in qs}
    if not values:
        return out
    ordered = sorted(values)
    n = len(ordered)
    for q in qs:
        rank = max(1, math.ceil(q / 100.0 * n))
        out[q] = float(ordered[min(rank, n) - 1])
    return out


def percentiles_weighted(pairs: Sequence[Tuple[float, int]],
                         qs: Sequence[int] = _PCTS) -> Dict[int, float]:
    """Nearest-rank percentiles of a WEIGHTED multiset: ``(value, n)``
    entries stand for ``n`` repeats of ``value`` — identical result to
    :func:`percentiles` over the expanded samples, at one entry per
    batch. The serving loop's per-event ring records this shape so the
    enabled hot path pays one append per batch; the rank rule
    (``max(1, ceil(q/100 * total))``) lives HERE, beside its unweighted
    sibling, so the convention cannot drift between the two."""
    out = {q: 0.0 for q in qs}
    total = sum(n for _, n in pairs)
    if total <= 0:
        return out
    ordered = sorted(pairs)
    for q in qs:
        rank = max(1, math.ceil(q / 100.0 * total))
        cum = 0
        for value, n in ordered:
            cum += n
            if cum >= rank:
                out[q] = float(value)
                break
    return out


def snapshot_slot_counts(snap: Dict) -> List[int]:
    """Per-slot (NON-cumulative) counts of a :meth:`LatencyHistogram.
    snapshot` dict: one int per finite bucket bound plus the overflow
    terminal. The inverse of the snapshot's cumulative ``le`` encoding —
    what the merge folds, and what tests sum bucket-for-bucket across
    worker reports (a cumulative value at an ABSENT key equals the last
    present one, so cumulative dicts cannot be summed key-wise)."""
    slots = [0] * (len(BUCKET_BOUNDS_MS) + 1)
    count = int(snap.get("count", 0))
    if count == 0:
        return slots
    prev = 0
    for key, cum in sorted(snap.get("buckets", {}).items(),
                           key=lambda kv: _BOUND_INDEX.get(kv[0],
                                                           len(slots))):
        idx = _BOUND_INDEX.get(key)
        if idx is None:          # the "+Inf" terminal sorts last; skip it
            continue
        slots[idx] = int(cum) - prev
        prev = int(cum)
    slots[-1] = count - prev     # overflow = total minus last finite cum
    return slots


class LatencyHistogram:
    """Fixed-bucket latency accumulator with p50/p95/p99 estimation.

    Buckets are cumulative-on-export (Prometheus ``le`` semantics);
    internally each slot counts only its own range so recording touches
    one cell. Percentiles interpolate to the bucket upper edge, clamped to
    the observed [min, max] — with log2 buckets the estimate is within 2x,
    which is what a latency SLO dashboard needs (exact quantiles would
    require keeping every sample; see ``percentiles`` for that path).
    """

    __slots__ = ("_counts", "count", "sum_ms", "min_ms", "max_ms", "_lock")

    def __init__(self):
        self._counts = [0] * (len(BUCKET_BOUNDS_MS) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def record(self, ms: float, n: int = 1) -> None:
        """Record ``n`` observations of the same latency in one bisect +
        one lock acquisition — how batch loops amortize one clock read
        over every event of a batch without N record calls."""
        if n <= 0:
            return
        idx = bisect.bisect_left(BUCKET_BOUNDS_MS, ms)
        with self._lock:
            self._counts[idx] += n
            self.count += n
            self.sum_ms += ms * n
            if ms < self.min_ms:
                self.min_ms = ms
            if ms > self.max_ms:
                self.max_ms = ms

    def merge(self, snap: Dict) -> None:
        """Fold another histogram's :meth:`snapshot` dict into this one
        bucket-for-bucket — the fleet-merge primitive. Sound because the
        bucket bounds are FIXED (module header): every process's slot i
        covers the same range, so per-slot counts simply add. Count/sum
        add, min/max envelope; the merge is associative and
        order-independent (integer bucket counts; float sums to rounding).
        An empty snapshot is the identity."""
        count = int(snap.get("count", 0))
        if count == 0:
            return
        slots = snapshot_slot_counts(snap)
        with self._lock:
            for i, c in enumerate(slots):
                self._counts[i] += c
            self.count += count
            self.sum_ms += float(snap.get("sum_ms", 0.0))
            if snap.get("min_ms", float("inf")) < self.min_ms:
                self.min_ms = float(snap["min_ms"])
            if snap.get("max_ms", 0.0) > self.max_ms:
                self.max_ms = float(snap["max_ms"])

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "LatencyHistogram":
        h = cls()
        h.merge(snap)
        return h

    def percentile_ms(self, q: float) -> float:
        """Bucket-edge estimate of the q-th percentile (q in [0, 100])."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(q / 100.0 * self.count))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    edge = (BUCKET_BOUNDS_MS[i]
                            if i < len(BUCKET_BOUNDS_MS) else self.max_ms)
                    return float(min(max(edge, self.min_ms), self.max_ms))
            return float(self.max_ms)  # unreachable; counts sum to count

    def snapshot(self) -> Dict:
        """Export dict: count/sum/min/max, p50/p95/p99, non-empty buckets
        as ``{le_ms: cumulative_count}`` plus the ``+Inf`` terminal."""
        pcts = {f"p{q}_ms": self.percentile_ms(q) for q in _PCTS}
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum_ms": 0.0, **pcts}
            buckets: Dict[str, int] = {}
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if c and i < len(BUCKET_BOUNDS_MS):
                    buckets[repr(BUCKET_BOUNDS_MS[i])] = cum
            buckets["+Inf"] = self.count
            return {"count": self.count,
                    "sum_ms": self.sum_ms,
                    "min_ms": self.min_ms,
                    "max_ms": self.max_ms,
                    **pcts,
                    "buckets": buckets}


class _NullSpan:
    """Shared, reentrant no-op context manager — the disabled-tracer span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: pushes its name on the thread-local stack so nested
    spans key under ``parent/child``, then records elapsed wall time."""

    __slots__ = ("_tracer", "_name", "_path", "_t0")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self):
        stack = self._tracer._stack()
        stack.append(self._name)
        self._path = "/".join(stack)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        stack = self._tracer._stack()
        if stack and stack[-1] == self._name:
            stack.pop()
        self._tracer.record(self._path, ms)
        return False


class Tracer:
    """Span factory + histogram store. One per process is the norm
    (``tracer()`` below); tests build private instances freely."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._hists: Dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """Context manager timing its block into histogram ``name`` (or
        ``parent/name`` when nested). Free when the tracer is disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def record(self, name: str, ms: float, n: int = 1) -> None:
        """Record a latency directly (batch loops that amortize one clock
        read over N events use this with ``n`` instead of N spans)."""
        if not self.enabled:
            return
        hist = self._hists.get(name)
        if hist is None:
            with self._lock:
                hist = self._hists.setdefault(name, LatencyHistogram())
        hist.record(ms, n)

    def histogram(self, name: str) -> Optional[LatencyHistogram]:
        return self._hists.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """{span_path: histogram snapshot} for every recorded span."""
        with self._lock:
            items = list(self._hists.items())
        return {name: h.snapshot() for name, h in sorted(items)}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer every instrumented subsystem records into."""
    return _TRACER


def span(name: str):
    """Module-level convenience: ``with telemetry.span("knn.predict"):``."""
    return _TRACER.span(name)


def enable(on: bool = True) -> None:
    _TRACER.enabled = on
