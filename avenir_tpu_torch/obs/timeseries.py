"""Time series: windowed deltas over TelemetryHub snapshots.

Counterpart of ``avenir_tpu/obs/timeseries.py`` (pure stdlib, copied).
Everything the hub collects is cumulative (span histograms, registry
counters, runtime totals): the right shape for an end-of-run report,
useless for watching a live run. This module is the live half:

- :class:`MetricsRing`: a bounded ring of per-window records, each the
  delta between two hub reports: counters de-accumulated with restart
  clamping (a restart resets a counter; the window rate clamps at 0),
  windowed rates (``decisions/s``, ``rewards/s``, ``shed/s``) and each
  window's histogram-delta percentiles (slot counts subtracted bucket
  for bucket, so a regression that started ten seconds ago shows).
- :class:`MetricsPump`: a daemon thread sampling ``hub().report()`` into
  a ring on a fixed cadence. It reads the snapshots the end-of-run report
  reads: host floats, never a tensor on the card.
- :class:`FlightRecorder`: the ring dumped atomically (temp file and
  ``os.replace``, as ``write_report``) to ``<metrics_out>.flight.jsonl``
  on a crash (the engine's and loop's exception hooks, an ``atexit``
  backstop), on SIGUSR2, and on an SLO breach (the window p99 of a span
  crossing a bar).

Rate math:

- **Restart clamp**: ``cur < prev`` on a cumulative series means the
  source restarted; the window delta is 0, never negative.
- **Gap widening**: the denominator is the real time between the two
  samples, so a missed pump tick widens the window instead of inflating
  the rate.
- **Empty ring**: exports cleanly (``{"n": 0, "windows": []}``): the
  scrape endpoint answers before the first window closes.
"""

from __future__ import annotations

import collections
import math
import os
import signal
import socket
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

from avenir_tpu_torch.obs import telemetry as _telemetry

# the named fleet rates every dashboard asks for first, derived from the
# span histograms both serving paths already record (engine + loop both
# feed engine.decision_latency / engine.reward_fold) and the cumulative
# shed gauge. Each entry: rate key -> ("span"|"gauge", source name).
RATE_SOURCES: Dict[str, tuple] = {
    "decisions_per_s": ("span", "engine.decision_latency"),
    "rewards_per_s": ("span", "engine.reward_fold"),
    "shed_per_s": ("gauge", "engine.shed_total"),
}

_PCTS = (50, 95, 99)


def counter_delta(cur: float, prev: float) -> float:
    """Windowed increment of a cumulative series with RESTART CLAMPING:
    a current value below the previous one means the source process
    restarted and re-counted from zero — the window contribution is 0
    (never negative; the restarted process's partial recount lands in
    the NEXT window, where it is again a clean cur-prev)."""
    delta = float(cur) - float(prev)
    return delta if delta > 0.0 else 0.0


def slot_percentile(slots: List[int], q: float) -> float:
    """Bucket-edge percentile estimate over per-slot (non-cumulative)
    counts — the window-delta sibling of ``LatencyHistogram.
    percentile_ms``, without the min/max clamp (a window has no min/max
    envelope of its own). Overflow observations report the last finite
    edge: within the log2-bucket estimate's documented 2x error."""
    total = sum(slots)
    if total <= 0:
        return 0.0
    target = max(1, math.ceil(q / 100.0 * total))
    seen = 0
    for i, c in enumerate(slots):
        seen += c
        if seen >= target:
            bound = min(i, len(_telemetry.BUCKET_BOUNDS_MS) - 1)
            return float(_telemetry.BUCKET_BOUNDS_MS[bound])
    return float(_telemetry.BUCKET_BOUNDS_MS[-1])


def span_window(cur_snap: Dict, prev_slots: Optional[List[int]],
                dt_s: float) -> Optional[Dict]:
    """One span's window record out of its cumulative snapshot and the
    previous sample's slot counts: per-slot delta (restart-clamped
    per slot), window count/rate, window percentiles — and the slot
    deltas themselves (``slots``), which the burn-rate evaluator
    (obs.signals) counts above an SLO bound: bad/total counts
    add across windows, so multi-window burn is exact under coalescing
    where re-averaged percentiles would not be. None when nothing
    happened this window — quiet spans stay out of the export."""
    cur_slots = _telemetry.snapshot_slot_counts(cur_snap)
    if prev_slots is None:
        prev_slots = [0] * len(cur_slots)
    slots = [int(counter_delta(c, p))
             for c, p in zip(cur_slots, prev_slots)]
    count = sum(slots)
    if count <= 0:
        return None
    out = {"count": count,
           "rate_per_s": round(count / dt_s, 3) if dt_s > 0 else 0.0,
           "slots": slots}
    for q in _PCTS:
        out[f"p{q}_ms"] = slot_percentile(slots, q)
    return out


class MetricsRing:
    """Bounded ring of windowed hub-report deltas.

    ``observe(report)`` closes one window against the previous
    observation and appends its record; the cumulative baselines
    (counter values, per-span slot counts, gauge values for cumulative
    gauges) live here so the pump stays stateless. Thread-safe: the
    pump writes while the scrape endpoint reads."""

    def __init__(self, max_windows: int = 240):
        self._windows: Deque[Dict] = collections.deque(maxlen=max_windows)
        # reentrant: the SIGUSR2 flight dump runs on the main thread and
        # reads windows() — if the signal lands while the main thread is
        # inside observe()/windows() a plain Lock would deadlock the
        # process instead of dumping
        self._lock = threading.RLock()
        self._prev_mono: Optional[float] = None
        self._prev_counters: Dict[str, float] = {}
        self._prev_slots: Dict[str, List[int]] = {}
        self._prev_gauges: Dict[str, float] = {}
        self.windows_total = 0          # ring drops old ones; this doesn't

    @staticmethod
    def _scalar_gauges(gauges: Dict) -> Dict[str, float]:
        """Flatten a report's gauges to scalars: merged fleet reports
        carry per-source dicts — sum them (the fleet total is what a
        rate reads; per-source attribution stays in the full report)."""
        out: Dict[str, float] = {}
        for name, value in gauges.items():
            if isinstance(value, dict):
                try:
                    out[name] = float(sum(value.values()))
                except (TypeError, ValueError):
                    continue
            else:
                try:
                    out[name] = float(value)
                except (TypeError, ValueError):
                    continue
        return out

    def observe(self, report: Dict, now_mono: Optional[float] = None,
                now_wall: Optional[float] = None) -> Optional[Dict]:
        """Fold one hub report into the ring. The FIRST observation only
        pins baselines (a delta needs two ends) and returns None; every
        later one closes a window and returns its record. ``now_mono``
        is injectable for the gap/clamp tests."""
        t_mono = time.monotonic() if now_mono is None else now_mono
        t_wall = time.time() if now_wall is None else now_wall
        counters = {k: float(v)
                    for k, v in report.get("counters", {}).items()}
        spans = report.get("spans", {})
        gauges = self._scalar_gauges(report.get("gauges", {}))
        with self._lock:
            first = self._prev_mono is None
            # a gap of missed samples WIDENS the denominator: dt is the
            # real elapsed time since the last successful observation,
            # not the nominal pump interval
            dt_s = 0.0 if first else max(t_mono - self._prev_mono, 0.0)
            window: Optional[Dict] = None
            if not first:
                window = {"t": t_wall, "dt_s": round(dt_s, 6),
                          "counters": {}, "spans": {}, "gauges": gauges,
                          "rates": {}}
                for name, cur in counters.items():
                    delta = counter_delta(
                        cur, self._prev_counters.get(name, 0.0))
                    if delta:
                        window["counters"][name] = delta
                for name, snap in spans.items():
                    rec = span_window(snap, self._prev_slots.get(name),
                                      dt_s)
                    if rec is not None:
                        window["spans"][name] = rec
                for rate, (kind, source) in RATE_SOURCES.items():
                    if kind == "span":
                        rec = window["spans"].get(source)
                        window["rates"][rate] = (
                            rec["rate_per_s"] if rec else 0.0)
                    else:
                        delta = counter_delta(
                            gauges.get(source, 0.0),
                            self._prev_gauges.get(source, 0.0))
                        window["rates"][rate] = (
                            round(delta / dt_s, 3) if dt_s > 0 else 0.0)
                self._windows.append(window)
                self.windows_total += 1
            self._prev_mono = t_mono
            self._prev_counters = counters
            self._prev_slots = {name: _telemetry.snapshot_slot_counts(snap)
                                for name, snap in spans.items()}
            self._prev_gauges = gauges
            return window

    def windows(self, last: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._windows)
        return out if last is None else out[-last:]

    def last_window(self) -> Optional[Dict]:
        with self._lock:
            return self._windows[-1] if self._windows else None

    def rates_snapshot(self, last: Optional[int] = None) -> Dict:
        """The ``/metrics/rates`` payload: meta + the (bounded) window
        list, newest last. An EMPTY ring exports cleanly — the endpoint
        answers before the first window closes."""
        windows = self.windows(last)
        out: Dict = {"format": "avenir-timeseries-v1",
                     "now": time.time(),
                     "host": socket.gethostname(),
                     "pid": os.getpid(),
                     "n": len(windows),
                     "windows_total": self.windows_total,
                     "windows": windows}
        out["current"] = (windows[-1]["rates"] if windows
                          else {k: 0.0 for k in RATE_SOURCES})
        return out

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._prev_mono = None
            self._prev_counters = {}
            self._prev_slots = {}
            self._prev_gauges = {}


class MetricsPump:
    """Daemon thread folding periodic hub reports into a ring.

    Same lifecycle discipline as ``RuntimeSampler``: idempotent
    start/stop, restartable, never raises out of its loop (a telemetry
    defect must not sink the process being observed). ``on_window`` is
    called with each closed window — the flight recorder's SLO check
    rides it."""

    def __init__(self, ring: MetricsRing, interval_s: float = 0.25,
                 hub=None,
                 on_window: Optional[Callable[[Dict], None]] = None):
        self.ring = ring
        # floored: interval 0 (or negative) must not busy-spin a daemon
        # thread snapshotting every histogram under the tracer lock
        # against the very hot path the <=5% overhead gate protects
        self.interval_s = max(float(interval_s), 0.01)
        self._hub = hub
        self._on_window = on_window
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _report(self) -> Dict:
        if self._hub is not None:
            return self._hub.report()
        from avenir_tpu_torch.obs.exporters import hub
        return hub().report()

    def sample_once(self) -> Optional[Dict]:
        """One pump tick (also the flush path: stop() takes a final
        sample so a sub-interval run still closes one window)."""
        try:
            window = self.ring.observe(self._report())
        except Exception:
            return None
        if window is not None and self._on_window is not None:
            try:
                self._on_window(window)
            except Exception:
                pass
        return window

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample_once()
            self._stop.wait(self.interval_s)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MetricsPump":
        with self._lock:
            if self.running:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="avenir-obs-pump", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            self._stop.set()
            thread.join(timeout=5.0)
            self._thread = None
        self.sample_once()


class FlightRecorder:
    """Dump the ring's last N windows on the events that end a run badly.

    Triggers:

    - **crash**: the engine/loop exception hooks call
      :func:`flight_dump_if_armed` before re-raising; an ``atexit``
      backstop (armed by ``obs.live.start_live_obs``, disarmed by a
      clean ``stop()``) catches deaths that never reach those hooks.
    - **SIGUSR2**: ``arm_signal()`` installs a handler (main thread
      only; worker processes arm it at startup) that dumps on demand —
      the "what is this stuck run doing" probe.
    - **SLO breach**: ``check(window)`` (the pump's ``on_window`` hook)
      dumps when the WINDOW p99 of ``slo_span`` crosses ``slo_p99_ms``,
      latched — one dump per breach episode, re-armed when a window
      comes back under the bar.

    Dumps are rename-atomic JSONL: one ``flight-meta`` line (reason,
    identity, window count), then one ``window`` line per ring entry,
    oldest first. ``dump()`` never raises — the recorder runs inside
    exception handlers and signal context."""

    def __init__(self, ring: MetricsRing, path: str,
                 slo_p99_ms: Optional[float] = None,
                 slo_span: str = "engine.decision_latency",
                 slo=None):
        # ``slo`` (an obs.signals.SloSpec) is the declared
        # single source of truth for the breach latch; ``slo_p99_ms``
        # is the pre-spec kwarg, kept as a deprecated alias — an
        # explicit number still wins so existing callers keep their
        # behavior bit-for-bit.
        self.ring = ring
        self.path = path
        if slo is not None and slo_p99_ms is None:
            slo_p99_ms = slo.bound_ms
            slo_span = slo.span or slo_span
        self.slo = slo
        self.slo_p99_ms = slo_p99_ms
        self.slo_span = slo_span
        self.dumps = 0
        self.last_reason: Optional[str] = None
        self._breached = False
        # reentrant: the SIGUSR2 handler runs dump() on the main thread
        # and must not deadlock against a dump already in flight there.
        # The nested dump itself is DROPPED (_dumping flag): both writes
        # would share the one per-pid temp path and interleave, and the
        # in-flight dump already carries the ring
        self._lock = threading.RLock()
        self._dumping = False
        self._signum: Optional[int] = None
        self._prev_handler = None
        self._handler = None

    def dump(self, reason: str) -> Optional[str]:
        """Write the flight file; returns the path, or None on failure
        (best-effort by contract)."""
        from avenir_tpu_torch.obs.exporters import write_jsonl
        try:
            windows = self.ring.windows()
            events: List[Dict] = [{
                "type": "flight-meta",
                "format": "avenir-flight-v1",
                "reason": reason,
                "ts": time.time(),
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "windows": len(windows),
                "windows_total": self.ring.windows_total,
            }]
            events.extend({"type": "window", **w} for w in windows)
            with self._lock:
                if self._dumping:    # same-thread signal re-entry
                    return None
                self._dumping = True
                try:
                    write_jsonl(events, self.path)
                    self.dumps += 1
                    self.last_reason = reason
                finally:
                    self._dumping = False
            return self.path
        except Exception:
            return None

    def backstop_reason(self, fallback: str) -> str:
        """The reason a BACKSTOP dump (atexit, the CLI's outermost
        except) should carry: a crash hook's attribution, if one
        already landed, is forwarded instead of being overwritten —
        the re-dump refreshes the windows without downgrading
        ``crash:engine:ValueError`` to a generic ``atexit``."""
        last = self.last_reason or ""
        return last if last.startswith("crash:") else fallback

    def check(self, window: Dict) -> None:
        """SLO-breach trigger over one closed window (pump hook)."""
        if self.slo_p99_ms is None:
            return
        rec = window.get("spans", {}).get(self.slo_span)
        p99 = rec.get("p99_ms", 0.0) if rec else 0.0
        if rec and p99 > self.slo_p99_ms:
            if not self._breached:
                self._breached = True
                self.dump(f"slo_breach:{self.slo_span}"
                          f":p99_ms={p99}>bar={self.slo_p99_ms}")
        else:
            # re-arm once back under the bar — and on traffic-less
            # windows (no record for the span): a quiet gap ends the
            # breach episode, so a later breach dumps as a NEW episode
            # instead of being swallowed by a still-set latch
            self._breached = False

    def arm_signal(self, signum: Optional[int] = None) -> bool:
        """SIGUSR2 (default) -> dump, chaining any previous handler.
        Signal handlers install only from the main thread; returns False
        (and stays un-armed) elsewhere, and on platforms without the
        signal (Windows has no SIGUSR2 — resolved at call time so the
        module still imports there). ``disarm_signal()`` undoes it — a
        stopped run's recorder must not keep dumping over its finished
        flight file from inside a later run's handler chain."""
        if signum is None:
            signum = getattr(signal, "SIGUSR2", None)
            if signum is None:
                return False
        if threading.current_thread() is not threading.main_thread():
            return False
        previous = signal.getsignal(signum)

        def _handler(sig, frame):
            # inert once disarmed: a later run's handler may still chain
            # into this one, and a stopped recorder must not overwrite
            # its finished flight file
            if self._handler is _handler:
                self.dump(f"signal:{signal.Signals(sig).name}")
            if callable(previous):
                previous(sig, frame)

        signal.signal(signum, _handler)
        self._signum, self._prev_handler, self._handler = (
            signum, previous, _handler)
        return True

    def disarm_signal(self) -> bool:
        """Make the armed handler inert and, when possible, restore the
        pre-``arm_signal`` one. The inert flip (clearing ``_handler``)
        happens on ANY thread — a bundle stopped off the main thread
        must still never dump over its finished flight file — but the
        ``signal.signal`` restore is main-thread-only, and only when
        ours is still the installed handler (someone who chained on top
        of us keeps theirs)."""
        if self._signum is None:
            return False
        signum, handler, previous = (self._signum, self._handler,
                                     self._prev_handler)
        self._signum = self._prev_handler = self._handler = None
        if threading.current_thread() is not threading.main_thread():
            return False
        if signal.getsignal(signum) is handler:
            signal.signal(signum, previous)
            return True
        return False


# the process's armed recorder, if any: the seam the engine/loop crash
# hooks reach without importing the live-obs layer into their hot paths
_ARMED: Optional[FlightRecorder] = None


def arm_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _ARMED
    _ARMED = recorder


def armed_flight_recorder() -> Optional[FlightRecorder]:
    return _ARMED


def flight_dump_if_armed(reason: str) -> Optional[str]:
    """Crash hook for the serving engine/loop exception paths: one
    module-attribute read when nothing is armed, a best-effort flight
    dump when a recorder is. Never raises."""
    recorder = _ARMED
    if recorder is None:
        return None
    return recorder.dump(reason)


def run_with_flight_dump(tag: str, fn: Callable):
    """The ONE crash wrapper every serving run loop uses: run ``fn()``,
    attributing any escaping exception to the armed flight recorder as
    ``crash:<tag>:<ExcType>`` before re-raising. Costs a single
    module-attribute read on the no-recorder path."""
    try:
        return fn()
    except BaseException as exc:
        flight_dump_if_armed(f"crash:{tag}:{type(exc).__name__}")
        raise
