"""Derived health signals: SLO burn rates and saturation forecasts.

Counterpart of ``avenir_tpu/obs/signals.py`` (pure stdlib, copied). The
ring measures; this module judges: declared :class:`SloSpec` objectives
are evaluated over ring windows into burn rates and verdicts, and a
:class:`SaturationForecaster` projects queue growth into an estimated
time to shed, so an alert fires while the admission latch is still open.

The math:

- **Burn rate** is observation-count arithmetic, never percentile
  arithmetic: a window's badness is the count of observations in
  histogram buckets above the SLO bound (``slot_bad_count``), and a burn
  rate over K windows is ``sum(bad) / sum(total) / budget``. bad/total
  add across windows, so multi-window burn rates are the same however
  the windows are cut (averaged percentiles are not).
- **Restart clamping and gap widening come for free**: badness is read
  from ring windows whose slot deltas are restart-clamped and whose
  ``dt_s`` is the real elapsed time.
- **Zero-budget SLOs** ("shed fraction = 0") burn at ``inf`` once one
  bad observation lands, and at 0.0 otherwise.
- **The forecast is conservative about direction**: a flat or draining
  queue forecasts ``None``, never a negative ETA.

The alert state machine that consumes these verdicts is ``obs.alerts``.
"""

from __future__ import annotations

import collections
import math
import threading
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.obs import telemetry as _telemetry


@dataclass(frozen=True)
class SloSpec:
    """One declared objective over ring windows.

    Two shapes, discriminated by which source field is set:

    - **span-latency** (``span`` + ``bound_ms``): an observation is bad
      when its histogram bucket edge exceeds ``bound_ms``. With
      ``budget`` 0.01 this is the classic "p99 <= bound" objective —
      the window p99 crosses the bound exactly when more than 1% of its
      observations are bad.
    - **bad-rate** (``bad_rate``): a ring rate key whose windowed count
      is bad by definition (``shed_per_s``: every shed event is an SLO
      violation). The denominator is bad + the ``total_span`` window
      count, so the fraction reads "share of popped work violated".

    ``budget`` is the allowed bad fraction; burn rate = fraction /
    budget (``inf`` when budget is 0 and anything is bad). ``page_burn``
    gates the fast single-window page, ``warn_burn`` the slow
    ``slow_windows``-window warn — the SRE multi-window discipline: the
    fast window catches a cliff in seconds, the slow window catches a
    simmer that would exhaust the budget over the horizon.
    """

    name: str
    span: Optional[str] = None
    bound_ms: Optional[float] = None
    bad_rate: Optional[str] = None
    total_span: str = "engine.decision_latency"
    budget: float = 0.01
    severity: str = "page"
    page_burn: float = 8.0
    warn_burn: float = 1.0
    slow_windows: int = 12


# the declared fleet objectives — the single source of truth
# the FlightRecorder's breach latch and the CLI's alerts.* keys read:
# admitted decisions p99 <= 500ms, zero tolerance for shedding, model
# hot-swap p99 <= 250ms (a swap stalls every batch behind it).
DEFAULT_SLOS: Tuple[SloSpec, ...] = (
    SloSpec(name="admitted_p99", span="engine.decision_latency",
            bound_ms=500.0, budget=0.01, severity="page"),
    SloSpec(name="shed_fraction", bad_rate="shed_per_s",
            budget=0.0, severity="page"),
    SloSpec(name="swap_p99", span="lifecycle.swap",
            bound_ms=250.0, budget=0.05, severity="warn"),
)


def primary_latency_slo(
        slos: Optional[Sequence[SloSpec]] = None) -> Optional[SloSpec]:
    """The first span-latency spec — what the FlightRecorder's breach
    latch watches when it is handed a spec list instead of a bare
    number (single source of truth for the p99 bar)."""
    for spec in (DEFAULT_SLOS if slos is None else slos):
        if spec.span is not None and spec.bound_ms is not None:
            return spec
    return None


def slot_bad_count(slots: Sequence[int], bound_ms: float) -> int:
    """Observations above ``bound_ms``, from per-slot (non-cumulative)
    window counts. A slot is bad when its bucket's upper edge exceeds
    the bound — the same edge :func:`~avenir_tpu_torch.obs.timeseries.
    slot_percentile` reports, so "window p99 > bound" and "bad fraction
    > 1%" are the SAME statement about the same buckets. The overflow
    slot (observations past the last finite edge, ~134s) is bad for any
    realistic bound."""
    bounds = _telemetry.BUCKET_BOUNDS_MS
    bad = 0
    for i, c in enumerate(slots):
        if c and bounds[min(i, len(bounds) - 1)] > bound_ms:
            bad += c
    return bad


def burn_rate(bad: float, total: float, budget: float) -> float:
    """Error-budget burn: (bad / total) / budget. 0.0 on no traffic
    (nothing observed burns nothing); ``inf`` on any badness against a
    zero budget — the scale stays total-ordered so thresholds compose
    across spec shapes."""
    if total <= 0:
        return 0.0
    frac = bad / total
    if budget <= 0:
        return math.inf if frac > 0 else 0.0
    return frac / budget


def window_badness(spec: SloSpec, window: Dict) -> Tuple[float, float]:
    """One window's ``(bad, total)`` observation counts for ``spec``.

    Both numbers are plain counts, so they ADD across windows — the
    property every multi-window burn rests on. A window with no traffic
    for the spec's source contributes (0, 0): quiet windows neither
    burn nor launder budget.
    """
    spans = window.get("spans", {})
    if spec.span is not None:
        rec = spans.get(spec.span)
        if not rec:
            return 0.0, 0.0
        slots = rec.get("slots")
        total = float(rec.get("count", 0))
        if slots is None:
            # window record without slots (a flight file replayed through
            # the evaluator): fall back to the p99-vs-bound latch — the
            # whole window is bad past the bar at the p99's 1% share
            p99 = float(rec.get("p99_ms", 0.0))
            bound = spec.bound_ms if spec.bound_ms is not None else math.inf
            bad = math.ceil(total * 0.01) if p99 > bound else 0.0
            return float(bad), total
        bound = spec.bound_ms if spec.bound_ms is not None else math.inf
        return float(slot_bad_count(slots, bound)), total
    if spec.bad_rate is not None:
        dt = float(window.get("dt_s", 0.0))
        bad = float(window.get("rates", {}).get(spec.bad_rate, 0.0)) * dt
        rec = spans.get(spec.total_span)
        total = bad + (float(rec.get("count", 0)) if rec else 0.0)
        return bad, total
    return 0.0, 0.0


class Ewma:
    """Time-aware exponentially-weighted mean: the smoothing weight is
    derived from the REAL elapsed time per update (``alpha = 1 -
    0.5**(dt/half_life)``), so a widened pump gap smooths exactly as
    much as the wall clock says it should — the same gap-widening
    contract the ring's rates hold."""

    def __init__(self, half_life_s: float = 2.0):
        self.half_life_s = max(float(half_life_s), 1e-9)
        self.value: Optional[float] = None

    def update(self, x: float, dt_s: float) -> float:
        if self.value is None:
            self.value = float(x)
        else:
            alpha = 1.0 - 0.5 ** (max(dt_s, 0.0) / self.half_life_s)
            self.value += alpha * (float(x) - self.value)
        return self.value


class SaturationForecaster:
    """Queue-growth projection: estimated time until the admission
    latch trips.

    Per window it differences the depth gauge into a slope (events/s)
    and EWMA-smooths it; by queue conservation that slope IS the
    arrivals-vs-decisions imbalance (arrivals minus everything the
    engine retired). The *pressure* adds the shed rate back in — once
    shedding starts the depth clamps at the latch and the raw slope
    goes flat, but the arrivals that are being shed are still pressure,
    so the forecast keeps firing through the overload instead of
    flapping resolved at its peak.

    ``eta_s`` is ``(high_water - depth) / pressure`` when pressure is
    positive and the latch hasn't tripped; 0.0 at/above the high-water
    mark; ``None`` on a flat or draining queue (no saturation in
    sight — the documented ∞/none contract). ``alarm`` is the page
    condition: saturated now, or ETA within ``horizon_s``.
    """

    def __init__(self, high_water: Optional[int] = None,
                 depth_gauge: str = "engine.queue_depth",
                 horizon_s: float = 30.0, half_life_s: float = 2.0,
                 shed_rate: str = "shed_per_s",
                 min_pressure: float = 1e-6):
        self.high_water = high_water
        self.depth_gauge = depth_gauge
        self.horizon_s = float(horizon_s)
        self.shed_rate = shed_rate
        self.min_pressure = float(min_pressure)
        self._slope = Ewma(half_life_s)
        self._prev_depth: Optional[float] = None
        self._last: Dict = self._forecast(None, 0.0)

    def _forecast(self, depth: Optional[float],
                  shed_per_s: float) -> Dict:
        slope = self._slope.value
        pressure = (None if slope is None
                    else slope + max(shed_per_s, 0.0))
        eta: Optional[float] = None
        saturated = bool(self.high_water is not None
                         and depth is not None
                         and depth >= self.high_water)
        if (not saturated and self.high_water is not None
                and depth is not None and pressure is not None
                and pressure > self.min_pressure):
            eta = max((self.high_water - depth) / pressure, 0.0)
        if saturated:
            eta = 0.0
        alarm = bool(saturated
                     or (eta is not None and eta <= self.horizon_s))
        return {"depth": depth,
                "slope_per_s": slope,
                "pressure_per_s": pressure,
                "eta_s": eta,
                "high_water": self.high_water,
                "horizon_s": self.horizon_s,
                "saturated": saturated,
                "alarm": alarm}

    def update(self, window: Dict) -> Dict:
        depth = window.get("gauges", {}).get(self.depth_gauge)
        dt = float(window.get("dt_s", 0.0))
        shed = float(window.get("rates", {}).get(self.shed_rate, 0.0))
        if depth is not None and dt > 0:
            depth = float(depth)
            if self._prev_depth is not None:
                self._slope.update((depth - self._prev_depth) / dt, dt)
            self._prev_depth = depth
        self._last = self._forecast(
            float(depth) if depth is not None else self._prev_depth,
            shed)
        return self._last

    def snapshot(self) -> Dict:
        return dict(self._last)


class SignalEvaluator:
    """The pump-hook judge: ring windows in, verdicts + alert signals
    out.

    Holds the declared :class:`SloSpec` list, a bounded per-spec
    ``(bad, total)`` history for the slow burn window, and (when a
    high-water mark is known) a :class:`SaturationForecaster`. Each
    closed window produces one verdict per spec — state ``ok`` /
    ``warn`` (slow burn over ``warn_burn``) / ``page`` (fast burn over
    ``page_burn``) — plus the forecast, and forwards them as signals to
    an :class:`~avenir_tpu_torch.obs.alerts.AlertManager` when one is
    attached. Thread-safe snapshot for scrape endpoints and the
    end-of-run health record; never raises out of ``on_window`` (it
    rides the pump, which observes the process being judged).
    """

    def __init__(self, slos: Optional[Sequence[SloSpec]] = None,
                 manager=None, source: str = "engine",
                 high_water: Optional[int] = None,
                 depth_gauge: str = "engine.queue_depth",
                 horizon_s: float = 30.0):
        self.slos: List[SloSpec] = list(
            DEFAULT_SLOS if slos is None else slos)
        self.manager = manager
        self.source = source
        self.forecaster = (SaturationForecaster(
            high_water=high_water, depth_gauge=depth_gauge,
            horizon_s=horizon_s) if high_water is not None else None)
        self._history: Dict[str, Deque[Tuple[float, float]]] = {
            spec.name: collections.deque(
                maxlen=max(int(spec.slow_windows), 1))
            for spec in self.slos}
        self._lock = threading.Lock()
        self._last: Dict = {"slos": [], "forecast": None, "t": None}
        self.windows_seen = 0

    def _verdict(self, spec: SloSpec, window: Dict) -> Dict:
        bad, total = window_badness(spec, window)
        hist = self._history[spec.name]
        hist.append((bad, total))
        fast = burn_rate(bad, total, spec.budget)
        slow = burn_rate(sum(b for b, _ in hist),
                         sum(t for _, t in hist), spec.budget)
        if fast >= spec.page_burn and total > 0:
            state = "page"
        elif slow >= spec.warn_burn:
            state = "warn"
        else:
            state = "ok"
        return {"name": spec.name,
                "state": state,
                "severity": (spec.severity if state == "page"
                             else "warn"),
                "fast_burn": fast,
                "slow_burn": slow,
                "bad": bad,
                "total": total,
                "bound_ms": spec.bound_ms,
                "budget": spec.budget}

    def on_window(self, window: Dict) -> Dict:
        """Evaluate one closed ring window (the pump's ``on_window``
        hook). Returns the snapshot it just installed."""
        verdicts = [self._verdict(spec, window) for spec in self.slos]
        signals = [{"name": f"slo:{v['name']}",
                    "source": self.source,
                    "severity": v["severity"],
                    "active": v["state"] != "ok",
                    "payload": {"fast_burn": v["fast_burn"],
                                "slow_burn": v["slow_burn"],
                                "state": v["state"]}}
                   for v in verdicts]
        forecast = None
        if self.forecaster is not None:
            forecast = self.forecaster.update(window)
            signals.append({"name": "saturation_forecast",
                            "source": self.source,
                            "severity": "page",
                            "active": forecast["alarm"],
                            "payload": {"eta_s": forecast["eta_s"],
                                        "depth": forecast["depth"],
                                        "pressure_per_s":
                                            forecast["pressure_per_s"]}})
        last = {"slos": verdicts, "forecast": forecast,
                "t": window.get("t")}
        with self._lock:
            self._last = last
            self.windows_seen += 1
        if self.manager is not None:
            try:
                self.manager.observe(signals, now=window.get("t"))
            except Exception:
                pass
        return last

    def worst_burn(self) -> float:
        """Max burn rate across every spec's fast and slow windows in
        the last evaluation — a report's one-number health."""
        with self._lock:
            burns = [b for v in self._last["slos"]
                     for b in (v["fast_burn"], v["slow_burn"])]
        return max(burns) if burns else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            out = dict(self._last)
            out["source"] = self.source
            out["windows_seen"] = self.windows_seen
        out["worst_burn"] = self.worst_burn()
        return out
