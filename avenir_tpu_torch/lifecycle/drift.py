"""Drift detection over the serving tier's own signals.

Counterpart of ``avenir_tpu/lifecycle/drift.py`` (the standard library,
copied). Sequential change detectors watch the reward stream (or any
scalar signal) and fire the ``RetrainDaemon`` (or only count an alarm,
where none is wired) once the live distribution moves away from what the
serving state learned:

- :class:`PageHinkley`: the sequential test: deviations from the running
  mean accumulate, and it flags when their sum drifts ``threshold`` away
  from its extremum (slow, sustained shifts);
- :class:`WindowedMeanDetector`: a frozen reference window against a
  sliding current one; it flags when their means part by ``threshold``
  (abrupt level shifts);
- :class:`ThresholdDetector`: a latched level crossing for maintenance
  signals.

:class:`DriftMonitor` routes named signals to their detectors, throttles
retrain requests (``cooldown_s``) and publishes
``lifecycle.drift_alarms``. One deviation from the JAX package, which
starts its cooldown clock at 0 of ``time.monotonic()`` and so swallows
the first request on a host up for less than ``cooldown_s``: here the
cooldown starts at the first request, so the first alarm always requests
a retrain, at any uptime.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional


class PageHinkley:
    """Page–Hinkley sequential drift test (two-sided by default).

    ``delta`` absorbs normal jitter around the running mean;
    ``threshold`` (lambda) is the cumulative evidence needed to flag.
    ``min_samples`` gates the warm-up — a test over 3 events is noise.
    After a detection the test resets (a fresh baseline: the post-drift
    distribution IS the new normal once a retrain lands)."""

    def __init__(self, delta: float = 0.005, threshold: float = 50.0,
                 min_samples: int = 30, direction: str = "both"):
        if direction not in ("up", "down", "both"):
            raise ValueError(f"invalid direction {direction!r}")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.direction = direction
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        # TWO accumulators (the textbook two-sided form): each side's
        # delta biases its own sum AWAY from firing under stationarity —
        # a single shared sum would drift by -delta per step and
        # eventually trip the down test on perfectly stationary input
        self._cum_up = 0.0       # sum of (x - mean - delta); min-anchored
        self._up_min = 0.0
        self._cum_dn = 0.0       # sum of (x - mean + delta); max-anchored
        self._dn_max = 0.0

    def update(self, x: float) -> bool:
        """Feed one observation; True when drift is detected (and the
        test has reset itself)."""
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        dev = x - self.mean
        self._cum_up += dev - self.delta
        self._up_min = min(self._up_min, self._cum_up)
        self._cum_dn += dev + self.delta
        self._dn_max = max(self._dn_max, self._cum_dn)
        if self.n < self.min_samples:
            return False
        up = self._cum_up - self._up_min > self.threshold
        down = self._dn_max - self._cum_dn > self.threshold
        drifted = ((self.direction in ("up", "both") and up)
                   or (self.direction in ("down", "both") and down))
        if drifted:
            self.reset()
        return drifted


class WindowedMeanDetector:
    """Reference-window vs current-window mean shift.

    The first ``window`` observations freeze as the reference (what the
    serving model was trained against); a sliding window tracks the
    present. Drift = ``|current_mean - reference_mean| > threshold``
    once both windows are full. Resets re-baseline on the post-drift
    window."""

    def __init__(self, window: int = 128, threshold: float = 0.2):
        self.window = max(int(window), 1)
        self.threshold = float(threshold)
        self.reset()

    def reset(self) -> None:
        self._ref: deque = deque(maxlen=self.window)
        self._ref_sum = 0.0
        self._cur: deque = deque(maxlen=self.window)
        self._cur_sum = 0.0

    @property
    def reference_mean(self) -> Optional[float]:
        if len(self._ref) < self.window:
            return None
        return self._ref_sum / len(self._ref)

    def update(self, x: float) -> bool:
        x = float(x)
        if len(self._ref) < self.window:
            self._ref.append(x)
            self._ref_sum += x
            return False
        if len(self._cur) == self._cur.maxlen:
            self._cur_sum -= self._cur[0]
        self._cur.append(x)
        self._cur_sum += x
        if len(self._cur) < self.window:
            return False
        drifted = abs(self._cur_sum / len(self._cur)
                      - self.reference_mean) > self.threshold
        if drifted:
            self.reset()
        return drifted


class ThresholdDetector:
    """A latched level crossing for maintenance signals (a live index's
    tail-fill share, a list's skew): resource pressure with a known bound,
    not distribution drift. It fires once when the signal crosses
    ``threshold`` and re-arms only after it falls back, so one sustained
    excursion requests one wave however often it is observed. It has the
    detectors' ``update(x) -> bool``, so :class:`DriftMonitor` takes it
    beside Page-Hinkley."""

    def __init__(self, threshold: float, direction: str = "up"):
        if direction not in ("up", "down"):
            raise ValueError(f"invalid direction {direction!r}")
        self.threshold = float(threshold)
        self.direction = direction
        self._armed = True

    def update(self, x: float) -> bool:
        x = float(x)
        crossed = (x > self.threshold if self.direction == "up"
                   else x < self.threshold)
        if crossed and self._armed:
            self._armed = False
            return True
        if not crossed:
            self._armed = True
        return False


class DriftMonitor:
    """Named signals -> detectors -> retrain request / alarm counter.

    ``detectors`` maps a signal name (``"reward"``, ``"input.mean"``,
    any gauge-shaped scalar stream) to its detector. ``on_drift`` is
    usually ``daemon.request``; with none wired the monitor only alarms.
    ``cooldown_s`` throttles back-to-back requests — one regime change
    must trigger ONE retrain wave, not one per post-shift batch."""

    def __init__(self, detectors: Dict[str, object],
                 on_drift: Optional[Callable[[], None]] = None,
                 cooldown_s: float = 5.0):
        self.detectors = dict(detectors)
        self.on_drift = on_drift
        self.cooldown_s = float(cooldown_s)
        self.alarms = 0
        self.alarms_by_signal: Dict[str, int] = {}
        self.last_drift_at: Optional[float] = None
        # the first request's clock reading; None until then, so the
        # first alarm requests at any uptime
        self._last_request_at: Optional[float] = None

    def observe(self, signal: str, value: float) -> bool:
        """Feed one observation of ``signal``; True when its detector
        flagged drift (alarm counted, retrain requested modulo
        cooldown)."""
        det = self.detectors.get(signal)
        if det is None or not det.update(value):
            return False
        self.alarms += 1
        self.alarms_by_signal[signal] = (
            self.alarms_by_signal.get(signal, 0) + 1)
        self.last_drift_at = time.time()
        self._publish_gauges()
        if self.on_drift is not None:
            now = time.monotonic()
            if (self._last_request_at is None
                    or now - self._last_request_at >= self.cooldown_s):
                self._last_request_at = now
                self.on_drift()
        return True

    def observe_rewards(self, rewards: Iterable[float],
                        signal: str = "reward") -> bool:
        """Feed a drained reward batch (the engine's ``_fold_rewards``
        hook); True if any observation flagged."""
        drifted = False
        for r in rewards:
            drifted = self.observe(signal, float(r)) or drifted
        return drifted

    def _publish_gauges(self) -> None:
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        set_hub_gauges_if_live({"lifecycle.drift_alarms": self.alarms})
