"""Alert state machine over derived signals, and its delivery sinks.

Counterpart of ``avenir_tpu/obs/alerts.py`` (pure stdlib, copied).
``obs.signals`` turns ring windows into verdicts; the
:class:`AlertManager` turns verdicts into episodes, with the latch
discipline of the FlightRecorder's breach trigger and the lifecycle's
DriftMonitor:

- **pending -> firing -> resolved**: a signal must stay active for
  ``pending_windows`` consecutive evaluations to fire, and quiet for
  ``resolve_windows`` to resolve; a resolved episode re-fires as a new
  episode.
- **dedup by (name, source)**: a fleet evaluator and a worker's can both
  report ``slo:admitted_p99`` without colliding.
- **cooldown**: a re-fire within ``cooldown_s`` of the last resolve keeps
  the bookkeeping but notifies no subscriber and dumps nothing.

Delivery, all best-effort (alerting never sinks the process it watches):
``alert.*`` hub gauges and :meth:`alert_samples`, the hub's alerts
provider (``prometheus_text`` renders each alert as a labeled series);
a rename-atomic ``<metrics_out>.alerts.jsonl`` transition log (one
``alerts-meta`` line, one line a transition, bounded); ``subscribe()``
callbacks on every transition; and page-severity firings latch the armed
FlightRecorder's dump.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from avenir_tpu_torch.obs import timeseries as _timeseries

_SEV_RANK = {"page": 2, "warn": 1, "info": 0}


class Alert:
    """One (name, source) episode track: identity, current state, and
    the timestamps the snapshot + JSONL carry."""

    __slots__ = ("name", "source", "severity", "state", "since",
                 "updated", "fired_at", "resolved_at", "episodes",
                 "payload")

    def __init__(self, name: str, source: str, severity: str,
                 now: float):
        self.name = name
        self.source = source
        self.severity = severity
        self.state = "pending"
        self.since = now
        self.updated = now
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.episodes = 0
        self.payload: Dict = {}

    def to_dict(self) -> Dict:
        return {"name": self.name, "source": self.source,
                "severity": self.severity, "state": self.state,
                "since": self.since, "updated": self.updated,
                "fired_at": self.fired_at,
                "resolved_at": self.resolved_at,
                "episodes": self.episodes, "payload": self.payload}


class AlertManager:
    """The per-process (or per-coordinator) alert registry + sinks."""

    def __init__(self, path: Optional[str] = None,
                 pending_windows: int = 1, resolve_windows: int = 3,
                 cooldown_s: float = 0.0, max_events: int = 512):
        self.path = path
        self.pending_windows = max(int(pending_windows), 0)
        self.resolve_windows = max(int(resolve_windows), 1)
        self.cooldown_s = float(cooldown_s)
        self._alerts: Dict[Tuple[str, str], Alert] = {}
        self._active_runs: Dict[Tuple[str, str], int] = {}
        self._quiet_runs: Dict[Tuple[str, str], int] = {}
        self._events: Deque[Dict] = collections.deque(
            maxlen=max(int(max_events), 1))
        self.events_total = 0
        self._subs: List[Callable[[Dict, str], None]] = []
        # reentrant: a subscriber may legitimately read snapshot()
        self._lock = threading.RLock()

    # -- consumers ---------------------------------------------------------
    def subscribe(self, callback: Callable[[Dict, str], None]) -> None:
        """Register ``callback(alert_dict, transition)`` for every
        pending/firing/resolved transition (cooldown-suppressed
        re-fires excepted). Exceptions are swallowed per callback."""
        with self._lock:
            self._subs.append(callback)

    # -- the state machine -------------------------------------------------
    def observe(self, signals: List[Dict],
                now: Optional[float] = None) -> List[Dict]:
        """Fold one evaluation round of signals (each ``{"name",
        "source", "severity", "active", "payload"}``) into the
        registry. A known key ABSENT from the round counts as inactive
        — a spec removed from the evaluator resolves rather than
        freezing mid-fire. Returns the transitions taken this round."""
        t = time.time() if now is None else float(now)
        transitions: List[Tuple[Dict, str, bool]] = []
        with self._lock:
            seen = set()
            for sig in signals:
                key = (str(sig.get("name", "")),
                       str(sig.get("source", "")))
                seen.add(key)
                if sig.get("active"):
                    self._mark_active(key, sig, t, transitions)
                else:
                    self._mark_quiet(key, t, transitions)
            for key in list(self._alerts):
                if key not in seen:
                    self._mark_quiet(key, t, transitions)
            for alert_dict, transition, notify in transitions:
                self._events.append(
                    {"type": "alert", "ts": t,
                     "transition": transition, **alert_dict})
                self.events_total += 1
        self._deliver(transitions)
        return [dict(e[0], transition=e[1]) for e in transitions]

    def _mark_active(self, key: Tuple[str, str], sig: Dict, now: float,
                     transitions: List) -> None:
        alert = self._alerts.get(key)
        severity = str(sig.get("severity", "warn"))
        if alert is None or alert.state == "resolved":
            restart = alert
            alert = Alert(key[0], key[1], severity, now)
            if restart is not None:
                alert.episodes = restart.episodes
                alert.resolved_at = restart.resolved_at
            self._alerts[key] = alert
            self._active_runs[key] = 0
            transitions.append((dict(alert.to_dict(),
                                     payload=dict(sig.get("payload")
                                                  or {})),
                                "pending", True))
        # severity only upgrades within an episode: a page that decays
        # to warn-level burn is still the page someone was woken for
        if _SEV_RANK.get(severity, 0) > _SEV_RANK.get(alert.severity, 0):
            alert.severity = severity
        alert.payload = dict(sig.get("payload") or {})
        alert.updated = now
        self._quiet_runs[key] = 0
        runs = self._active_runs.get(key, 0) + 1
        self._active_runs[key] = runs
        if alert.state == "pending" and runs > self.pending_windows:
            alert.state = "firing"
            alert.fired_at = now
            alert.episodes += 1
            # cooldown: bookkeeping proceeds, notification is flap-
            # controlled against the PREVIOUS episode's resolve
            notify = not (alert.resolved_at is not None
                          and self.cooldown_s > 0
                          and (now - alert.resolved_at)
                          < self.cooldown_s)
            transitions.append((alert.to_dict(), "firing", notify))

    def _mark_quiet(self, key: Tuple[str, str], now: float,
                    transitions: List) -> None:
        alert = self._alerts.get(key)
        if alert is None or alert.state == "resolved":
            return
        self._active_runs[key] = 0
        runs = self._quiet_runs.get(key, 0) + 1
        self._quiet_runs[key] = runs
        if runs < self.resolve_windows:
            return
        if alert.state == "pending":
            # never fired: drop silently — a two-window blip that never
            # crossed the pending bar is noise, not an episode
            del self._alerts[key]
            return
        alert.state = "resolved"
        alert.resolved_at = now
        alert.updated = now
        transitions.append((alert.to_dict(), "resolved", True))

    # -- delivery ----------------------------------------------------------
    def _deliver(self, transitions: List[Tuple[Dict, str, bool]]) -> None:
        """Sinks, outside any hot path and each best-effort: page dump,
        subscribers, the JSONL rewrite, the alert.* gauges."""
        for alert_dict, transition, notify in transitions:
            if not notify:
                continue
            if (transition == "firing"
                    and alert_dict.get("severity") == "page"):
                _timeseries.flight_dump_if_armed(
                    f"alert:{alert_dict['name']}")
            with self._lock:
                subs = list(self._subs)
            for callback in subs:
                try:
                    callback(alert_dict, transition)
                except Exception:
                    pass
        if transitions:
            self.flush()
        self._publish_gauges()

    def _counts(self) -> Dict[str, int]:
        counts = {"pending": 0, "firing": 0, "resolved": 0}
        for alert in self._alerts.values():
            counts[alert.state] = counts.get(alert.state, 0) + 1
        return counts

    def _publish_gauges(self) -> None:
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        with self._lock:
            counts = self._counts()
            total = self.events_total
        set_hub_gauges_if_live({
            "alert.firing": counts["firing"],
            "alert.pending": counts["pending"],
            "alert.resolved": counts["resolved"],
            "alert.events_total": total,
        })

    def flush(self) -> Optional[str]:
        """Rewrite the transition log rename-atomically; None (never a
        raise) when there is no path or the write fails."""
        if not self.path:
            return None
        from avenir_tpu_torch.obs.exporters import write_jsonl
        try:
            with self._lock:
                events: List[Dict] = [
                    {"type": "alerts-meta",
                     "format": "avenir-alerts-v1",
                     "ts": time.time(),
                     "events_total": self.events_total,
                     "events": len(self._events)}]
                events.extend(self._events)
            write_jsonl(events, self.path)
            return self.path
        except Exception:
            return None

    # -- exports -----------------------------------------------------------
    def firing(self) -> List[str]:
        """Sorted names with a live firing episode — THE set every sink
        (``/alerts``, the JSONL, the .prom rendering) must agree on."""
        with self._lock:
            return sorted({a.name for a in self._alerts.values()
                           if a.state == "firing"})

    def alert_samples(self) -> List[Dict]:
        """The hub's alerts-provider payload: one flat labeled sample
        per tracked alert, rendered by ``prometheus_text`` as
        ``avenir_alert{name=...,source=...,state=...,severity=...} 1``."""
        with self._lock:
            alerts = sorted(self._alerts.values(),
                            key=lambda a: (a.name, a.source))
            return [{"name": a.name, "source": a.source,
                     "state": a.state, "severity": a.severity}
                    for a in alerts]

    def snapshot(self) -> Dict:
        """The ``/alerts`` endpoint body + a report's health record."""
        with self._lock:
            alerts = sorted((a.to_dict()
                             for a in self._alerts.values()),
                            key=lambda d: (d["name"], d["source"]))
            counts = self._counts()
            total = self.events_total
        return {"format": "avenir-alerts-v1",
                "now": time.time(),
                "alerts": alerts,
                "firing": sorted(a["name"] for a in alerts
                                 if a["state"] == "firing"),
                "counts": counts,
                "events_total": total}

    def brief(self) -> Dict:
        """One-line health for worker stats / job JSON."""
        with self._lock:
            counts = self._counts()
            paging = sorted(a.name for a in self._alerts.values()
                            if a.state == "firing"
                            and a.severity == "page")
        return {"firing": counts["firing"],
                "pending": counts["pending"],
                "paging": paging}
