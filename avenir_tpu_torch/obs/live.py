"""Live scrape endpoints and the one-call live-observability bundle.

Counterpart of ``avenir_tpu/obs/live.py`` (pure stdlib, copied): a
stdlib ``http.server`` thread a process that opts in, serving

- ``GET /metrics``: the Prometheus text of the hub's current cumulative
  report;
- ``GET /metrics/rates``: the :class:`~avenir_tpu_torch.obs.timeseries.
  MetricsRing` windows as JSON (decisions/s, rewards/s, shed/s, window
  percentiles);
- ``GET /healthz``: liveness, identity and whatever the process's health
  provider reports;
- ``GET /alerts``: the alert manager's snapshot.

Opt-in only (``--obs-port`` / ``obs.http.port``); ``port=0`` takes a free
port, and the bound one is returned so callers can print it.

:func:`start_live_obs` is the bundle the CLI calls: enable the hub if
needed, start the pump into a fresh ring, optionally bind the HTTP
thread, arm the flight recorder (crash hooks, an atexit backstop and
SIGUSR2 on the main thread); :meth:`LiveObs.stop` undoes all of it (a
clean stop disarms the atexit dump).
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from avenir_tpu_torch.obs import timeseries as _timeseries


class _ObsHandler(BaseHTTPRequestHandler):
    server_version = "avenir-obs/1"

    def log_message(self, *args) -> None:   # scrapes must not spam stderr
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:   # noqa: N802 (http.server API)
        owner: "ObsHttpServer" = self.server.owner  # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, owner.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics/rates":
                self._send(200, json.dumps(owner.rates(),
                                           sort_keys=True).encode(),
                           "application/json")
            elif path == "/healthz":
                self._send(200, json.dumps(owner.health(),
                                           sort_keys=True).encode(),
                           "application/json")
            elif path == "/alerts":
                self._send(200, json.dumps(owner.alerts(),
                                           sort_keys=True).encode(),
                           "application/json")
            else:
                self._send(404, b'{"error": "not found"}',
                           "application/json")
        except Exception as exc:
            # a scrape defect must never take the serving process with
            # it — and a 500 with the repr beats a dropped connection
            try:
                self._send(500, json.dumps(
                    {"error": repr(exc)}).encode(), "application/json")
            except Exception:
                pass


class ObsHttpServer:
    """The per-process scrape endpoint: daemon-threaded stdlib HTTP
    server over the hub + a ring. ``port=0`` auto-assigns; ``.port``
    holds the bound one after ``start()``."""

    def __init__(self, ring: Optional[_timeseries.MetricsRing] = None,
                 host: str = "localhost", port: int = 0,
                 health_provider: Optional[Callable[[], Dict]] = None,
                 alerts_provider: Optional[Callable[[], Dict]] = None):
        self.ring = ring
        self.host = host
        self.port = int(port)
        self.health_provider = health_provider
        # an AlertManager.snapshot — the /alerts body and the healthz
        # degradation input
        self.alerts_provider = alerts_provider
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None

    # -- endpoint bodies (handler delegates here; tests call directly) ----
    def metrics_text(self) -> str:
        from avenir_tpu_torch.obs.exporters import hub, prometheus_text
        return prometheus_text(hub().report())

    def rates(self) -> Dict:
        if self.ring is None:
            return {"format": "avenir-timeseries-v1", "n": 0,
                    "windows": [], "current": {}}
        return self.ring.rates_snapshot()

    def alerts(self) -> Dict:
        """The ``/alerts`` body: the manager's snapshot, or an empty
        well-formed one when no alerting is armed (the endpoint must
        answer either way, like ``rates()`` on an empty ring)."""
        if self.alerts_provider is None:
            return {"format": "avenir-alerts-v1", "now": time.time(),
                    "alerts": [], "firing": [],
                    "counts": {"pending": 0, "firing": 0,
                               "resolved": 0},
                    "events_total": 0}
        return self.alerts_provider()

    def health(self) -> Dict:
        from avenir_tpu_torch.obs.exporters import TelemetryHub
        h = TelemetryHub._instance
        out: Dict = {
            "ok": True,
            "ts": time.time(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "uptime_s": (round(time.time() - self._started_at, 3)
                         if self._started_at else 0.0),
            "telemetry_enabled": bool(h is not None and h.enabled),
        }
        if self.alerts_provider is not None:
            # healthz degrades on page-severity firings:
            # "ok" stays the liveness bit a supervisor restarts on,
            # flipping only for pages — warn-level burn is degradation
            # a human reads, not a restart signal
            try:
                snap = self.alerts_provider() or {}
                firing = list(snap.get("firing", []))
                out["alerts_firing"] = len(firing)
                if firing:
                    out["firing"] = firing
                paging = sorted(
                    a["name"] for a in snap.get("alerts", [])
                    if a.get("state") == "firing"
                    and a.get("severity") == "page")
                out["degraded"] = bool(firing)
                if paging:
                    out["ok"] = False
                    out["paging"] = paging
            except Exception as exc:
                out["alerts_error"] = repr(exc)
        if self.health_provider is not None:
            try:
                out.update(self.health_provider() or {})
            except Exception as exc:
                out["provider_error"] = repr(exc)
        return out

    # -- lifecycle --------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ObsHttpServer":
        if self.running:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _ObsHandler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._started_at = time.time()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="avenir-obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._thread = None


class LiveObs:
    """Handle over one process's live-observability bundle (ring, pump,
    optional HTTP endpoint, optional flight recorder)."""

    def __init__(self, ring, pump, server: Optional[ObsHttpServer],
                 recorder, enabled_hub_here: bool,
                 evaluator=None, alerts=None):
        self.ring = ring
        self.pump = pump
        self.server = server
        self.recorder = recorder
        self.evaluator = evaluator   # SignalEvaluator, when armed
        self.alerts = alerts         # AlertManager, when armed
        # the exact provider object installed on the hub — bound-method
        # access mints a fresh object each time, so the identity-gated
        # clear needs the one that was set
        self._hub_alerts_provider = None
        self._enabled_hub_here = enabled_hub_here
        self._stopped = False

    @property
    def port(self) -> Optional[int]:
        return self.server.port if self.server is not None else None

    def set_health_provider(self, provider: Callable[[], Dict]) -> None:
        if self.server is not None:
            self.server.health_provider = provider

    def crash_dump(self, fallback_reason: str) -> None:
        """Backstop dump for a death that may bypass the engine/loop
        crash hooks: one final pump sample so the fatal window makes
        the ring, then a dump that forwards a crash hook's richer
        attribution when one already landed (``backstop_reason``)."""
        if self.recorder is not None:
            self.pump.sample_once()
            self.recorder.dump(
                self.recorder.backstop_reason(fallback_reason))

    def _atexit(self) -> None:
        # the crash backstop: a process that dies without a clean
        # stop() leaves its flight record behind
        if not self._stopped:
            self.crash_dump("atexit")

    def stop(self, dump: bool = False) -> None:
        """Clean teardown: final pump sample, optional farewell dump,
        endpoint + pump down, recorder disarmed (no atexit dump, SIGUSR2
        handler restored, this bundle no longer ``current()``) — a later
        ``start_live_obs`` in the same process starts from a clean
        slate instead of chaining into this run's handlers."""
        global _CURRENT
        if self._stopped:
            return
        self._stopped = True
        self.pump.stop()
        if self.alerts is not None:
            # final transition log + detach from the hub's report (a
            # newer bundle's manager survives: clear is identity-gated)
            self.alerts.flush()
            if self._hub_alerts_provider is not None:
                from avenir_tpu_torch.obs.exporters import hub
                hub().clear_alerts_provider(self._hub_alerts_provider)
        if dump and self.recorder is not None:
            self.recorder.dump("stop")
        if self.server is not None:
            self.server.stop()
        if self.recorder is not None:
            self.recorder.disarm_signal()
            atexit.unregister(self._atexit)
        # disarm only OUR recorder: a newer bundle's armed crash hook
        # must survive an older (or recorder-less) bundle's stop
        if (self.recorder is not None
                and _timeseries.armed_flight_recorder() is self.recorder):
            _timeseries.arm_flight_recorder(None)
        if _CURRENT is self:
            _CURRENT = None
        if self._enabled_hub_here:
            from avenir_tpu_torch.obs.exporters import hub
            hub().disable()


# one live bundle per process is the norm (like the hub); entry points
# that armed it leave it discoverable for deeper wiring (the elastic
# worker installing its epoch/ownership health provider)
_CURRENT: Optional[LiveObs] = None


def current() -> Optional[LiveObs]:
    return _CURRENT


def start_live_obs(port: Optional[int] = None, host: str = "localhost",
                   interval_s: float = 0.25,
                   flight_path: Optional[str] = None,
                   slo_p99_ms: Optional[float] = None,
                   ring_windows: int = 240,
                   health_provider: Optional[Callable[[], Dict]] = None,
                   arm_signal: bool = True,
                   slos=None,
                   alerts: Optional[bool] = None,
                   alerts_path: Optional[str] = None,
                   high_water: Optional[int] = None,
                   forecast_horizon_s: float = 30.0,
                   alert_source: str = "engine") -> LiveObs:
    """Arm the live half of ``obs`` for this process.

    - Enables the :class:`TelemetryHub` if nothing else has (remembering
      whether it did, so ``stop()`` only disables what it enabled).
    - Starts a :class:`MetricsPump` into a fresh ring at ``interval_s``.
    - ``port`` not None: binds the scrape endpoint there (0 =
      auto-assign; read ``.port`` back and surface it in the job JSON).
    - ``flight_path``: arms a :class:`FlightRecorder` there — crash
      hooks + atexit backstop + SIGUSR2 (main thread only) + SLO breach
      at ``slo_p99_ms`` (or, when the caller declared a ``slos`` list
      and gave no explicit bar, at its primary latency SLO's bound —
      one source of truth; default alerting alone leaves the
      single-window latch un-armed).
    - **Alerting**: armed when ``alerts`` is True, or left
      at None with any of ``slos`` / ``alerts_path`` / ``high_water``
      given. A :class:`~avenir_tpu_torch.obs.signals.SignalEvaluator` over
      ``slos`` (default: the declared fleet SLOs) rides the pump behind
      the recorder's check; its verdicts feed an :class:`~avenir_tpu_torch.
      obs.alerts.AlertManager` whose snapshot backs ``/alerts`` +
      healthz degradation, whose samples land in every hub report (and
      so in ``/metrics`` + the .prom file), and whose transition log is
      rewritten atomically at ``alerts_path``. ``high_water`` (the
      admission latch) arms the saturation forecast with horizon
      ``forecast_horizon_s``.
    """
    global _CURRENT
    from avenir_tpu_torch.obs.exporters import hub
    h = hub()
    enabled_here = not h.enabled
    if enabled_here:
        h.enable()
    ring = _timeseries.MetricsRing(max_windows=ring_windows)

    if alerts is None:
        alerts = bool(slos is not None or alerts_path
                      or high_water is not None)
    evaluator = manager = None
    hub_provider = None
    if alerts:
        from avenir_tpu_torch.obs import alerts as _alerts
        from avenir_tpu_torch.obs import signals as _signals
        specs = list(_signals.DEFAULT_SLOS if slos is None else slos)
        manager = _alerts.AlertManager(path=alerts_path)
        evaluator = _signals.SignalEvaluator(
            slos=specs, manager=manager, source=alert_source,
            high_water=high_water, horizon_s=forecast_horizon_s)
        hub_provider = manager.alert_samples
        h.set_alerts_provider(hub_provider)
        # the recorder's single-window breach latch arms off the spec
        # list only when the caller DECLARED one: default alerting must
        # not change the recorder's behavior (a worker's cold-start
        # compile blip is absorbed by the alert pending window, but
        # would trip the one-window latch and dump on a clean exit)
        if slo_p99_ms is None and slos is not None:
            primary = _signals.primary_latency_slo(specs)
            if primary is not None:
                slo_p99_ms = primary.bound_ms

    recorder = None
    if flight_path:
        recorder = _timeseries.FlightRecorder(ring, flight_path,
                                              slo_p99_ms=slo_p99_ms)
        _timeseries.arm_flight_recorder(recorder)
        if arm_signal:
            recorder.arm_signal()

    hooks = [hook for hook in
             (recorder.check if recorder is not None else None,
              evaluator.on_window if evaluator is not None else None)
             if hook is not None]

    def on_window(window):
        # each hook isolated: a recorder defect must not starve the
        # evaluator of its window (and vice versa)
        for hook in hooks:
            try:
                hook(window)
            except Exception:
                pass

    pump = _timeseries.MetricsPump(
        ring, interval_s=interval_s, hub=h,
        on_window=on_window if hooks else None)
    pump.start()
    server = None
    if port is not None:
        server = ObsHttpServer(
            ring=ring, host=host, port=port,
            health_provider=health_provider,
            alerts_provider=(manager.snapshot
                             if manager is not None else None))
        server.start()
    live = LiveObs(ring, pump, server, recorder, enabled_here,
                   evaluator=evaluator, alerts=manager)
    live._hub_alerts_provider = hub_provider
    if recorder is not None:
        atexit.register(live._atexit)
    _CURRENT = live
    return live
