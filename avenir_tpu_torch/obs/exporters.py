"""Exporters, and the TelemetryHub that merges every signal into one
report.

Counterpart of ``avenir_tpu/obs/exporters.py`` (pure Python, copied). Two
wire formats:

- **JSONL events**: one JSON object a line, each with a ``type``
  (``span`` / ``counter`` / ``gauge`` / ``runtime`` / ``meta``);
  :func:`read_jsonl` reads them back.
- **Prometheus text exposition** (0.0.4): counters and gauges as single
  samples, span histograms as ``_bucket``/``_sum``/``_count`` families
  with cumulative ``le`` labels.

:class:`TelemetryHub` is the process singleton: the global tracer's span
histograms, a :class:`RuntimeSampler` and :class:`CompileTracker`, gauges,
and every ``utils.metrics.MetricsRegistry`` built while it is enabled
(the registry calls the sink this hub installs). Registries are held
until ``reset()``: jobs drop theirs before the report is written. All of
it is off by default; ``hub().enable()`` is the one switch (the CLI's
``--metrics-out``).
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from avenir_tpu_torch.obs import runtime as _runtime
from avenir_tpu_torch.obs import telemetry as _telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a dotted/slashed name into a Prometheus metric name."""
    clean = _NAME_RE.sub("_", name)
    if clean and clean[0].isdigit():
        clean = "_" + clean
    return clean


def _prom_label(value: str) -> str:
    """Escape a label VALUE per the exposition format (0.0.4): backslash
    first (it is the escape character), then double-quote, then newline.
    Hostile span/gauge/source names — workers are free to put anything
    in a group id — must not be able to smuggle extra labels or break a
    scraper's line parse; :func:`parse_prometheus_text` round-trips the
    escape (tier-1 covered with hostile names)."""
    return value.replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def parse_prometheus_text(text: str) -> List[Tuple[str, Dict[str, str],
                                                   float]]:
    """Minimal exposition-format reader: ``(metric name, labels, value)``
    per sample line, label values UNESCAPED — the inverse of
    :func:`_prom_label`. Exists for the escaping round-trip tests and
    the live-scrape smokes (assert decisions/s > 0 straight off a
    ``/metrics`` body); not a general Prometheus client."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        labels: Dict[str, str] = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            i = 0
            while i < len(rest) and rest[i] != "}":
                eq = rest.index("=", i)
                key = rest[i:eq].lstrip(",").strip()
                if eq + 1 >= len(rest) or rest[eq + 1] != '"':
                    raise ValueError(f"malformed label in {line!r}")
                j = eq + 2
                buf: List[str] = []
                while j < len(rest) and rest[j] != '"':
                    if rest[j] == "\\" and j + 1 < len(rest):
                        esc = rest[j + 1]
                        buf.append("\n" if esc == "n" else esc)
                        j += 2
                    else:
                        buf.append(rest[j])
                        j += 1
                if j >= len(rest):
                    raise ValueError(f"unterminated label in {line!r}")
                labels[key] = "".join(buf)
                i = j + 1
            value = float(rest[i + 1:])
        else:
            name, _, value_s = line.partition(" ")
            value = float(value_s)
        out.append((name, labels, value))
    return out


def report_to_events(report: Dict) -> List[Dict]:
    """Flatten a merged report into the JSONL event list."""
    events: List[Dict] = [{"type": "meta", **report.get("meta", {})}]
    for name, snap in report.get("spans", {}).items():
        events.append({"type": "span", "name": name, **snap})
    for name, value in sorted(report.get("counters", {}).items()):
        events.append({"type": "counter", "name": name, "value": value})
    for name, value in sorted(report.get("gauges", {}).items()):
        events.append({"type": "gauge", "name": name, "value": value})
    for sample in report.get("alerts", []):
        events.append({"type": "alert", **sample})
    if "runtime" in report:
        events.append({"type": "runtime", **report["runtime"]})
    return events


def _atomic_write(path: str, emit: Callable) -> None:
    """Write through a same-directory temp file + ``os.replace``: a crash
    (or serialization error) mid-report leaves the previous file intact
    instead of a truncated JSONL/.prom for a coordinator to mis-parse.
    Same-filesystem rename is atomic on POSIX."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            emit(fh)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def write_jsonl(events: Iterable[Dict], path: str) -> None:
    def emit(fh):
        for event in events:
            fh.write(json.dumps(event, sort_keys=True) + "\n")
    _atomic_write(path, emit)


def read_jsonl(path: str) -> List[Dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def events_to_report(events: Iterable[Dict]) -> Dict:
    """Inverse of :func:`report_to_events` (modulo key ordering): rebuild
    the merged-report dict from a JSONL event list."""
    report: Dict = {"spans": {}, "counters": {}, "gauges": {}}
    for event in events:
        kind = event.get("type")
        body = {k: v for k, v in event.items() if k != "type"}
        if kind == "span":
            report["spans"][body.pop("name")] = body
        elif kind == "counter":
            report["counters"][body["name"]] = body["value"]
        elif kind == "gauge":
            report["gauges"][body["name"]] = body["value"]
        elif kind == "alert":
            report.setdefault("alerts", []).append(body)
        elif kind == "runtime":
            report["runtime"] = body
        elif kind == "meta":
            report["meta"] = body
    return report


def prometheus_text(report: Dict, prefix: str = "avenir") -> str:
    """Render the merged report as Prometheus text exposition 0.0.4."""
    lines: List[str] = []

    def emit(name: str, kind: str, samples: List[str]) -> None:
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)

    for name, value in sorted(report.get("counters", {}).items()):
        metric = f"{prefix}_{_prom_name(name)}"
        emit(metric, "counter", [f"{metric} {value}"])
    for name, value in sorted(report.get("gauges", {}).items()):
        metric = f"{prefix}_{_prom_name(name)}"
        if isinstance(value, dict):
            # merged fleet report: per-source values keep their origin as
            # a label instead of collapsing to one meaningless number
            emit(metric, "gauge",
                 [f'{metric}{{source="{_prom_label(str(src))}"}} {v}'
                  for src, v in sorted(value.items())])
        else:
            emit(metric, "gauge", [f"{metric} {value}"])

    alerts = report.get("alerts", [])
    if alerts:
        # one labeled series per tracked alert: the value is
        # constant 1, the information is the label set — state/severity
        # move as the episode does, and every label value goes through
        # the escape (alert names are declared but sources are not)
        metric = f"{prefix}_alert"
        emit(metric, "gauge", [
            "{metric}{{{labels}}} 1".format(
                metric=metric,
                labels=",".join(
                    f'{key}="{_prom_label(str(sample.get(key, "")))}"'
                    for key in ("name", "source", "state", "severity")))
            for sample in sorted(alerts,
                                 key=lambda s: (str(s.get("name", "")),
                                                str(s.get("source",
                                                          ""))))])

    runtime = report.get("runtime", {})
    for key in ("rss_kb_last", "rss_kb_max", "vm_hwm_kb", "samples"):
        if key in runtime:
            metric = f"{prefix}_runtime_{_prom_name(key)}"
            emit(metric, "gauge", [f"{metric} {runtime[key]}"])
    for key, value in sorted(runtime.get("compile", {}).items()):
        if key == "available":
            continue
        metric = f"{prefix}_compile_{_prom_name(key)}"
        emit(metric, "counter", [f"{metric} {value}"])

    spans = report.get("spans", {})
    if spans:
        metric = f"{prefix}_span_latency_ms"
        lines.append(f"# TYPE {metric} histogram")
        for name, snap in sorted(spans.items()):
            label = _prom_label(name)
            count = snap.get("count", 0)
            for le, cum in snap.get("buckets", {}).items():
                lines.append(
                    f'{metric}_bucket{{span="{label}",le="{le}"}} {cum}')
            if "buckets" not in snap:
                # empty histogram still exposes the +Inf terminal
                lines.append(
                    f'{metric}_bucket{{span="{label}",le="+Inf"}} {count}')
            lines.append(
                f'{metric}_sum{{span="{label}"}} {snap.get("sum_ms", 0.0)}')
            lines.append(f'{metric}_count{{span="{label}"}} {count}')
    return "\n".join(lines) + "\n"


def write_report(report: Dict, path: str) -> Dict[str, str]:
    """Dump any report dict (a hub's or a merged fleet one): JSONL events
    at ``path``, Prometheus text at ``path + ".prom"`` — both written
    atomically (temp file + rename). Returns the paths written."""
    write_jsonl(report_to_events(report), path)
    prom_path = path + ".prom"
    text = prometheus_text(report)
    _atomic_write(prom_path, lambda fh: fh.write(text))
    return {"jsonl": path, "prom": prom_path}


def source_label(meta: Dict, index: int = 0) -> str:
    """Stable per-report origin label for the merged report's gauges:
    worker id when the report carries one, host:pid otherwise, a running
    index as the last resort."""
    if meta.get("worker_id") is not None:
        return f"w{meta['worker_id']}"
    if meta.get("host") and meta.get("pid"):
        return f"{meta['host']}:{meta['pid']}"
    return f"r{index}"


# runtime fields that take the MAX across sources (memory envelopes: the
# fleet's peak is the binding constraint) vs the ones that SUM (activity)
_RUNTIME_MAX = ("rss_kb_last", "rss_kb_max", "vm_hwm_kb")
_RUNTIME_SUM = ("samples",)


def merge_reports(reports: List[Dict]) -> Dict:
    """Merge per-process telemetry reports into ONE fleet report.

    The algebra, per section:

    - **spans** merge bucket-for-bucket via
      :meth:`~avenir_tpu_torch.obs.telemetry.LatencyHistogram.merge` (sound
      because bucket bounds are fixed forever); percentile estimates are
      recomputed from the merged buckets, never averaged.
    - **counters** sum — they are totals of disjoint work.
    - **gauges** keep per-source values under a ``source`` key (a gauge is
      a point-in-time reading; averaging two workers' queue depths would
      manufacture a number nobody observed).
    - **runtime** maxes the RSS envelope fields, sums sample/compile
      activity.
    - **meta** records every source's meta under ``sources`` (host/pid/
      worker_id — the attribution trail) plus the merge arity.

    Empty/None reports are identity elements; the merge of one report is
    that report's data unchanged (modulo recomputed percentiles). The
    merge is CLOSED: an already-merged report feeds back in cleanly
    (its per-source gauge dicts splice instead of nesting, its sources
    flatten into the combined attribution list), so folding pairwise,
    in arrival order, or across runs' JSONL files all agree."""
    reports = [r for r in reports if r]
    merged: Dict = {"spans": {}, "counters": {}, "gauges": {},
                    "runtime": {"compile": {}}}
    hists: Dict[str, _telemetry.LatencyHistogram] = {}
    sources: List[Dict] = []
    alerts: List[Dict] = []
    generated_at = 0.0
    for i, report in enumerate(reports):
        meta = report.get("meta", {})
        if "sources" in meta:          # already-merged input: flatten
            sources.extend(dict(s) for s in meta["sources"])
        else:
            sources.append(dict(meta))
        generated_at = max(generated_at, meta.get("generated_at") or 0.0)
        label = source_label(meta, i)
        for name, snap in report.get("spans", {}).items():
            hist = hists.get(name)
            if hist is None:
                hist = hists[name] = _telemetry.LatencyHistogram()
            hist.merge(snap)
        for name, value in report.get("counters", {}).items():
            merged["counters"][name] = (
                merged["counters"].get(name, 0.0) + value)
        for name, value in report.get("gauges", {}).items():
            slot = merged["gauges"].setdefault(name, {})
            if isinstance(value, dict):
                # already per-source (a merged report): splice the
                # entries under their OWN labels — nesting them under
                # this report's label would corrupt the exposition
                slot.update(value)
            else:
                slot[label] = value
        # alerts concatenate: each sample already carries its source
        # label, so the fleet report's firing set is the union
        alerts.extend(dict(sample)
                      for sample in report.get("alerts", []))
        runtime = report.get("runtime", {})
        for key in _RUNTIME_MAX:
            if key in runtime:
                merged["runtime"][key] = max(
                    merged["runtime"].get(key, 0), runtime[key])
        for key in _RUNTIME_SUM:
            if key in runtime:
                merged["runtime"][key] = (
                    merged["runtime"].get(key, 0) + runtime[key])
        for key, value in runtime.get("compile", {}).items():
            if key == "available":
                merged["runtime"]["compile"]["available"] = (
                    merged["runtime"]["compile"].get("available", False)
                    or bool(value))
            else:
                merged["runtime"]["compile"][key] = round(
                    merged["runtime"]["compile"].get(key, 0) + value, 6)
    merged["spans"] = {name: h.snapshot()
                       for name, h in sorted(hists.items())}
    if alerts:
        merged["alerts"] = sorted(
            alerts, key=lambda s: (str(s.get("name", "")),
                                   str(s.get("source", ""))))
    merged["meta"] = {"format": "avenir-telemetry-v1",
                      "generated_at": generated_at or time.time(),
                      "merged_sources": len(reports),
                      "sources": sources}
    return merged


class TelemetryHub:
    """Process-wide merge point: spans + runtime + counters -> one report.

    Use :func:`hub` for the singleton. ``enable()`` turns the global
    tracer on, baselines the compile tracker, starts the RSS sampler, and
    arms the MetricsRegistry sink; ``disable()`` undoes all of it (the
    collected data survives until ``reset()``)."""

    _instance: Optional["TelemetryHub"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.tracer = _telemetry.tracer()
        self.sampler = _runtime.RuntimeSampler()
        self.compile_tracker = _runtime.CompileTracker()
        self._registries: List = []   # strong refs; cleared by reset()
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._enabled = False
        self._enabled_at: Optional[float] = None
        # extra meta (e.g. worker_id) merged into every report's meta so
        # fleet-merged reports stay attributable; survives reset() — the
        # process's identity does not change between jobs
        self._meta: Dict = {}
        # alerts provider: an AlertManager's flat sample
        # list, folded into every report so the .prom rendering, the
        # JSONL events, and the scrape endpoints all carry the same
        # firing set without any of them knowing about alerting
        self._alerts_provider: Optional[Callable[[], List[Dict]]] = None

    @classmethod
    def get(cls) -> "TelemetryHub":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TelemetryHub()
            return cls._instance

    # -- lifecycle ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, sample_interval_s: float = 0.25) -> "TelemetryHub":
        from avenir_tpu_torch.utils import metrics as _metrics
        self._enabled = True
        self._enabled_at = time.time()
        _telemetry.enable(True)
        self.compile_tracker.start()
        self.sampler.interval_s = sample_interval_s
        self.sampler.start()
        _metrics._OBS_SINK = self._registries.append
        return self

    def disable(self) -> None:
        from avenir_tpu_torch.utils import metrics as _metrics
        if _metrics._OBS_SINK is not None:
            _metrics._OBS_SINK = None
        self.sampler.stop()
        _telemetry.enable(False)
        self._enabled = False

    def reset(self) -> None:
        """Drop collected data (tests; between jobs in one process).

        Safe while enabled: the old sampler thread is stopped before the
        replacement starts, and the MetricsRegistry sink is re-bound to
        the fresh registry list (it captures ``.append`` of a specific
        list object, which this method just replaced)."""
        from avenir_tpu_torch.utils import metrics as _metrics
        self.tracer.reset()
        self._registries = []
        with self._lock:
            self._gauges.clear()
        self.sampler.stop()
        self.sampler = _runtime.RuntimeSampler(
            interval_s=self.sampler.interval_s)
        if self._enabled:
            self.sampler.start()
            _metrics._OBS_SINK = self._registries.append
        self.compile_tracker.start()

    # -- inputs ------------------------------------------------------------
    def attach_registry(self, registry) -> None:
        """Merge a MetricsRegistry into future reports (held until
        ``reset()``)."""
        if registry not in self._registries:
            self._registries.append(registry)

    def registry_mark(self) -> int:
        """Position marker for :meth:`drop_registries_since` — taken
        before work that may be retried."""
        return len(self._registries)

    def drop_registries_since(self, mark: int) -> None:
        """Forget registries attached after ``mark``. The CLI calls this
        before re-running a failed attempt: counters() SUMS registries,
        so a dead attempt's partial counters would otherwise double into
        the retried attempt's report."""
        del self._registries[mark:]

    @staticmethod
    def _gauge_value(value):
        """A gauge is a float — or a per-source dict of floats (the
        coordinator's per-shard ``broker.*`` gauges), which
        the exporters already render under a Prometheus ``source``
        label and the fleet merge splices per origin."""
        if isinstance(value, dict):
            return {str(k): float(v) for k, v in value.items()}
        return float(value)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = self._gauge_value(value)

    def set_gauges(self, values: Dict[str, float]) -> None:
        """Publish several gauges under one lock acquisition (the serving
        engine's per-run gauge sweep: overlap fraction, queue depth,
        reward backlog)."""
        with self._lock:
            for name, value in values.items():
                self._gauges[name] = self._gauge_value(value)

    def set_alerts_provider(
            self, provider: Optional[Callable[[], List[Dict]]]) -> None:
        """Attach (or clear with None) the callable whose samples land
        in ``report()["alerts"]`` — ``AlertManager.alert_samples``."""
        self._alerts_provider = provider

    def clear_alerts_provider(self, provider) -> None:
        """Detach ``provider`` iff it is still the installed one — a
        stopped bundle must not evict a newer bundle's manager."""
        if self._alerts_provider is provider:
            self._alerts_provider = None

    def set_meta(self, **kw) -> None:
        """Attach identity fields (``worker_id=3``) to every future
        report's meta — the attribution the fleet merge keys its
        per-source gauges on."""
        with self._lock:
            self._meta.update(kw)

    # -- outputs -----------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        merged: Dict[str, float] = {}
        for registry in list(self._registries):
            for key, value in registry.as_dict().items():
                merged[key] = merged.get(key, 0.0) + value
        return merged

    def report(self) -> Dict:
        runtime = self.sampler.snapshot()
        runtime["compile"] = self.compile_tracker.snapshot()
        now = time.time()
        with self._lock:
            gauges = dict(self._gauges)
            extra_meta = dict(self._meta)
        alerts: Optional[List[Dict]] = None
        provider = self._alerts_provider
        if provider is not None:
            try:
                alerts = list(provider() or [])
            except Exception:
                alerts = None
        out = {
            "meta": {"generated_at": now,
                     "enabled_at": self._enabled_at,
                     # how long telemetry has been collecting — the
                     # denominator a rate dashboard divides counters by
                     "duration_s": (round(now - self._enabled_at, 6)
                                    if self._enabled_at else None),
                     "host": socket.gethostname(),
                     "pid": os.getpid(),
                     "format": "avenir-telemetry-v1",
                     **extra_meta},
            "spans": self.tracer.snapshot(),
            "counters": self.counters(),
            "gauges": gauges,
            "runtime": runtime,
        }
        if alerts is not None:
            out["alerts"] = alerts
        return out

    def write(self, path: str) -> Dict[str, str]:
        """Dump the merged report: JSONL events at ``path``, Prometheus
        text at ``path + ".prom"``, both atomically (temp + rename).
        Returns the paths written."""
        return write_report(self.report(), path)


def hub() -> TelemetryHub:
    return TelemetryHub.get()


def set_hub_gauges_if_live(values: Dict[str, float]) -> None:
    """Publish gauges iff the singleton hub exists AND is enabled; never
    raises. The shared discipline of every instrumented hot path (the
    serving engines, lifecycle swap/retrain/drift): telemetry must never
    sink serving — a disabled or absent hub costs one attribute read."""
    try:
        h = TelemetryHub._instance
        if h is not None and h.enabled:
            h.set_gauges(values)
    except Exception:
        pass
