"""Telemetry: spans and histograms, runtime collectors, exporters.

Counterpart of the core of ``avenir_tpu/obs``:

- :mod:`avenir_tpu_torch.obs.telemetry`: the ``span()`` tracer and the
  fixed-bucket latency histograms with p50/p95/p99, off by default and
  free when off;
- :mod:`avenir_tpu_torch.obs.runtime`: the kernel-build counters, /proc
  RSS sampling and the card's memory;
- :mod:`avenir_tpu_torch.obs.exporters`: the JSONL events and the
  Prometheus text, merged by the :class:`TelemetryHub` singleton with the
  ``MetricsRegistry`` counters;
- :mod:`avenir_tpu_torch.obs.tracing`: sampled cross-process event traces;
- the live half: :mod:`avenir_tpu_torch.obs.timeseries` (the windowed
  rates ring, the :class:`MetricsPump`, the :class:`FlightRecorder`),
  :mod:`avenir_tpu_torch.obs.signals` (SLO burn rates, the saturation
  forecast), :mod:`avenir_tpu_torch.obs.alerts` (the
  :class:`AlertManager`) and :mod:`avenir_tpu_torch.obs.live` (the scrape
  endpoints and :func:`~avenir_tpu_torch.obs.live.start_live_obs`).

One switch: ``obs.hub().enable()`` (the CLI's ``--metrics-out``); the
live half arms a process that asks (``--obs-port``, ``obs.http.port``,
``obs.live``, ``obs.flight.path``, ``alerts.enable``).
"""

from avenir_tpu_torch.obs.exporters import (TelemetryHub, hub,
                                            merge_reports,
                                            parse_prometheus_text,
                                            prometheus_text, read_jsonl,
                                            report_to_events,
                                            events_to_report,
                                            set_hub_gauges_if_live,
                                            source_label, write_jsonl,
                                            write_report)
from avenir_tpu_torch.obs.runtime import (CompileTracker, RuntimeSampler,
                                          device_memory_stats,
                                          read_proc_status, record_compile)
from avenir_tpu_torch.obs.telemetry import (BUCKET_BOUNDS_MS,
                                            LatencyHistogram, Tracer,
                                            enable, percentiles,
                                            percentiles_weighted,
                                            snapshot_slot_counts, span,
                                            tracer)
from avenir_tpu_torch.obs.timeseries import (FlightRecorder, MetricsPump,
                                             MetricsRing, counter_delta,
                                             flight_dump_if_armed)
from avenir_tpu_torch.obs.signals import (DEFAULT_SLOS,
                                          SaturationForecaster,
                                          SignalEvaluator, SloSpec,
                                          burn_rate, window_badness)
from avenir_tpu_torch.obs.alerts import Alert, AlertManager

__all__ = [
    "Alert", "AlertManager", "BUCKET_BOUNDS_MS", "CompileTracker",
    "DEFAULT_SLOS", "FlightRecorder", "LatencyHistogram", "MetricsPump",
    "MetricsRing", "RuntimeSampler", "SaturationForecaster",
    "SignalEvaluator", "SloSpec", "TelemetryHub", "Tracer", "burn_rate",
    "counter_delta", "device_memory_stats", "enable", "events_to_report",
    "flight_dump_if_armed", "hub", "merge_reports",
    "parse_prometheus_text", "percentiles", "percentiles_weighted",
    "prometheus_text", "read_jsonl", "read_proc_status", "record_compile",
    "report_to_events", "set_hub_gauges_if_live", "snapshot_slot_counts",
    "source_label", "span", "tracer", "window_badness", "write_jsonl",
    "write_report",
]
