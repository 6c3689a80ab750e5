"""Telemetry: spans and histograms, runtime collectors, exporters.

Counterpart of the core of ``avenir_tpu/obs``:

- :mod:`avenir_tpu_torch.obs.telemetry`: the ``span()`` tracer and the
  fixed-bucket latency histograms with p50/p95/p99, off by default and
  free when off;
- :mod:`avenir_tpu_torch.obs.runtime`: the kernel-build counters, /proc
  RSS sampling and the card's memory;
- :mod:`avenir_tpu_torch.obs.exporters`: the JSONL events and the
  Prometheus text, merged by the :class:`TelemetryHub` singleton with the
  ``MetricsRegistry`` counters.

One switch: ``obs.hub().enable()`` (the CLI's ``--metrics-out``). The
live half (the rates ring, the scrape endpoints, alerting and
cross-process tracing) is not ported yet.
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

__all__ = [
    "BUCKET_BOUNDS_MS", "CompileTracker", "LatencyHistogram",
    "RuntimeSampler", "TelemetryHub", "Tracer", "device_memory_stats",
    "enable", "events_to_report", "hub", "merge_reports", "parse_prometheus_text", "percentiles",
    "percentiles_weighted", "prometheus_text", "read_jsonl",
    "read_proc_status", "record_compile", "report_to_events",
    "set_hub_gauges_if_live", "snapshot_slot_counts",
    "source_label", "span", "tracer", "write_jsonl", "write_report",
]
