"""The port's telemetry core (``avenir_tpu_torch/obs``) against the JAX
package's: histograms, percentiles, the exporters and the merge, the
StepTimer, and ``--metrics-out`` on a chained job."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from avenir_tpu import plan as jplan
from avenir_tpu.cli.main import main as jmain
from avenir_tpu.obs import exporters as jex
from avenir_tpu.obs import telemetry as jtel
from avenir_tpu.utils import profiling as jprof

from avenir_tpu_torch import plan as tplan
from avenir_tpu_torch.cli import main as tcli
from avenir_tpu_torch.obs import exporters as tex
from avenir_tpu_torch.obs import runtime as trt
from avenir_tpu_torch.obs import telemetry as ttel
from avenir_tpu_torch.utils import profiling as tprof
from avenir_tpu_torch.utils.metrics import MetricsRegistry

from _torch_parity import write_fixture

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    tplan.reset_cache()
    jplan.reset_cache()
    tex.hub().reset()
    jex.hub().reset()
    yield
    tex.hub().disable()
    jex.hub().disable()


def _latencies(seed, n=3000):
    rng = np.random.default_rng(seed)
    return (10 ** rng.uniform(-3.5, 4.5, n)).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_record_and_merge_as_jax(seed):
    values = _latencies(seed)
    hists = []
    for mod in (jtel, ttel):
        a, b = mod.LatencyHistogram(), mod.LatencyHistogram()
        for i, v in enumerate(values):
            (a if i % 3 else b).record(v, n=1 + i % 2)
        a.merge(b.snapshot())
        a.merge(mod.LatencyHistogram().snapshot())     # identity
        hists.append(a)
    j, t = hists
    assert t.snapshot() == j.snapshot()
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert t.percentile_ms(q) == j.percentile_ms(q)
    assert ttel.snapshot_slot_counts(t.snapshot()) == \
        jtel.snapshot_slot_counts(j.snapshot())
    assert ttel.BUCKET_BOUNDS_MS == jtel.BUCKET_BOUNDS_MS


@pytest.mark.parametrize("seed", [3, 4])
def test_percentiles_equal_jax(seed):
    values = _latencies(seed, 500)
    assert ttel.percentiles(values, (1, 50, 95, 99)) == \
        jtel.percentiles(values, (1, 50, 95, 99))
    assert ttel.percentiles([]) == jtel.percentiles([])
    rng = np.random.default_rng(seed)
    pairs = [(v, int(rng.integers(0, 5))) for v in values[:80]]
    assert ttel.percentiles_weighted(pairs) == \
        jtel.percentiles_weighted(pairs)


def test_step_timer_summary_equals_jax():
    jt, tt = jprof.StepTimer("v"), tprof.StepTimer("v")
    assert tt.summary() == jt.summary()
    times = _latencies(5, 37)
    jt.times_ms, tt.times_ms = list(times), list(times)
    assert tt.summary() == jt.summary()
    assert tprof.StepTimer.block_on([torch.ones(2), {"a": None}])[0].sum() \
        == 2


def test_disabled_tracer_is_free():
    tracer = ttel.Tracer()
    assert tracer.span("x") is tracer.span("y")
    with tracer.span("x"):
        pass
    assert tracer.snapshot() == {}
    tracer.enabled = True
    with tracer.span("outer"):
        with tracer.span("inner"):
            pass
    assert set(tracer.snapshot()) == {"outer", "outer/inner"}


def _report(mod_tel, mod_ex):
    tracer = mod_tel.Tracer(enabled=True)
    for i, v in enumerate(_latencies(7, 200)):
        tracer.record(['a"b\\c', "plan.x/y\nz", "job.v"][i % 3], v)
    return {"meta": {"host": "h", "pid": 1, "format": "avenir-telemetry-v1"},
            "spans": tracer.snapshot(),
            "counters": {"Validation.Total": 12.0, "odd name-1": 3.5},
            "gauges": {"plan.cache.hits": 1.0,
                       "broker.depth": {'s"1': 2.0, "s\n2": 3.0}},
            "runtime": {"rss_kb_last": 10, "rss_kb_max": 20, "samples": 3,
                        "compile": {"x_count": 1, "available": True}}}


def test_prometheus_text_round_trips_and_equals_jax():
    report = _report(ttel, tex)
    text = tex.prometheus_text(report)
    assert text == jex.prometheus_text(_report(jtel, jex))
    parsed = tex.parse_prometheus_text(text)
    assert parsed == jex.parse_prometheus_text(text)
    spans = {labels["span"] for name, labels, _ in parsed
             if name == "avenir_span_latency_ms_count"}
    assert spans == set(report["spans"])
    sources = {labels["source"] for name, labels, _ in parsed
               if name == "avenir_broker_depth"}
    assert sources == {'s"1', "s\n2"}
    counts = {labels["span"]: v for name, labels, v in parsed
              if name == "avenir_span_latency_ms_count"}
    assert counts == {k: s["count"] for k, s in report["spans"].items()}


def test_jsonl_events_and_merge_equal_jax(tmp_path):
    reports = [_report(ttel, tex), _report(ttel, tex)]
    reports[1]["meta"] = {"worker_id": 3}
    tex.write_report(reports[0], str(tmp_path / "r.jsonl"))
    back = tex.events_to_report(tex.read_jsonl(str(tmp_path / "r.jsonl")))
    assert back["spans"] == reports[0]["spans"]
    assert back["counters"] == reports[0]["counters"]
    got = tex.merge_reports(reports)
    want = jex.merge_reports(reports)
    for key in ("spans", "counters", "gauges", "runtime"):
        assert got[key] == want[key], key
    assert got["meta"]["sources"] == want["meta"]["sources"]


def test_compile_tracker_counts_the_port_builds():
    tracker = trt.CompileTracker()
    tracker.start()
    trt.record_compile("nvcc_build", 1.5)
    trt.record_compile("library_load", 0.25)
    snap = tracker.snapshot()
    assert snap["nvcc_build_count"] == 1 and snap["nvcc_build_secs"] == 1.5
    assert snap["library_load_count"] == 1
    assert snap["native_build_count"] == 0 and snap["available"]
    with pytest.raises(ValueError, match="unknown compile kind"):
        trt.record_compile("jit", 1.0)
    trt.set_device(torch.device("cpu"))
    assert trt.device_memory_stats() is None
    assert "rss_kb" in trt.read_proc_status()


def test_registry_sink_only_while_enabled():
    hub = tex.hub()
    MetricsRegistry().incr("a", "b")
    assert hub.counters() == {}
    hub.enable()
    MetricsRegistry().incr("a", "b", 2)
    MetricsRegistry().incr("a", "b", 3)
    hub.disable()
    MetricsRegistry().incr("a", "b", 7)
    assert hub.counters() == {"a.b": 5.0}
    tex.set_hub_gauges_if_live({"x": 1.0})       # disabled: dropped
    assert "x" not in hub.report()["gauges"]


def _chain(main, extra, tmp_path, tag, props):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["BayesianDistribution", str(tmp_path / "train.csv"),
              str(tmp_path / f"{tag}_nb.txt"), "--conf", props,
              "--metrics-out", str(tmp_path / f"{tag}_nb.jsonl"), *extra])
        main(["NearestNeighbor", str(tmp_path / "test.csv"),
              str(tmp_path / f"{tag}_knn.txt"), "--conf", props,
              "--metrics-out", str(tmp_path / f"{tag}_knn.jsonl"), *extra])
    return out.getvalue()


def _names(path):
    """(metric, span label) pairs of a .prom file, the compile family
    left out (the JAX package counts XLA compiles, the port its kernel
    builds)."""
    return {(name, labels.get("span"))
            for name, labels, _ in jex.parse_prometheus_text(
                open(path).read())
            if "_compile_" not in name}


@pytest.mark.parametrize("keys", [
    {}, {"ingest.workers": "3", "ingest.split.bytes": "20000",
         "feed.chunk.rows": "64"}], ids=["serial", "parallel-fed"])
def test_chained_job_reports_the_jax_cli_names(tmp_path, keys):
    """NB then KNN with --metrics-out: the .prom of the KNN job names the
    spans, counters and gauges the JAX CLI's names, and the job files are
    the JAX CLI's default run's."""
    write_fixture(tmp_path, "churn", 1500, 300, seed=5)
    props = str(tmp_path / "c.properties")
    with open(props, "w") as fh:
        fh.write("".join(f"{k}={v}\n" for k, v in {
            "field.delim.regex": ",", "field.delim": ",",
            "feature.schema.file.path": tmp_path / "schema.json",
            "train.data.path": tmp_path / "train.csv",
            "validation.mode": "true", "positive.class.value": "closed",
            "knn.mode": "exact", **keys}.items()))
    j_out = _chain(jmain, [], tmp_path, "j", props)
    t_out = _chain(tcli.main, ["--device", "cpu"], tmp_path, "t", props)
    assert t_out == j_out
    for name in ("nb", "knn"):
        assert (tmp_path / f"t_{name}.txt").read_bytes() == \
            (tmp_path / f"j_{name}.txt").read_bytes()
    got = _names(tmp_path / "t_knn.jsonl.prom")
    assert got == _names(tmp_path / "j_knn.jsonl.prom")
    assert ("avenir_plan_cache_hits", None) in got
    assert ("avenir_span_latency_ms_count", "job.NearestNeighbor") in got
    if keys:
        assert ("avenir_feed_overlap_fraction", None) in got
        assert ("avenir_ingest_overlap_fraction", None) in got


def test_failed_attempt_registries_are_dropped_on_retry(tmp_path,
                                                        monkeypatch):
    """A transient failure re-runs the verb (max.attempts); the report
    holds the counters of the attempt that finished, not the failed
    one's too."""
    attempts = []

    def flaky(conf, in_path, out_path, device):
        MetricsRegistry().incr("Job", "Rows", 10)
        attempts.append(device)
        if len(attempts) == 1:
            raise RuntimeError("transient")
        with open(out_path, "w") as fh:
            fh.write("done\n")

    monkeypatch.setitem(tcli.VERBS, "WordCounter", flaky)
    props = tmp_path / "p.properties"
    props.write_text("max.attempts=2\n")
    report = str(tmp_path / "m.jsonl")
    tcli.main(["WordCounter", "in.txt", str(tmp_path / "o.txt"), "--conf",
               str(props), "--metrics-out", report, "--device", "cpu"])
    assert len(attempts) == 2
    counters = {e["name"]: e["value"] for e in tex.read_jsonl(report)
                if e["type"] == "counter"}
    assert counters == {"Job.Rows": 10.0}
    gauges = {e["name"]: e["value"] for e in tex.read_jsonl(report)
              if e["type"] == "gauge"}
    assert gauges["job.WordCounter.steps"] == 1
    assert not tex.hub().enabled


@pytest.mark.parametrize("kernel_event,launched,warns", [
    (False, 3, True), (True, 3, False), (False, 0, False)],
    ids=["kernels-missing", "kernels-present", "nothing-launched"])
def test_trace_without_kernel_events_fails_loudly(tmp_path, kernel_event,
                                                  launched, warns):
    """A Chrome trace that covers the port's kernel launches but names no
    kernel event gets a warning that says so, instead of passing silently
    for a trace of the card."""
    events = [{"name": "aten::mm", "cat": "cpu_op", "ph": "X"}]
    if kernel_event:
        events.append({"name": "cfb_counts_kernel", "cat": "kernel",
                       "ph": "X"})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    warning = tprof.check_kernel_events(str(path), launched)
    if warns:
        assert "no kernel event" in warning and str(path) in warning
        assert f"launched {launched} times" in warning
    else:
        assert warning is None


def test_kernel_launches_sums_the_wrappers_counts():
    """The count trace() compares reads every kernel wrapper's own."""
    from avenir_tpu_torch.ops import cuda_histogram
    before = tprof.kernel_launches()
    cuda_histogram.pair_counts.launches += 2
    try:
        assert tprof.kernel_launches() == before + 2
    finally:
        cuda_histogram.pair_counts.launches -= 2


def test_profile_trace_on_the_cpu_writes_chrome_json(tmp_path):
    """On the CPU the trace holds the host's operators and warns of
    nothing: no card kernel was asked for."""
    with tprof.trace(str(tmp_path)):
        torch.ones(64).sum()
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
