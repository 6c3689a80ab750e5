"""The port's live observability layer (``avenir_tpu_torch.obs``:
``timeseries``, ``signals``, ``alerts``, ``live``, and the CLI's arming)
against the JAX package's on the CPU: the same sequence of hub reports
through both, compared exactly (timestamps, hosts and pids aside)."""

import json
import os
import signal
import urllib.request

import numpy as np
import pytest
import torch

from avenir_tpu.obs import alerts as JA
from avenir_tpu.obs import signals as JS
from avenir_tpu.obs import timeseries as JT

from avenir_tpu_torch.obs import alerts as TA
from avenir_tpu_torch.obs import exporters as TE
from avenir_tpu_torch.obs import live as TLV
from avenir_tpu_torch.obs import signals as TS
from avenir_tpu_torch.obs import telemetry as TT
from avenir_tpu_torch.obs import timeseries as TTS

torch.set_num_threads(2)

_VOLATILE = ("t", "ts", "now", "host", "pid")


@pytest.fixture(autouse=True)
def _restore_sigusr2():
    """Every test leaves SIGUSR2's handler as it found it."""
    before = signal.getsignal(signal.SIGUSR2)
    yield
    assert signal.getsignal(signal.SIGUSR2) is before
    signal.signal(signal.SIGUSR2, before)


def _reports(seed, n=40):
    """A seeded run of hub reports: decision latencies that climb past the
    500 ms SLO and come back, reward folds, swaps, a queue that fills
    toward its high-water mark, shed events, counters, and one restart
    (the cumulative series fall back)."""
    rng = np.random.default_rng(seed)
    dec, rew, swap = (TT.LatencyHistogram() for _ in range(3))
    shed, depth, count = 0.0, 0.0, 0.0
    out = []
    for i in range(n):
        if i == 25:                                   # a restart
            dec, rew = TT.LatencyHistogram(), TT.LatencyHistogram()
            count = 0.0
        slow = 10 <= i < 18
        for v in rng.lognormal(np.log(900.0 if slow else 20.0), 0.6,
                               int(rng.integers(20, 80))):
            dec.record(float(v))
        for v in rng.lognormal(np.log(2.0), 0.3, int(rng.integers(5, 30))):
            rew.record(float(v))
        if i % 7 == 3:
            swap.record(float(rng.choice([30.0, 400.0])))
        depth = max(0.0, depth + float(rng.integers(-40, 120)))
        if depth > 900:
            shed += depth - 900
            depth = 900.0
        count += float(rng.integers(50, 100))
        out.append({"spans": {"engine.decision_latency": dec.snapshot(),
                              "engine.reward_fold": rew.snapshot(),
                              "lifecycle.swap": swap.snapshot()},
                    "counters": {"engine.events": count},
                    "gauges": {"engine.queue_depth": depth,
                               "engine.shed_total": shed,
                               "fleet.depth": {"w0": depth, "w1": 1.0}}})
    return out


def _clocks(n):
    # a missed pump tick (a wider window) at 30
    mono = np.cumsum([0.0] + [0.25] * 29 + [0.75] + [0.25] * (n - 31))
    return [(float(m), 1_000_000.0 + float(m)) for m in mono]


def _drive(mod_ts, mod_sig, mod_alerts, reports, tmp_path, tag):
    ring = mod_ts.MetricsRing(max_windows=32)
    manager = mod_alerts.AlertManager(path=str(tmp_path / f"{tag}.alerts"),
                                      pending_windows=1, resolve_windows=2)
    evaluator = mod_sig.SignalEvaluator(manager=manager, source="engine",
                                        high_water=900, horizon_s=5.0)
    transitions, snapshots = [], []
    for report, (mono, wall) in zip(reports, _clocks(len(reports))):
        window = ring.observe(report, now_mono=mono, now_wall=wall)
        if window is not None:
            snapshots.append(evaluator.on_window(window))
            transitions.append(manager.snapshot()["counts"])
    manager.flush()
    return ring, evaluator, manager, transitions, snapshots


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.mark.parametrize("seed", [1, 2])
def test_ring_windows_equal_jax(tmp_path, seed):
    reports = _reports(seed)
    jring = _drive(JT, JS, JA, reports, tmp_path, "j")[0]
    tring = _drive(TTS, TS, TA, reports, tmp_path, "t")[0]
    assert tring.windows() == jring.windows()
    assert tring.windows_total == jring.windows_total == len(reports) - 1
    assert _strip(tring.rates_snapshot(last=8)) == \
        _strip(jring.rates_snapshot(last=8))
    assert any(w["rates"]["shed_per_s"] > 0 for w in tring.windows())


@pytest.mark.parametrize("seed", [1, 2])
def test_burn_rates_forecasts_and_alerts_equal_jax(tmp_path, seed):
    reports = _reports(seed)
    j = _drive(JT, JS, JA, reports, tmp_path, "j")
    t = _drive(TTS, TS, TA, reports, tmp_path, "t")
    assert t[4] == j[4]                       # every verdict and forecast
    assert t[3] == j[3]                       # the counts after each window
    assert t[1].worst_burn() == j[1].worst_burn()
    assert _strip(t[2].snapshot()) == _strip(j[2].snapshot())
    assert t[2].alert_samples() == j[2].alert_samples()
    j_log = [json.loads(line) for line in
             (tmp_path / "j.alerts").read_text().splitlines()]
    t_log = [json.loads(line) for line in
             (tmp_path / "t.alerts").read_text().splitlines()]
    assert _strip(t_log) == _strip(j_log)
    states = {e.get("transition") for e in t_log}
    assert {"firing", "resolved"} <= states


def test_flight_dump_equals_jax_apart_from_timestamps(tmp_path):
    reports = _reports(3)
    dumps = {}
    for tag, mod in (("j", JT), ("t", TTS)):
        ring = mod.MetricsRing(max_windows=16)
        recorder = mod.FlightRecorder(ring, str(tmp_path / f"{tag}.flight"),
                                      slo_p99_ms=500.0)
        for report, (mono, wall) in zip(reports, _clocks(len(reports))):
            window = ring.observe(report, now_mono=mono, now_wall=wall)
            if window is not None:
                recorder.check(window)
        assert recorder.dumps == 1           # one breach episode latched
        assert recorder.dump("crash:engine:ValueError")
        assert recorder.backstop_reason("atexit") == \
            "crash:engine:ValueError"
        dumps[tag] = [json.loads(line) for line in
                      (tmp_path / f"{tag}.flight").read_text().splitlines()]
    assert _strip(dumps["t"]) == _strip(dumps["j"])
    assert dumps["t"][0]["reason"] == "crash:engine:ValueError"
    assert len(dumps["t"]) == 17


def test_scrape_endpoints(tmp_path):
    """``/metrics`` parses as Prometheus text (by both packages' parsers
    alike), ``/metrics/rates``, ``/healthz`` and ``/alerts`` answer JSON,
    an unknown path 404s; the server binds localhost on port 0."""
    from avenir_tpu.obs import exporters as JE
    hub = TE.hub()
    was = hub.enabled
    hub.enable()
    try:
        TT.tracer().record("engine.decision_latency", 3.0, 5)
        hub.set_gauge("ann.tail_fill", 0.25)
        ring = TTS.MetricsRing()
        for report, (mono, wall) in zip(_reports(4, 4), _clocks(4)):
            ring.observe(report, now_mono=mono, now_wall=wall)
        manager = TA.AlertManager()
        server = TLV.ObsHttpServer(ring=ring, port=0,
                                   health_provider=lambda: {"v": 3},
                                   alerts_provider=manager.snapshot)
        server.start()
        try:
            assert server.port > 0
            base = f"http://localhost:{server.port}"

            def get(path):
                with urllib.request.urlopen(base + path, timeout=10) as r:
                    return r.read().decode()
            text = get("/metrics")
            samples = TE.parse_prometheus_text(text)
            assert samples == JE.parse_prometheus_text(text)
            names = {name for name, _, _ in samples}
            assert any(n.startswith("avenir_span") for n in names)
            assert any("ann" in n and "tail_fill" in n for n in names)
            rates = json.loads(get("/metrics/rates"))
            assert rates["n"] == 3 and rates["format"] == \
                "avenir-timeseries-v1"
            health = json.loads(get("/healthz"))
            assert health["ok"] and health["v"] == 3
            assert health["telemetry_enabled"]
            assert json.loads(get("/alerts"))["format"] == \
                "avenir-alerts-v1"
            with pytest.raises(urllib.error.HTTPError):
                get("/nope")
        finally:
            server.stop()
    finally:
        hub.reset()
        if not was:
            hub.disable()


def test_bundle_arms_and_stop_disarms(tmp_path):
    """``start_live_obs`` with a flight path and alerting: the recorder
    armed (the crash hook dumps), SIGUSR2 handled, ``current()`` set;
    ``stop()`` restores the handler and disarms everything."""
    before = signal.getsignal(signal.SIGUSR2)
    live = TLV.start_live_obs(port=0, interval_s=0.05,
                              flight_path=str(tmp_path / "f.jsonl"),
                              alerts=True,
                              alerts_path=str(tmp_path / "a.jsonl"))
    try:
        assert TLV.current() is live and live.port > 0
        assert TTS.armed_flight_recorder() is live.recorder
        assert signal.getsignal(signal.SIGUSR2) is not before
        with pytest.raises(RuntimeError):
            TTS.run_with_flight_dump("loop", _raise)
        meta = json.loads((tmp_path / "f.jsonl").read_text()
                          .splitlines()[0])
        assert meta["reason"] == "crash:loop:RuntimeError"
    finally:
        live.stop()
    assert signal.getsignal(signal.SIGUSR2) is before
    assert TTS.armed_flight_recorder() is None
    assert TLV.current() is None and not TE.hub().enabled
    assert (tmp_path / "a.jsonl").exists()


def _raise(*args, **kwargs):
    raise RuntimeError("boom")


def test_engine_and_loop_runs_leave_a_flight_record(tmp_path):
    """``ServingEngine.run`` and ``OnlineLearnerLoop.run`` go through the
    recorder's crash hook, as the JAX package's do."""
    from avenir_tpu_torch.stream.engine import ServingEngine
    from avenir_tpu_torch.stream.loop import InProcQueues, OnlineLearnerLoop
    ring = TTS.MetricsRing()
    recorder = TTS.FlightRecorder(ring, str(tmp_path / "f.jsonl"))
    TTS.arm_flight_recorder(recorder)
    try:
        for kind, cls in (("engine", ServingEngine),
                          ("loop", OnlineLearnerLoop)):
            queues = InProcQueues()
            queues.push_event("e0")
            runner = cls("softMax", ["a", "b"], {}, queues, device="cpu")
            runner.learner.next_action_batch_async = _raise
            runner.learner.next_action_batch = _raise
            with pytest.raises(RuntimeError):
                runner.run()
            assert recorder.last_reason == f"crash:{kind}:RuntimeError"
    finally:
        TTS.arm_flight_recorder(None)


def test_the_pump_reads_host_numbers_only(monkeypatch):
    """Every gauge the pump samples is a host number: with every
    tensor-to-host read raising, a sample still closes its window, and an
    engine over the live ANN learner publishes its gauges."""
    from avenir_tpu_torch.models.live_ann import LiveAnnIndex
    from avenir_tpu_torch.stream.engine import (AnnServingLearner,
                                                ServingEngine)
    from avenir_tpu_torch.stream.loop import InProcQueues
    rng = np.random.default_rng(6)
    live_obs = TLV.start_live_obs(interval_s=60.0)
    try:
        TT.tracer().enabled = True
        index = LiveAnnIndex(rng.random((300, 4), dtype=np.float32),
                             nlist=4, n_iters=2, device="cpu")
        index.append(rng.random((20, 4), dtype=np.float32))
        queues = InProcQueues()
        for i in range(16):
            queues.push_event(f"e{i}")
        learner = AnnServingLearner(index, rng.random((32, 4),
                                                      dtype=np.float32))
        ServingEngine("", learner.actions, {}, queues, learner=learner,
                      min_batch=8, max_batch=8, device="cpu").run()
        report = TE.hub().report()
        for name, value in report["gauges"].items():
            assert isinstance(value, (int, float, dict)), name
        assert {"ann.tail_fill", "engine.overlap_fraction"} <= \
            set(report["gauges"])

        def host_read(*args, **kwargs):
            raise AssertionError("a host read in the pump")
        for name in ("item", "tolist", "numpy", "cpu", "__float__",
                     "__int__", "__bool__", "__index__"):
            monkeypatch.setattr(torch.Tensor, name, host_read)
        window = live_obs.pump.sample_once()
        monkeypatch.undo()
        assert window is not None
        assert window["rates"]["decisions_per_s"] > 0
    finally:
        live_obs.stop()


# -- the CLI's arming ----------------------------------------------------------

def _knn_job(tmp_path):
    from _torch_parity import write_fixture
    write_fixture(tmp_path, "elearn", 400, 100, seed=23)
    props = tmp_path / "p.properties"
    props.write_text(
        f"field.delim.regex=,\nfeature.schema.file.path="
        f"{tmp_path / 'schema.json'}\ntrain.data.path="
        f"{tmp_path / 'train.csv'}\nvalidation.mode=true\n"
        "positive.class.value=fail\n")
    return ["NearestNeighbor", str(tmp_path / "test.csv")], str(props)


def test_an_armed_job_prints_its_port_and_the_unarmed_output(tmp_path,
                                                             capsys):
    """``--obs-port 0`` with ``alerts.enable``: the bound port first, then
    the unarmed job's lines; the same file; the report, the alerts log
    and the .prom file written; everything disarmed after."""
    from avenir_tpu_torch.cli.main import main as tmain
    args, props = _knn_job(tmp_path)
    tmain(args + [str(tmp_path / "plain.txt"), "--conf", props, "--device",
                  "cpu"])
    want = capsys.readouterr().out
    m = str(tmp_path / "m.jsonl")
    tmain(args + [str(tmp_path / "armed.txt"), "--conf", props, "--obs-port",
                  "0", "-D", "alerts.enable=true", "--metrics-out", m,
                  "--device", "cpu"])
    first, rest = capsys.readouterr().out.split("\n", 1)
    assert json.loads(first)["obs_port"] > 0
    assert rest == want
    assert (tmp_path / "armed.txt").read_bytes() == \
        (tmp_path / "plain.txt").read_bytes()
    for suffix in ("", ".prom", ".alerts.jsonl"):
        assert os.path.exists(m + suffix), suffix
    assert not (tmp_path / "m.jsonl.flight.jsonl").exists()
    assert TLV.current() is None and not TE.hub().enabled


def test_a_failing_job_leaves_its_flight_record(tmp_path):
    from avenir_tpu_torch.cli.main import main as tmain
    args, props = _knn_job(tmp_path)
    m = str(tmp_path / "m.jsonl")
    with pytest.raises(FileNotFoundError):
        tmain(args + [str(tmp_path / "o.txt"), "--conf", props, "-D",
                      f"train.data.path={tmp_path / 'missing.csv'}", "-D",
                      "obs.live=true", "--metrics-out", m, "--device",
                      "cpu"])
    meta = json.loads((tmp_path / "m.jsonl.flight.jsonl").read_text()
                      .splitlines()[0])
    assert meta["type"] == "flight-meta" and meta["reason"] == "crash:cli"
    assert TLV.current() is None
