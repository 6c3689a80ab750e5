"""The port's scale-out tier across processes on the CPU: worker
subprocesses (``python -m avenir_tpu_torch.stream.scaleout --worker
--device cpu``) over a MiniRedis broker, held to the contracts the JAX
package's tests hold its own workers to: every event answered exactly
once, ownership disjoint and total, heartbeats and the start time of
every worker, shuffle grouping, SIGKILL mid-stream with nothing lost
(step loop and engine), a registry head every worker swaps in with the
fleet report attributing its version, and sampled trace stamps; a
worker's scrape endpoint (``--obs-port``, ``--obs-flight``,
``--obs-slo-ms``) answering ``/healthz`` as the JAX worker's does.
Without a GPU the default device raises, and the elastic half's flags
are refused by the ROADMAP title that ports them."""

import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from avenir_tpu_torch.obs import tracing as TR
from avenir_tpu_torch.stream import scaleout as TS
from avenir_tpu_torch.stream.miniredis import MiniRedisClient, MiniRedisServer
from avenir_tpu_torch.stream.scaleout import (
    main, run_chaos, run_scaleout, worker_main)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    # each spawned worker inherits the environment: two intra-op threads,
    # as six test processes share the host
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _lean_with_retries(run_once, attempts: int = 3) -> None:
    """The planted-arm lean is a real property of softMax over 0.8-vs-0.15
    CTRs but not a deterministic one: reward arrival order across workers
    is a race. The strict per-run contracts hold inside ``run_once`` on
    every attempt; only the lean retries on a shifted seed."""
    fractions = []
    for attempt in range(attempts):
        fractions.append(run_once(attempt))
        if fractions[-1] > 0.4:
            return
    raise AssertionError(
        f"no run leaned onto the planted arms in {attempts} attempts: "
        f"{fractions}")


def _ownership(r, n_groups):
    owned = [set(w["groups"]) for w in r.worker_stats]
    assert sum(len(g) for g in owned) == n_groups     # disjoint ...
    assert set().union(*owned) == {f"g{i}" for i in range(n_groups)}  # total


def test_two_workers_answer_everything():
    """Two workers, four groups over one broker subprocess: every event
    answered once, ownership disjoint and total, heartbeats from both
    (start, cadence, final), each worker's start time, no straggler
    between balanced workers, and the learners leaning onto the planted
    arms."""
    def run_once(attempt):
        r = run_scaleout(2, n_groups=4, throughput_events=100,
                         paced_events=30, paced_rate=500.0,
                         seed=11 + 37 * attempt, device="cpu")
        assert len(r.worker_stats) == 2
        _ownership(r, 4)
        assert sum(w["events"] for w in r.worker_stats) == 16 + 100 + 30
        assert r.heartbeats >= 4
        assert sorted(r.worker_throughput) == [0, 1]
        assert all(t > 0 for t in r.worker_throughput.values())
        assert r.stragglers == []
        assert sorted(r.worker_start_s) == [0, 1]
        assert all(0 < s < 120 for s in r.worker_start_s.values())
        assert r.decisions_per_sec > 1 and r.p50_latency_ms < 10_000
        return r.best_action_fraction
    _lean_with_retries(run_once)


def test_shuffle_grouping_mode():
    """The reference's shuffleGrouping: one shared event queue, private
    learners for every group in every worker, each worker reading every
    reward stream: the total answered once, every worker's learners fed
    the whole reward stream."""
    def run_once(attempt):
        r = run_scaleout(2, n_groups=4, throughput_events=100,
                         paced_events=30, paced_rate=500.0,
                         seed=11 + 37 * attempt, grouping="shuffle",
                         device="cpu")
        assert all(w["grouping"] == "shuffle" for w in r.worker_stats)
        assert all(len(w["groups"]) == 4 for w in r.worker_stats)
        assert sum(w["events"] for w in r.worker_stats) == 16 + 100 + 30
        rewards = [w["rewards"] for w in r.worker_stats]
        assert rewards[0] == rewards[1] > 0
        return r.best_action_fraction
    _lean_with_retries(run_once)


@pytest.mark.parametrize("engine", [False, True], ids=["step", "engine"])
def test_sigkill_mid_stream_loses_nothing(engine):
    """SIGKILL a worker mid-stream, respawn it with replay: after the
    driver's dedup every event is answered once and the ledger is empty;
    duplicates come only from the killed worker's answered-but-unacked
    window (a micro-batch under the engine)."""
    r = run_chaos(2, n_groups=4, n_events=240, kill_after=60, seed=13,
                  engine=engine, device="cpu")
    assert r.killed_at >= 60
    assert r.unique_answered == r.n_events
    assert r.pending_left == 0
    assert r.duplicates <= (2 * 64 if engine else 50), r.duplicates
    assert len(r.worker_stats) == 2
    assert all(w.get("engine", False) == engine for w in r.worker_stats)


def test_scaleout_engine_workers_answer_everything():
    r = run_scaleout(2, n_groups=4, throughput_events=150, paced_events=50,
                     paced_rate=500.0, seed=11, engine=True, device="cpu")
    assert sum(w["events"] for w in r.worker_stats) == 16 + 150 + 50
    assert all(w.get("engine") for w in r.worker_stats)
    _ownership(r, 4)
    assert r.heartbeats > 0


def test_workers_swap_in_the_registry_head_and_the_fleet_report_says_so(
        tmp_path):
    """A head published before the run is swapped in by every worker; the
    merged ``--metrics-out`` fleet report attributes
    ``lifecycle.model_version`` and ``lifecycle.swap_total`` per worker,
    and is written as JSONL and ``.prom``."""
    from avenir_tpu_torch.lifecycle.registry import SnapshotRegistry
    from avenir_tpu_torch.models.bandits.learners import Learner
    reg_dir = str(tmp_path / "reg")
    seed_learner = Learner("softMax", [f"a{i}" for i in range(3)],
                           {"current.decision.round": 1, "batch.size": 8},
                           123, device="cpu")
    SnapshotRegistry(reg_dir).publish(seed_learner.state,
                                      kind="learner-state")
    out = tmp_path / "fleet.jsonl"
    r = run_scaleout(2, n_groups=4, n_actions=3, throughput_events=80,
                     paced_events=20, paced_rate=400.0, seed=11,
                     metrics_out=str(out), lifecycle_dir=reg_dir,
                     device="cpu")
    assert sum(w["events"] for w in r.worker_stats) == 16 + 80 + 20
    assert sorted(r.worker_reports) == [0, 1]
    gauges = r.fleet_report["gauges"]
    assert gauges["lifecycle.model_version"] == {"w0": 1.0, "w1": 1.0}
    assert set(gauges["lifecycle.swap_total"]) == {"w0", "w1"}
    assert all(v >= 1 for v in gauges["lifecycle.swap_total"].values())
    assert out.exists() and (tmp_path / "fleet.jsonl.prom").exists()


def test_traced_run_discards_stale_broker_stamps(tmp_path):
    """A traced run over a broker passed in: stamps from the driver and
    the workers merge into one Chrome trace, a stale stamp an earlier run
    left on the broker is not among them, and no warmup event starts a
    trace."""
    trace_path = tmp_path / "trace.json"
    with MiniRedisServer() as srv:
        client = MiniRedisClient(srv.host, srv.port)
        client.lpush(TR.TRACE_QUEUE, json.dumps(
            {"trace": "stale-1", "stamp": "dispatch", "ts": 1.0,
             "pid": 9999}))
        client.close()
        r = run_scaleout(1, n_groups=2, throughput_events=48,
                         paced_events=16, paced_rate=500.0, seed=5,
                         server=srv, trace_out=str(trace_path),
                         trace_sample=4, device="cpu")
    assert r.trace_stamps > 0 and r.trace_out == str(trace_path)
    doc = json.loads(trace_path.read_text())
    stamps = [e for e in doc["traceEvents"] if e.get("cat") == "stamp"]
    traces = {e["args"]["trace"] for e in stamps}
    assert traces and "stale-1" not in traces
    # one trace in trace_sample of the timed events, none of the warmup's
    assert len(traces) <= (48 + 16) // 4
    assert {e["name"] for e in stamps} >= {"producer_enqueue", "dispatch"}
    assert not TR.context().enabled


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default runs on it")
def test_the_default_device_raises_without_a_gpu():
    for run in (lambda: run_scaleout(1), lambda: run_chaos(2),
                lambda: worker_main("localhost", 1, 0, 1, ["g0"], "softMax",
                                    ["a"], {}, 7),
                lambda: main(["--sweep", "1", "--events", "8"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


@pytest.mark.parametrize("argv", [
    ["--brokers", "localhost:1,localhost:2"], ["--elastic", "--worker"],
    ["--handoff-dir", "/nowhere"], ["--fleet-engine", "--worker"],
    ["--coordinator"]])
def test_the_elastic_flags_are_refused_by_their_roadmap_title(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{argv[0]} is not ported yet" in err
    assert "'Rebalance and the control plane'" in err


def test_worker_main_refuses_a_broker_fleet():
    with pytest.raises(ValueError, match="Rebalance and the control plane"):
        worker_main("localhost", 1, 0, 1, ["g0"], "softMax", ["a"], {}, 7,
                    brokers="localhost:1,localhost:2", device="cpu")


# -- a worker's scrape endpoint, against the JAX worker's ---------------------

_OBS_CONFIG = {"current.decision.round": 1, "batch.size": 2}


def _port_worker_cmd(host, port, flight):
    return [sys.executable, "-m", "avenir_tpu_torch.stream.scaleout",
            "--worker", "--host", host, "--port", str(port),
            "--worker-id", "0", "--n-workers", "1", "--groups", "g0",
            "--learner-type", "softMax", "--actions", "a,b",
            "--config", json.dumps(_OBS_CONFIG), "--seed", "3", "--engine",
            "--device", "cpu", "--broker-reconnect", "--obs-port", "0",
            "--obs-flight", flight, "--obs-slo-ms", "5000"]


def _scrape_worker(package, flight):
    """One engine worker with ``--broker-reconnect``, a scrape endpoint on
    an auto-assigned port, a flight path and an SLO bar, over a broker
    holding two events of its one group: its announcement, its
    ``/healthz`` once both are served, the keys of ``/metrics/rates``,
    its final stats, and whether a flight file was left."""
    with MiniRedisServer() as srv:
        client = MiniRedisClient(srv.host, srv.port)
        client.lpush("eventQueue:g0", "g0:0", "g0:1")
        if package == "jax":
            from avenir_tpu.stream import scaleout as JS
            proc = JS._spawn_worker(
                srv.host, srv.port, 0, 1, ["g0"], "softMax", ["a", "b"],
                _OBS_CONFIG, seed=3, engine=True, broker_reconnect=True,
                obs_port=0, obs_flight=flight, obs_slo_ms=5000.0)
        else:
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [TS._PACKAGE_ROOT, os.environ.get("PYTHONPATH", "")]))
            proc = subprocess.Popen(
                _port_worker_cmd(srv.host, srv.port, flight), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            announce = json.loads(proc.stdout.readline())
            base = f"http://localhost:{announce['obs_port']}"
            deadline = time.monotonic() + 120
            while True:
                health = json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=10).read())
                if health.get("events") == 2:
                    break
                assert time.monotonic() < deadline, health
                time.sleep(0.05)
            rates = json.loads(urllib.request.urlopen(
                base + "/metrics/rates", timeout=10).read())
            client.lpush("eventQueue:g0", TS.STOP_SENTINEL)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
        client.close()
    assert proc.returncode == 0, err[-1500:]
    return (announce, health, sorted(rates), json.loads(out.splitlines()[-1]),
            os.path.exists(flight))


def test_worker_scrape_endpoint_answers_as_the_jax_worker(tmp_path):
    """The port's worker flags ``--obs-port 0 --obs-flight --obs-slo-ms``
    (and ``--broker-reconnect``) against the JAX worker spawned with the
    same options, side by side: the port announced as a JSON line,
    ``/healthz`` mid-run with the same liveness, alert, ownership, model
    version and event fields, the same ``/metrics/rates`` keys, the port
    in the final stats beside the same alert brief, and no flight file
    after a clean exit."""
    with ThreadPoolExecutor(2) as pool:
        got, want = pool.map(
            lambda pkg: _scrape_worker(pkg, str(tmp_path / f"{pkg}.flight"
                                                ".jsonl")),
            ("port", "jax"))
    volatile = ("ts", "host", "pid", "uptime_s")
    for announce, health, _, stats, flight_left in (got, want):
        assert announce["worker"] == 0 and announce["obs_port"] > 0
        assert health["ok"] and health["worker_id"] == 0
        assert health["groups"] == ["g0"]
        assert stats["events"] == 2
        assert stats["obs_port"] == announce["obs_port"]
        assert not flight_left
    assert sorted(got[0]) == sorted(want[0])
    assert ({k: v for k, v in got[1].items() if k not in volatile}
            == {k: v for k, v in want[1].items() if k not in volatile})
    assert got[2] == want[2]
    assert sorted(got[3]) == sorted(want[3])
    assert got[3]["alerts"] == want[3]["alerts"]
