"""The port's scale-out tier (``stream/scaleout.py``) against the JAX
package's, in one process on the CPU: the heartbeat arithmetic on the same
streams, the heartbeat and report wire read across packages both ways,
``HeartbeatBuffer`` against a dead endpoint, ``_StoppableQueues``' stop
sentinel, and ``worker_main`` (step loop and engine) on queues prefilled
with the same events, rewards and sentinels: the action queue byte for
byte, the stats' events, rewards and groups, with and without a snapshot
the JAX package's registry published. Also the port's own: a worker with
``broker_reconnect`` across a broker restart, and a broker subprocess
that fails before it listens."""

import copy
import functools
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from avenir_tpu.lifecycle import registry as JR
from avenir_tpu.models.bandits.learners import Learner as JLearner
from avenir_tpu.obs import exporters as JX
from avenir_tpu.stream import scaleout as JS
from avenir_tpu.stream.miniredis import MiniRedisClient as JClient

from avenir_tpu_torch.obs import exporters as TX
from avenir_tpu_torch.stream import scaleout as TS
from avenir_tpu_torch.stream.miniredis import (
    MiniRedisClient as TClient, MiniRedisServer as TServer)

torch.set_num_threads(2)

GROUPS = ["g0", "g1", "g2", "g3"]
ACTIONS = ["a0", "a1", "a2"]
CONFIG = {"current.decision.round": 1, "batch.size": 2}
SEED = 7
N_EVENTS, N_REWARDS = 48, 24
WORKER_TYPES = ["softMax", "upperConfidenceBoundOne", "exponentialWeight"]


# -- the heartbeat arithmetic -------------------------------------------------

def _hb(worker, events, ts, rewards=0):
    return {"worker": worker, "events": events, "rewards": rewards,
            "ts": ts, "grouping": "fields"}


def _fleet(n_workers, seed, slow=None, stale=None):
    """Seeded heartbeat streams, 25 events apart: worker ``slow`` serves a
    tenth as fast, worker ``stale`` stops beating halfway."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_workers):
        beats = 3 if w == stale else 6
        ts = 1000.0 + np.cumsum(rng.uniform(0.2, 0.6, beats))
        step = 3 if w == slow else 25
        out += [_hb(w, step * i, float(t), rewards=i) for i, t in
                enumerate(ts)]
    rng.shuffle(out)
    return out


HEARTBEATS = {
    "empty": [],
    "single_worker": [_hb(0, 0, 100.0), _hb(0, 25, 101.5),
                      _hb(0, 60, 103.0)],
    "one_beat_each": [_hb(0, 40, 50.0), _hb(1, 10, 50.0), _hb(2, 33, 51.0)],
    "fleet": _fleet(4, 3),
    "straggler": _fleet(4, 5, slow=2),
    "stale_heartbeat": _fleet(3, 9, stale=1),
    "two_workers": _fleet(2, 11, slow=1),
}


def _reports(heartbeats):
    """Fleet reports for the latency p99s: a worker's decision-latency
    span (none for worker 1, an empty one for worker 2)."""
    workers = sorted({hb["worker"] for hb in heartbeats})
    out = {}
    for w in workers:
        spans = {} if w == 1 else {"engine.decision_latency": {
            "count": 0 if w == 2 else 10 + w,
            "p99_ms": 4.0 * (w + 1) ** 2}}
        out[w] = {"spans": spans}
    return out


def _arithmetic(pkg, heartbeats):
    hbs = copy.deepcopy(heartbeats)
    now = max([h["ts"] for h in hbs], default=1000.0) + 0.7
    p99 = pkg.worker_latency_p99(_reports(hbs))
    return {
        "owned": [pkg.owned_groups([f"g{i}" for i in range(7)], w, n)
                  for n in (1, 2, 3, 4) for w in range(n)],
        "max_age": [pkg.report_max_age_s(c) for c in (0.1, 0.5, 2)],
        "throughput": pkg.worker_throughput(hbs),
        "liveness": [pkg.worker_liveness(hbs, cadence_s=c, now=now)
                     for c in (0.1, 0.5)],
        "stragglers": [
            pkg.detect_stragglers(hbs),
            pkg.detect_stragglers(hbs, min_events_fraction=0.8),
            pkg.detect_stragglers(hbs, stale_after_s=0.5, now=now),
            pkg.detect_stragglers(hbs, latency_p99=p99),
            pkg.detect_stragglers(hbs, latency_p99=p99, latency_factor=2.0),
        ],
        "p99": p99,
    }


@pytest.mark.parametrize("case", sorted(HEARTBEATS))
def test_heartbeat_arithmetic_equals_jax(case):
    got = _arithmetic(TS, HEARTBEATS[case])
    assert got == _arithmetic(JS, HEARTBEATS[case])
    if case == "straggler":
        assert got["stragglers"][0] == [2]
    if case == "stale_heartbeat":
        assert 1 in got["stragglers"][2]
        assert got["liveness"][0][1]["dead"]


# -- the wire: heartbeats and reports ------------------------------------------

@pytest.mark.parametrize("pusher", ["jax", "port"])
def test_heartbeats_and_reports_read_across_packages(pusher):
    """One package pushes heartbeats and a telemetry report through the
    broker; the other drains them: the same dicts, the latest report per
    worker, and the queue empty after."""
    push, read = (JS, TS) if pusher == "jax" else (TS, JS)
    hub = (JX if pusher == "jax" else TX).hub()
    with TServer() as srv:
        pc = (JClient if pusher == "jax" else TClient)(srv.host, srv.port)
        rc = TClient(srv.host, srv.port)
        hub.enable()
        try:
            hub.set_meta(worker_id=3)
            for i in range(3):
                push.push_heartbeat(pc, 3, 25 * i, i, grouping="fields")
            push.push_heartbeat(pc, 5, 7, 1, grouping="shuffle")
        finally:
            hub.disable()
            hub.reset()
        beats = read.read_heartbeats(rc)
        assert [(b["worker"], b["events"], b["rewards"], b["grouping"])
                for b in beats] == [(3, 0, 0, "fields"), (3, 25, 1, "fields"),
                                    (3, 50, 2, "fields"),
                                    (5, 7, 1, "shuffle")]
        assert all(isinstance(b["ts"], float) for b in beats)
        reports = read.read_worker_reports(rc)
        # each push superseded the last one of its worker
        assert sorted(reports) == [3, 5]
        assert reports[3]["meta"]["worker_id"] == 3
        assert rc.llen(TS.HEARTBEAT_QUEUE) == rc.llen(TS.TELEMETRY_QUEUE) == 0
        # a report whose stamp is older than the bar ages out on read
        rc.lpush(TS.TELEMETRY_QUEUE, json.dumps(
            {"worker": 9, "report": {"meta": {"generated_at": 10.0}}}))
        assert read.read_worker_reports(rc, max_age_s=5.0, now=20.0) == {}
        pc.close()
        rc.close()


# -- HeartbeatBuffer -----------------------------------------------------------

def _buffer_run(pkg):
    """Eight pushes into a buffer of four whose endpoint refuses (a port
    bound and never listening, so no other server can take it), a failed
    dial, then the endpoint moved to a live broker: what was dropped, and
    the order the survivors landed in."""
    with socket.socket() as dead:
        dead.bind(("localhost", 0))
        endpoint = ["localhost", dead.getsockname()[1]]
        buf = pkg.HeartbeatBuffer(lambda: tuple(endpoint), maxlen=4,
                                  retry_s=0.05, timeout_s=0.5)
        try:
            for i in range(8):
                buf.lpush("hb", f"beat{i}")   # never raises, never blocks
            assert buf.pending() == 4
            deadline = time.monotonic() + 30
            while buf.failures == 0:
                assert time.monotonic() < deadline, "the flusher never dialed"
                time.sleep(0.01)
            with TServer() as srv:
                # the flusher re-reads the endpoint on its next dial
                endpoint[:] = [srv.host, srv.port]
                buf.close(flush_timeout_s=5.0)
                landed = TClient(srv.host, srv.port).lrange("hb", 0, -1)
            return buf.dropped, buf.flushed, buf.failures > 0, landed
        finally:
            buf.close(flush_timeout_s=0.1)


def test_heartbeat_buffer_drops_oldest_then_flushes_in_order():
    got = _buffer_run(TS)
    assert got[:3] == (4, 4, True)
    assert got[3] == [b"beat7", b"beat6", b"beat5", b"beat4"]
    want = _buffer_run(JS)
    assert got[:2] == want[:2] and got[3] == want[3]


# -- _StoppableQueues ----------------------------------------------------------

def _sentinel_run(pkg, client_cls):
    with TServer() as srv:
        c = client_cls(srv.host, srv.port)
        out = {}
        c.lpush("eventQueue:g0", "g0:1", "g0:2", "g0:3", pkg.STOP_SENTINEL)
        q = pkg._StoppableQueues(c, "g0")
        out["pop"] = (q.pop_events(16), q.stopped, q.pop_events(16),
                      q.pop_event())
        out["pending"] = c.lrange("pendingQueue:g0", 0, -1)
        c.lpush("eventQueue:g1", "g1:1", "g1:2", pkg.STOP_SENTINEL)
        q = pkg._StoppableQueues(c, "g1")
        out["shed"] = (q.shed_events(16), q.stopped,
                       c.lrange("eventQueue:g1", 0, -1))
        out["after_shed"] = (q.pop_event(), q.stopped, q.shed_events(4),
                             c.llen("pendingQueue:g1"))
        c.lpush("eventQueue:g2", "g2:1", pkg.STOP_SENTINEL)
        q = pkg._StoppableQueues(c, "g2")
        out["one_by_one"] = (q.pop_event(), q.pop_event(), q.stopped,
                             c.llen("pendingQueue:g2"))
        c.close()
        return out


def test_stoppable_queues_retire_on_the_sentinel():
    """Bulk pops cut at the sentinel and ack it; a shed sweep that
    swallows it puts it back at the head, so the next pop retires the
    view; the ledger keeps only real events."""
    got = _sentinel_run(TS, TClient)
    assert got == _sentinel_run(JS, JClient)
    assert got["pop"] == (["g0:1", "g0:2", "g0:3"], True, [], None)
    assert sorted(got["shed"][0]) == ["g1:1", "g1:2"]
    assert got["shed"][1:] == (False, [TS.STOP_SENTINEL.encode()])
    assert got["after_shed"][:2] == (None, True)
    assert got["one_by_one"] == ("g2:1", None, True, 1)


# -- the workers on prefilled queues -------------------------------------------

def _prefill(client):
    """Every group's events (event i in group i mod 4), rewards and stop
    sentinel, as the driver leaves them."""
    rng = np.random.default_rng(SEED)
    for i in range(N_EVENTS):
        g = GROUPS[i % len(GROUPS)]
        client.lpush(f"eventQueue:{g}", f"{g}:{i}")
    for j in range(N_REWARDS):
        g = GROUPS[j % len(GROUPS)]
        client.lpush(f"rewardQueue:{g}",
                     f"{ACTIONS[int(rng.integers(3))]},{float(j % 5)}")
    for g in GROUPS:
        client.lpush(f"eventQueue:{g}", JS.STOP_SENTINEL)


def _run_worker(pkg, learner_type, engine, lifecycle_dir=None):
    """Worker 0 of 2 (groups g0 and g2) on a prefilled broker: (the action
    queue's bytes, the stats that must match, the ledgers' lengths)."""
    kw = {"device": "cpu"} if pkg is TS else {}
    with TServer() as srv:
        c = TClient(srv.host, srv.port)
        _prefill(c)
        stats = pkg.worker_main(
            srv.host, srv.port, 0, 2, GROUPS, learner_type, ACTIONS,
            dict(CONFIG), SEED, engine=engine,
            lifecycle_dir=None if lifecycle_dir is None
            else str(lifecycle_dir), **kw)
        actions = c.lrange("actionQueue", 0, -1)
        pending = [c.llen(f"pendingQueue:{g}") for g in GROUPS]
        beats = TS.read_heartbeats(c)
        c.close()
    keep = {k: stats[k] for k in ("worker", "events", "rewards", "replayed",
                                  "groups", "heartbeats_dropped")}
    return actions, keep, pending, len(beats)


@functools.lru_cache(maxsize=None)
def _jax_worker(learner_type, engine, lifecycle_dir=None):
    return _run_worker(JS, learner_type, engine, lifecycle_dir)


@pytest.mark.parametrize("engine", [False, True], ids=["step", "engine"])
@pytest.mark.parametrize("learner_type", WORKER_TYPES)
def test_worker_action_queue_equals_jax(learner_type, engine):
    got = _run_worker(TS, learner_type, engine)
    want = _jax_worker(learner_type, engine)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["groups"] == ["g0", "g2"]
    assert got[1]["events"] == N_EVENTS // 2
    assert got[1]["rewards"] == N_REWARDS // 2
    assert len(got[0]) == N_EVENTS // 2
    # the owned groups' ledgers retired; the others' events untouched
    assert got[2] == [0, 0, 0, 0]
    assert got[3] >= 2             # the start and the final heartbeat


def test_worker_swaps_in_a_snapshot_the_jax_registry_published(tmp_path):
    """A learner state the JAX package published replaces every owned
    group's learner before the first event: both packages' workers then
    write the same action queue, and not the one the seeded learners
    write."""
    learner = JLearner("softMax", ACTIONS, dict(CONFIG), seed=4)
    learner.set_reward_batch([(ACTIONS[i % 3], 10.0 * (i % 3 == 2))
                              for i in range(30)])
    JR.SnapshotRegistry(str(tmp_path)).publish(
        learner.state, kind="learner-state",
        extra={"learner_type": "softMax"})
    for engine in (False, True):
        got = _run_worker(TS, "softMax", engine, lifecycle_dir=tmp_path)
        want = _jax_worker("softMax", engine, lifecycle_dir=str(tmp_path))
        assert got[0] == want[0] and got[1] == want[1]
        assert got[0] != _jax_worker("softMax", engine)[0]


# -- the broker: a restart under a worker, a start that fails ------------------

@pytest.mark.parametrize("kill_after", [5, 20, 40])
@pytest.mark.parametrize("engine", [False, True], ids=["step", "engine"])
def test_worker_reconnects_across_a_broker_restart(tmp_path, engine,
                                                    kill_after):
    """``worker_main(broker_reconnect=True)`` on a broker that drops every
    connection after ``kill_after`` more commands (a kill mid-run) and
    comes back on the same port over its append-only file: the worker
    redials, every event of its groups is answered (a resend may answer
    one twice), every ledger is retired and the reconnect is counted. A
    lost sweep's events go back ahead of the stop sentinel (the engine
    lost them at each of these kill points before)."""
    aof = str(tmp_path / "broker.aof")
    srv = TServer(port=0, aof_path=aof).start()
    port = srv.port
    c = TClient(srv.host, port)
    _prefill(c)
    c.close()
    srv._crash_after = srv._executed + kill_after
    box = {}

    def restart():
        # strictly after the crash: the old listener goes before the rebind
        while srv._executed < srv._crash_after:
            time.sleep(0.005)
        time.sleep(0.1)
        srv.close()
        box["srv"] = TServer(port=port, aof_path=aof).start()

    restarter = threading.Thread(target=restart, daemon=True)
    restarter.start()
    stats = TS.worker_main(srv.host, port, 0, 2, GROUPS, "softMax", ACTIONS,
                           dict(CONFIG), SEED, engine=engine,
                           broker_reconnect=True, device="cpu")
    restarter.join(timeout=30)
    new = box["srv"]
    try:
        c = TClient(new.host, port)
        answers = c.lrange("actionQueue", 0, -1)
        pending = [c.llen(f"pendingQueue:{g}") for g in GROUPS]
        c.close()
    finally:
        new.close()
    owned = {f"{g}:{i}" for i in range(N_EVENTS) for g in ("g0", "g2")
             if GROUPS[i % len(GROUPS)] == g}
    assert stats["broker_reconnects"] >= 1
    assert {a.decode().partition(",")[0] for a in answers} == owned
    assert len(answers) <= len(owned) + CONFIG["batch.size"] * 8
    assert pending == [0, 0, 0, 0]
    assert stats["groups"] == ["g0", "g2"]


def test_a_broker_that_exits_first_fails_the_run_with_its_stderr(
        tmp_path, monkeypatch):
    script = tmp_path / "broker.py"
    script.write_text("import sys\nsys.stderr.write('port taken')\n"
                      "sys.exit(3)\n")
    monkeypatch.setattr(TS, "_BROKER_SCRIPT", str(script))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 3: 'port taken'"):
        with TS._broker("localhost"):
            pass
    assert time.monotonic() - t0 < TS.BROKER_START_S / 2
