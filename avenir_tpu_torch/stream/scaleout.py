"""Multi-process serving scale-out on one broker: the ``num.workers``
contract.

Counterpart of the single-broker half of ``avenir_tpu/stream/scaleout.py``.
The reference's Storm topology scales serving by running several bolt
instances across worker processes (ReinforcementLearnerTopology.java:64-82,
knobs num.workers / bolt.threads). Here the same deployment shape is N OS
processes, each running ``OnlineLearnerLoop`` (or ``ServingEngine``)
instances for the learner groups it OWNS (group i belongs to worker i mod
N, the fieldsGrouping analogue: each group's state lives in exactly one
process), all sharing one Redis-protocol broker:

    eventQueue:<group>   events for one group       (driver lpush, owner pops
                                                     via atomic RPOPLPUSH)
    pendingQueue:<group> ack/replay ledger          (entry retired by LREM
                                                     after the answer is
                                                     written; reclaimed by a
                                                     replacement worker on
                                                     crash, as the chombo
                                                     GenericSpout/GenericBolt
                                                     ack bookkeeping and
                                                     replay.failed.message,
                                                     ReinforcementLearnerBolt
                                                     .java:41)
    rewardQueue:<group>  rewards for one group      (driver lpush, owner
                                                     lindex-cursor drain)
    actionQueue          all selections, shared     (owners lpush, driver rpop)

Delivery is at-least-once across crashes (ack-after-answer; Storm's own
guarantee); the action-queue consumer deduplicates by event id, which
completes the exactly-once effect: ``run_chaos`` SIGKILLs a worker
mid-stream and checks it.

``run_scaleout`` is the measured demo: a producer with per-group planted
best actions drives N workers through two phases, drain-everything
throughput (decisions/s) and a paced phase for p50/p90 event-to-action
latency, and checks that every event was answered exactly once and that
the learners converged onto the planted arms.

Workers are subprocesses (``python -m avenir_tpu_torch.stream.scaleout
--worker ...``) against any RESP broker: a ``miniredis`` subprocess by
default, or a server passed in. Each worker builds its learners on
``--device`` (default ``cuda``; ``cpu`` only when asked), so N workers on
one card open N CUDA contexts. The elastic workers, the broker fleet's
workers and the coordinators of the JAX module are not ported here:
``--brokers``, ``--elastic``, ``--handoff-dir``, ``--fleet-engine`` and
``--coordinator`` are refused, and so is ``worker_main(brokers=...)``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import select
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.stream.loop import (
    OnlineLearnerLoop, RedisQueues, reclaim_pending)
from avenir_tpu_torch.stream.miniredis import (
    MiniRedisClient, MiniRedisServer, connect_with_retry)
from avenir_tpu_torch.utils.device import (
    DeviceLike, device_type, resolve_device)
from avenir_tpu_torch.utils.roadmap import roadmap_item

# the later work that ports the elastic half of the JAX module
_REBALANCE = roadmap_item("Rebalance and the control plane")

STOP_SENTINEL = "__STOP__"

# worker liveness: every worker lpushes a JSON heartbeat through the same
# broker its queues live on (the "job UI" the port lost — per-worker
# progress was only visible in the JobTracker). One shared list; the
# driver drains it after the run (or mid-run, for live monitoring).
HEARTBEAT_QUEUE = "heartbeatQueue"
HEARTBEAT_EVERY = 25  # events between heartbeats (plus start + exit)

# fleet telemetry: telemetry-armed workers serialize their FULL
# obs report through the broker on the heartbeat cadence; the coordinator
# drains the list, keeps each worker's latest, and merges them into ONE
# fleet report (obs.exporters.merge_reports) written by --metrics-out
TELEMETRY_QUEUE = "telemetryQueue"


def owned_groups(groups: Sequence[str], worker_id: int,
                 n_workers: int) -> List[str]:
    """Group i -> worker i mod N (fieldsGrouping: stable ownership)."""
    return [g for i, g in enumerate(groups) if i % n_workers == worker_id]


# the last report payload this PROCESS pushed, per worker id: each new
# push retires the previous one (LREM by value), so the telemetry queue
# holds ~one full report per live worker instead of growing by one
# multi-KB snapshot per heartbeat for the whole run. A SIGKILLed
# worker's final entry survives untrimmed — bounded at one per crash,
# and the driver keeps the latest per worker anyway.
_LAST_REPORT_PAYLOAD: Dict[int, str] = {}


def push_worker_report(client, worker_id: int) -> None:
    """Ship this worker's merged telemetry report through the broker —
    a no-op unless the process's TelemetryHub is live, so the default
    (untelemetered) worker pays nothing. Rides the heartbeat cadence:
    the caller is :func:`push_heartbeat`. Supersedes (removes) the
    report this process pushed last time, keeping the queue bounded."""
    try:
        from avenir_tpu_torch.obs.exporters import TelemetryHub
        hub = TelemetryHub._instance
        if hub is None or not hub.enabled:
            return
        report = hub.report()
    except Exception:
        # telemetry must never sink a serving worker
        return
    payload = json.dumps({"worker": worker_id, "report": report})
    previous = _LAST_REPORT_PAYLOAD.get(worker_id)
    if previous is not None:
        try:
            client.lrem(TELEMETRY_QUEUE, 1, previous)
        except Exception:
            pass                  # a client without lrem just accumulates
    client.lpush(TELEMETRY_QUEUE, payload)
    _LAST_REPORT_PAYLOAD[worker_id] = payload


def report_max_age_s(cadence_s: float) -> float:
    """The staleness bar for shipped fleet reports: 3x the heartbeat
    cadence — the same factor the liveness detector calls a worker DEAD
    at (one rule, two consumers)."""
    return DEAD_AFTER_FACTOR * float(cadence_s)


def read_worker_reports(client, max_age_s: Optional[float] = None,
                        now: Optional[float] = None) -> Dict[int, Dict]:
    """Drain the telemetry queue (driver side): the LATEST report per
    worker wins — interim cadence pushes are superseded snapshots of the
    same monotone histograms, not increments to sum.

    ``max_age_s`` ages DEPARTED workers out — without it a dead worker's
    final report (its ``source``-labeled gauges, its straggler-detection
    p99) haunts every later fleet merge forever. Staleness keys on the
    report's own ``meta.generated_at`` (the hub stamps it at snapshot
    time), bar = 3x heartbeat cadence via :func:`report_max_age_s`."""
    out: Dict[int, Dict] = {}
    while True:
        raw = client.rpop(TELEMETRY_QUEUE)
        if raw is None:
            break
        entry = json.loads(raw.decode())
        out[int(entry["worker"])] = entry["report"]
    if max_age_s is not None:
        t_now = time.time() if now is None else now
        for worker in list(out):
            generated = (out[worker].get("meta") or {}).get(
                "generated_at") or 0.0
            if t_now - float(generated) > max_age_s:
                del out[worker]
    return out


def push_heartbeat(client, worker_id: int, events: int, rewards: int,
                   grouping: str = "fields") -> None:
    client.lpush(HEARTBEAT_QUEUE, json.dumps(
        {"worker": worker_id, "events": events, "rewards": rewards,
         "ts": time.time(), "grouping": grouping}))
    push_worker_report(client, worker_id)
    # sampled trace stamps ride the same cadence: one lpush
    # per heartbeat when tracing is armed, nothing otherwise
    from avenir_tpu_torch.obs import tracing as _tracing
    if _tracing.context().enabled:
        _tracing.push_stamps(client)


def read_heartbeats(client) -> List[Dict]:
    """Drain every pending heartbeat (driver side), oldest first."""
    out: List[Dict] = []
    while True:
        raw = client.rpop(HEARTBEAT_QUEUE)
        if raw is None:
            return out
        out.append(json.loads(raw.decode()))


class HeartbeatBuffer:
    """Liveness-I/O decoupler: a drop-in ``lpush``/
    ``lrem`` target for :func:`push_heartbeat` & friends that can never
    raise into — or stall — the serving loop.

    Every push lands in a bounded in-memory queue (drop-oldest; each
    eviction counts into the ``heartbeat.dropped`` gauge) and a daemon
    flusher ships it to the CURRENT control endpoint over its own
    short-timeout client. During a broker outage the serving thread
    keeps batching at full speed while heartbeats/telemetry/trace
    stamps accumulate here; when the broker (or its failover
    replacement — ``endpoint_fn`` re-resolves on every dial after a
    failure) comes back, the backlog flushes in order. The flusher never
    shares the serving path's client: a blocking redial inside a shared
    client's lock was exactly the stall this class exists to remove."""

    def __init__(self, endpoint_fn: Callable[[], Tuple[str, int]],
                 maxlen: int = 1024, retry_s: float = 0.5,
                 timeout_s: float = 2.0):
        self._endpoint_fn = endpoint_fn
        self._maxlen = max(int(maxlen), 1)
        self._retry_s = float(retry_s)
        self._timeout_s = float(timeout_s)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = False
        self._client: Optional[MiniRedisClient] = None
        self._probe: Optional[MiniRedisClient] = None
        self.dropped = 0
        self.flushed = 0
        self.failures = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="heartbeat-flush")
        self._thread.start()

    # -- the client-shaped surface push_heartbeat drives -------------------

    def lpush(self, key, *values) -> int:
        # one queued op per CALL, not per value: a multi-value push
        # (push_stamps ships a whole trace-stamp batch in one lpush)
        # stays one broker round trip and one eviction unit
        self._enqueue([("lpush", key, tuple(values))])
        return 0

    def lrem(self, key, count, value) -> int:
        # report supersede rides the same ordered queue; an evicted or
        # failed lrem just leaves an extra stale report for the
        # driver's latest-wins drain
        self._enqueue([("lrem", key, count, value)])
        return 0

    def llen(self, key) -> int:
        """Synchronous passthrough for the tracing layer's
        TRACE_QUEUE_MAX backpressure probe (one call per heartbeat
        cadence, the pre-buffer cost). Runs on the CALLER's own lazy
        short-timeout client — never the flusher's (cross-thread) —
        and raises on an unreachable broker, which push_stamps already
        treats as skip-this-flush."""
        if self._probe is None:
            host, port = self._endpoint_fn()
            self._probe = MiniRedisClient(host, port,
                                          timeout=self._timeout_s)
        try:
            return int(self._probe.llen(key))
        except (ConnectionError, OSError):
            self._probe.close()
            self._probe = None
            raise

    def _enqueue(self, ops: List[tuple]) -> None:
        with self._lock:
            for op in ops:
                if len(self._q) >= self._maxlen:
                    self._q.popleft()          # drop-oldest, counted
                    self.dropped += 1
                self._q.append(op)
        if self.dropped:
            _hub_gauges_safe({"heartbeat.dropped": float(self.dropped)})
        self._wake.set()

    # -- the flusher -------------------------------------------------------

    def _dial(self) -> Optional[MiniRedisClient]:
        if self._client is not None:
            return self._client
        try:
            host, port = self._endpoint_fn()
            self._client = MiniRedisClient(host, port,
                                           timeout=self._timeout_s)
        except (ConnectionError, OSError):
            self._client = None
        return self._client

    def _drop_client(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self._retry_s)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._q:
                        break
                    op = self._q[0]
                client = self._dial()
                if client is None:
                    self.failures += 1
                    break                     # retry after retry_s
                try:
                    if op[0] == "lpush":
                        client.lpush(op[1], *op[2])
                    else:
                        client.lrem(op[1], op[2], op[3])
                except (ConnectionError, OSError):
                    self.failures += 1
                    self._drop_client()
                    break
                with self._lock:
                    # pop the op we just shipped — unless eviction
                    # already rotated it out under load
                    if self._q and self._q[0] is op:
                        self._q.popleft()
                self.flushed += 1
            if self._stopping:
                with self._lock:
                    empty = not self._q
                if empty or self._client is None:
                    return

    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self, flush_timeout_s: float = 5.0) -> None:
        """Drain what the broker will accept, then stop the flusher —
        the worker-exit path (the FINAL heartbeat must land before the
        driver reads the stream)."""
        deadline = time.monotonic() + float(flush_timeout_s)
        while self.pending() and time.monotonic() < deadline:
            self._wake.set()
            time.sleep(0.01)
        self._stopping = True
        self._wake.set()
        self._thread.join(timeout=2.0)
        self._drop_client()
        if self._probe is not None:
            self._probe.close()
            self._probe = None


def _hub_gauges_safe(gauges: Dict) -> None:
    """set_hub_gauges_if_live without making obs a hard import here."""
    try:
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        set_hub_gauges_if_live(gauges)
    except Exception:
        pass


def worker_throughput(heartbeats: Sequence[Dict]) -> Dict[int, float]:
    """events/sec per worker over its first->last heartbeat interval.
    A worker with a single heartbeat (or zero elapsed time) reports its
    raw event count — a finite, comparable stand-in."""
    per: Dict[int, List[Dict]] = {}
    for hb in heartbeats:
        per.setdefault(int(hb["worker"]), []).append(hb)
    out: Dict[int, float] = {}
    for worker, hbs in per.items():
        hbs.sort(key=lambda h: h["ts"])
        dt = hbs[-1]["ts"] - hbs[0]["ts"]
        served = hbs[-1]["events"] - hbs[0]["events"]
        out[worker] = served / dt if dt > 0 else float(hbs[-1]["events"])
    return out


# a worker whose last heartbeat is older than this many cadence
# intervals is DEAD, not merely slow — the liveness signal the ownership
# rebalancer consumes: its groups get reassigned and its
# un-acked ledger entries reclaimed by the new owners
DEAD_AFTER_FACTOR = 3.0


def worker_liveness(heartbeats: Sequence[Dict], cadence_s: float,
                    now: Optional[float] = None) -> Dict[int, Dict]:
    """Per-worker liveness from the heartbeat stream: latest heartbeat
    age against the expected cadence, ``dead=True`` past
    ``DEAD_AFTER_FACTOR`` (3x) cadence intervals —
    ``detect_stragglers`` flags slow workers, this flags gone ones.
    Returns ``{worker_id: {"last_ts", "age_s", "events", "dead"}}``."""
    t_now = time.time() if now is None else now
    latest: Dict[int, Dict] = {}
    for hb in heartbeats:
        worker = int(hb["worker"])
        cur = latest.get(worker)
        if cur is None or hb["ts"] >= cur["ts"]:
            latest[worker] = hb
    out: Dict[int, Dict] = {}
    for worker, hb in latest.items():
        age = max(t_now - hb["ts"], 0.0)
        out[worker] = {
            "last_ts": hb["ts"],
            "age_s": age,
            "events": hb.get("events", 0),
            "dead": age > DEAD_AFTER_FACTOR * cadence_s,
        }
    return out


def detect_stragglers(heartbeats: Sequence[Dict],
                      min_events_fraction: float = 0.5,
                      stale_after_s: Optional[float] = None,
                      now: Optional[float] = None,
                      latency_p99: Optional[Dict[int, float]] = None,
                      latency_factor: float = 3.0) -> List[int]:
    """Straggler = a worker whose LATEST heartbeat reports under
    ``min_events_fraction`` of the median worker's served events, or (with
    ``stale_after_s``) one whose last heartbeat is older than that — the
    dead-worker signal during a live run — or (with ``latency_p99``, the
    per-worker ``engine.decision_latency`` p99 from the shipped fleet
    reports) one whose p99 is >= ``latency_factor`` x the fleet median:
    the latency-percentile signal upgrades throughput-only
    detection with, which catches a worker that keeps up on COUNT while
    serving every event slowly (e.g. a degraded core — invisible to the
    event-fraction test until it finally falls behind). Returns sorted
    worker ids."""
    latest: Dict[int, Dict] = {}
    for hb in heartbeats:
        worker = int(hb["worker"])
        cur = latest.get(worker)
        if cur is None or hb["ts"] >= cur["ts"]:
            latest[worker] = hb
    flagged = set()
    if latest:
        counts = sorted(h["events"] for h in latest.values())
        median = counts[len(counts) // 2]
        for worker, hb in latest.items():
            if hb["events"] < min_events_fraction * median:
                flagged.add(worker)
            if stale_after_s is not None:
                t_now = time.time() if now is None else now
                if t_now - hb["ts"] > stale_after_s:
                    flagged.add(worker)
    if latency_p99:
        p99s = sorted(latency_p99.values())
        # LOWER median: the straggler sits ABOVE the threshold, so for
        # even fleets the upper-middle element would be the slow
        # worker's own p99 and `p99 >= k * itself` could never fire —
        # a 2-worker fleet (the most common deploy) would be blind
        median_p99 = p99s[(len(p99s) - 1) // 2]
        if median_p99 > 0:
            for worker, p99 in latency_p99.items():
                if p99 >= latency_factor * median_p99:
                    flagged.add(worker)
    return sorted(flagged)


def worker_latency_p99(worker_reports: Dict[int, Dict]) -> Dict[int, float]:
    """Per-worker ``engine.decision_latency`` p99 out of shipped fleet
    reports — the :func:`detect_stragglers` ``latency_p99`` input."""
    out: Dict[int, float] = {}
    for worker, report in worker_reports.items():
        snap = report.get("spans", {}).get("engine.decision_latency")
        if snap and snap.get("count"):
            out[worker] = float(snap.get("p99_ms", 0.0))
    return out


def _collect_worker(p: subprocess.Popen, timeout: float) -> Tuple[str, str]:
    """``communicate()`` with a hung-worker guard:
    a worker that outlives its budget is SIGKILLed and the failure
    carries whatever output it produced — a raw ``TimeoutExpired`` would
    leak the still-running process tree AND its diagnostics."""
    try:
        return p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # worker mode registers a SIGUSR1 faulthandler: ask the hung
        # worker for its stacks before killing it, so the failure says
        # WHERE it hung, not just that it did
        try:
            import signal as _sig
            p.send_signal(_sig.SIGUSR1)
            time.sleep(0.5)
        except Exception:
            pass
        p.kill()
        try:
            out, err = p.communicate(timeout=10)
        except Exception:
            out, err = "", ""
        raise RuntimeError(
            f"worker pid {p.pid} hung past {timeout:.0f}s and was "
            f"killed; partial stdout: {(out or '')[-500:]!r} "
            f"partial stderr: {(err or '')[-2000:]!r}")


class _StoppableQueues(RedisQueues):
    """Per-group queue view that retires on the driver's stop sentinel.
    Always runs with the ack/replay ledger armed: every pop is an atomic
    move into ``pendingQueue:<group>``, acked only after the answer is
    written — so a worker death between pop and answer leaves the event
    replayable instead of lost (the GenericSpout/GenericBolt ack
    bookkeeping, ReinforcementLearnerBolt.java:41).

    After a broker failover the lost sweep's ledger entries go back in
    their order, ahead of the stop sentinel: the JAX module's view requeues
    them newest first, so a requeued sentinel retired the view before them
    and a sentinel popped beside them left them behind it, both losses."""

    def __init__(self, client, group: str):
        super().__init__(event_queue=f"eventQueue:{group}",
                         action_queue="actionQueue",
                         reward_queue=f"rewardQueue:{group}",
                         pending_queue=f"pendingQueue:{group}",
                         client=client)
        self.stopped = False
        self._requeued = 0          # ledger entries a failover put back
        # shard-move deferral: while set, reward drains hold
        # until the OLD shard's reward queue is empty — see
        # hold_rewards_until_migrated
        self._migrating_from = None

    def hold_rewards_until_migrated(self, old_client) -> None:
        """Arm the shard-move reward hold: this view was re-bound to a
        new shard with its reward cursor carried over, but the carried
        cursor is only valid once the coordinator's migration has
        spliced the old queue's consumed prefix in at the tail. Until
        the old shard's reward queue reads empty, drains return nothing
        (one cheap LLEN probe per drain) — folding the new shard's
        fresh rewards through a pre-splice cursor would misread them
        and strand the tailmost ones forever. An unreachable old shard
        releases the hold (its entries are gone with it)."""
        self._migrating_from = old_client

    def drain_rewards(self, max_items=None):
        if self._migrating_from is not None:
            try:
                if int(self._migrating_from.llen(self.reward_queue)) > 0:
                    return []
            except Exception:
                pass               # old shard dead: nothing to wait for
            self._migrating_from = None
        return super().drain_rewards(max_items)

    def recover_in_flight(self) -> int:
        """The lost sweep's ledger entries back at the TAIL of the event
        queue, oldest popped served first: they were popped before every
        event still queued, and before the sentinel."""
        raws = self._r.lrange(self.pending_queue, 0, -1)   # newest first
        keep = collections.Counter(self._in_flight)
        n = 0
        for raw in raws:
            if keep[raw] > 0:
                keep[raw] -= 1
                continue
            # requeue before retiring the ledger copy: a crash between the
            # two leaves a duplicate, never a loss
            self._r.rpush(self.event_queue, raw)
            self._r.lrem(self.pending_queue, 1, raw)
            n += 1
        self._requeued += n
        return n

    def _retire(self, requeued_before: int) -> None:
        """The sentinel was popped: ack it, then retire the view, unless a
        failover in the same pop put events back, which the sentinel must
        follow again."""
        self.ack_event(STOP_SENTINEL)     # the sentinel needs no replay
        if self._requeued != requeued_before:
            self._r.lpush(self.event_queue, STOP_SENTINEL)
        else:
            self.stopped = True

    def pop_event(self) -> Optional[str]:
        if self.stopped:
            return None
        requeued = self._requeued
        event = super().pop_event()
        if event == STOP_SENTINEL:
            self._retire(requeued)
            return None
        return event

    def pop_events(self, max_n: int) -> List[str]:
        """Bulk pop with sentinel handling: the driver pushes the
        sentinel AFTER every event, so within one pipelined sweep it can
        only appear after the real events — truncate there, ack it, and
        retire the queue view."""
        if self.stopped:
            return []
        requeued = self._requeued
        events = super().pop_events(max_n)
        if STOP_SENTINEL in events:
            cut = events.index(STOP_SENTINEL)
            self._retire(requeued)
            events = events[:cut]
        return events

    def shed_events(self, max_n: int, newest: bool = False):
        """Admission shed with sentinel protection: a shed sweep that
        swallowed the stop sentinel would discard the retire signal and
        hang the group forever — push it back to the head (where the
        driver put it: after every real event) and shed only the rest."""
        if self.stopped:
            return []
        shed = super().shed_events(max_n, newest=newest)
        if STOP_SENTINEL in shed:
            shed = [e for e in shed if e != STOP_SENTINEL]
            self._r.lpush(self.event_queue, STOP_SENTINEL)
        return shed


def shuffle_worker_main(host: str, port: int, worker_id: int,
                        n_workers: int, groups: Sequence[str],
                        learner_type: str, actions: Sequence[str],
                        config: Dict, seed: int, replay: bool = False,
                        decision_io_ms: float = 0.0,
                        device: DeviceLike = "cuda") -> Dict:
    """The reference's ACTUAL grouping discipline
    (ReinforcementLearnerTopology.java:74 ``shuffleGrouping``): any worker
    may serve any event, and each worker keeps PRIVATE learners — safe in
    Storm only because bolt-local learner state is never shared, and
    replayed here faithfully: one shared event queue all workers pop
    (RPOPLPUSH into a per-WORKER pending ledger), one private learner per
    group per worker, and every worker drains EVERY group's reward queue
    with its own non-destructive cursor (the RedisRewardReader lindex
    walk — this is exactly why the reference reads rewards by cursor
    rather than popping). Weaker consistency than the fieldsGrouping-style
    ownership mode (`worker_main`): a group's selections come from N
    independently-exploring learners, each trained on the union reward
    stream but only its own 1/N of the selection feedback loop. Offered
    for contract parity; the ownership mode remains the default. The
    private learners live on ``device``."""
    from avenir_tpu_torch.models.bandits.learners import create
    dev = resolve_device(device)
    client = MiniRedisClient(host, port)
    pending = f"pendingQueue:shuffle:w{worker_id}"
    replayed = 0
    if replay:
        replayed = reclaim_pending(client, pending, "eventQueue")
    events_q = RedisQueues(event_queue="eventQueue",
                           action_queue="actionQueue",
                           client=client, pending_queue=pending)
    reward_q = {g: RedisQueues(reward_queue=f"rewardQueue:{g}",
                               client=client) for g in groups}
    learners = {
        g: create(learner_type, list(actions), dict(config),
                  seed=seed + 1000 * worker_id + i, device=dev)
        for i, g in enumerate(groups)}
    # self-warmup: run every private learner's select path once BEFORE
    # the pop loop. Fields mode warms through per-group warmup events,
    # but a shared queue cannot target workers: a fast worker could drain
    # every warmup event and leave a late worker's first launches and
    # lazily loaded modules inside the driver's timed window. The warm
    # draws are discarded (never written to a queue); each private
    # learner just starts its exploration one batch ahead.
    for lr in learners.values():
        lr.next_actions()
    events = rewards = 0
    push_heartbeat(client, worker_id, 0, 0, "shuffle")  # alive + warmed
    idle_sleep = 0.001
    while True:
        for g, q in reward_q.items():
            for action_id, reward in q.drain_rewards():
                learners[g].set_reward(action_id, reward)
                rewards += 1
        event_id = events_q.pop_event()
        if event_id is None:
            time.sleep(idle_sleep)
            idle_sleep = min(idle_sleep * 2, 0.016)
            continue
        idle_sleep = 0.001
        if event_id == STOP_SENTINEL:
            events_q.ack_event(event_id)
            break                 # driver pushes one sentinel per worker
        g = event_id.partition(":")[0]
        selections = learners[g].next_actions()
        events_q.write_actions(event_id, selections)
        events_q.ack_event(event_id)   # ack AFTER the answer, as always
        events += 1
        if events % HEARTBEAT_EVERY == 0:
            push_heartbeat(client, worker_id, events, rewards, "shuffle")
        if decision_io_ms > 0:
            time.sleep(decision_io_ms / 1e3)
    # final drain: rewards the driver pushed between this worker's last
    # in-loop drain and its sentinel must still reach the private
    # learners — the driver pushes all rewards before any sentinel, so
    # after this pass every worker has seen the full stream (drains are
    # bounded sweeps now, so loop each queue until empty)
    for g, q in reward_q.items():
        while True:
            batch = q.drain_rewards()
            if not batch:
                break
            for action_id, reward in batch:
                learners[g].set_reward(action_id, reward)
                rewards += 1
    push_heartbeat(client, worker_id, events, rewards, "shuffle")  # final
    client.close()
    return {"worker": worker_id, "events": events, "rewards": rewards,
            "replayed": replayed, "groups": sorted(groups),
            "grouping": "shuffle"}


def _heartbeat_buffer(client, host: str, port: int) -> HeartbeatBuffer:
    """The liveness-I/O buffer every worker main pushes heartbeats,
    telemetry and trace stamps through, flushing to the worker's broker."""
    endpoint = (getattr(client, "host", host),
                getattr(client, "port", port))
    return HeartbeatBuffer(lambda: endpoint)


def _lifecycle_client(lifecycle_dir: Optional[str]):
    """Registry subscription for a worker process: polled on the
    heartbeat-ish cadence, swapping every owned group's learner when a
    retrain wave publishes a new head. None when lifecycle is off."""
    if not lifecycle_dir:
        return None
    from avenir_tpu_torch.lifecycle.swap import LifecycleClient
    # from_version=0 replays the current head on the first poll, so a
    # worker joining after a publish starts on the published model
    return LifecycleClient(lifecycle_dir, from_version=0,
                           min_poll_interval_s=0.25)


def worker_main(host: str, port: int, worker_id: int, n_workers: int,
                groups: Sequence[str], learner_type: str,
                actions: Sequence[str], config: Dict, seed: int,
                replay: bool = False, decision_io_ms: float = 0.0,
                engine: bool = False,
                event_timestamps: bool = False,
                lifecycle_dir: Optional[str] = None,
                broker_reconnect: bool = False,
                brokers: Optional[str] = None,
                device: DeviceLike = "cuda") -> Dict:
    """One serving process: loops for the owned groups until every group's
    stop sentinel arrives. Returns per-worker stats. ``replay`` implements
    ``replay.failed.message=true``: on startup, un-acked events a dead
    predecessor left in this worker's groups' pending ledgers are pushed
    back onto their event queues and served again. ``decision_io_ms``
    simulates a blocking downstream call per served event (feature store,
    action delivery): the IO-bound serving regime where worker processes
    overlap their waits. ``engine=True`` swaps each group's per-event
    ``step()`` loop for the pipelined ``ServingEngine`` (bulk transport,
    dispatch-then-fetch; the ack/replay ledger contract is unchanged, just
    batch-granular), heartbeats included. ``lifecycle_dir`` subscribes
    the worker to a snapshot registry: polled on the heartbeat-ish
    cadence, a newly published learner-state snapshot swaps into every
    owned group's learner at its next step or batch boundary.
    ``broker_reconnect`` arms the failover transport: broker death
    surfaces as capped-backoff redials and at-least-once resends instead
    of a worker crash, and the queue layer reconciles its pending ledger
    after every reconnect. Every learner lives on ``device``.
    ``brokers`` (the JAX module's broker fleet) is refused."""
    if brokers:
        raise ValueError(
            f"worker_main(brokers=...) is not ported yet ({_REBALANCE}); "
            f"run one broker")
    dev = resolve_device(device)
    client = MiniRedisClient(host, port, reconnect=broker_reconnect,
                             reconnect_timeout=30.0)
    replayed = 0
    if replay:
        for g in owned_groups(groups, worker_id, n_workers):
            replayed += reclaim_pending(
                client, f"pendingQueue:{g}", f"eventQueue:{g}")
    lc = _lifecycle_client(lifecycle_dir)
    hb = _heartbeat_buffer(client, host, port)
    if engine:
        return _worker_main_engine(client, worker_id, n_workers, groups,
                                   learner_type, actions, config, seed,
                                   replayed, decision_io_ms,
                                   event_timestamps, lc, hb=hb, device=dev)
    loops = {}
    for g in owned_groups(groups, worker_id, n_workers):
        # per-group seed component: each group's learner must explore
        # independently (a shared seed correlates every group's RNG)
        loops[g] = OnlineLearnerLoop(
            learner_type, actions, dict(config),
            _StoppableQueues(client, g),
            seed=seed + 1000 * worker_id + list(groups).index(g),
            event_timestamps=event_timestamps, device=dev)
    if lc is not None:
        for g, loop in loops.items():
            lc.register(g, loop)
        lc.poll_and_swap()      # join on the published head, if any
    active = set(loops)
    idle_sleep = 0.001
    served_total = 0
    push_heartbeat(hb, worker_id, 0, 0)  # alive, loops constructed
    while active:
        if lc is not None:
            lc.poll_and_swap()   # throttled to the heartbeat-ish cadence
        progressed = False
        for g in list(active):
            loop = loops[g]
            if loop.queues.stopped:
                # reward drains are bounded sweeps now: fold whatever
                # backlog remains before retiring the group (the driver
                # pushes all rewards before any sentinel), else a >4096
                # backlog would be silently dropped at shutdown
                while True:
                    pairs = loop._drain_new_rewards()
                    if not pairs:
                        break
                    loop.learner.set_reward_batch(pairs)
                    loop.stats.rewards += len(pairs)
                active.discard(g)
                continue
            # one event per visit keeps groups fair; rewards drain inside
            served = loop.step()
            if served:
                served_total += 1
                if served_total % HEARTBEAT_EVERY == 0:
                    push_heartbeat(
                        hb, worker_id, served_total,
                        sum(l.stats.rewards for l in loops.values()))
                if decision_io_ms > 0:
                    time.sleep(decision_io_ms / 1e3)
            progressed = served or progressed
        if progressed:
            idle_sleep = 0.001
        elif active:
            # adaptive backoff: an idle worker must not convoy the broker
            # with poll round-trips (each visit costs 2 RTTs per group)
            time.sleep(idle_sleep)
            idle_sleep = min(idle_sleep * 2, 0.016)
    events_total = sum(l.stats.events for l in loops.values())
    rewards_total = sum(l.stats.rewards for l in loops.values())
    push_heartbeat(hb, worker_id, events_total, rewards_total)  # final
    hb.close()
    reconnects = client.reconnects
    client.close()
    return {
        "worker": worker_id,
        "events": events_total,
        "rewards": rewards_total,
        "replayed": replayed,
        "groups": sorted(loops),
        "heartbeats_dropped": hb.dropped,
        "broker_reconnects": reconnects,
    }


def _worker_main_engine(client, worker_id: int, n_workers: int,
                        groups: Sequence[str], learner_type: str,
                        actions: Sequence[str], config: Dict, seed: int,
                        replayed: int, decision_io_ms: float,
                        event_timestamps: bool = False,
                        lc=None, hb=None,
                        device: DeviceLike = "cuda") -> Dict:
    """Engine-mode worker body: one pipelined ``ServingEngine`` per owned
    group, its learner on ``device``, over the same stoppable per-group
    queues. Each visit drains the group's current backlog in one
    ``run()`` (pipelined micro-batches); heartbeats ride the engine's
    per-batch callback so a live driver still sees progress mid-drain."""
    from avenir_tpu_torch.stream.engine import ServingEngine
    dev = resolve_device(device)
    progress = {"served": 0, "hb_mark": 0}
    engines: Dict[str, ServingEngine] = {}
    if hb is None:
        hb = _heartbeat_buffer(client, client.host, client.port)

    def on_batch(n_events: int) -> None:
        progress["served"] += n_events
        if (progress["served"] - progress["hb_mark"]) >= HEARTBEAT_EVERY:
            progress["hb_mark"] = progress["served"]
            push_heartbeat(
                hb, worker_id, progress["served"],
                sum(e.stats.rewards for e in engines.values()))
        if decision_io_ms > 0:
            time.sleep(decision_io_ms * n_events / 1e3)

    for g in owned_groups(groups, worker_id, n_workers):
        engines[g] = ServingEngine(
            learner_type, actions, dict(config),
            _StoppableQueues(client, g),
            seed=seed + 1000 * worker_id + list(groups).index(g),
            on_batch=on_batch, event_timestamps=event_timestamps,
            device=dev)
    if lc is not None:
        for g, eng in engines.items():
            lc.register(g, eng)
        lc.poll_and_swap()      # join on the published head, if any
    # live health: /healthz answers ownership + the serving
    # model versions when this worker runs a scrape endpoint
    from avenir_tpu_torch.obs import live as _obs_live
    live_obs = _obs_live.current()
    if live_obs is not None:
        live_obs.set_health_provider(lambda: {
            "worker_id": worker_id,
            "groups": sorted(engines),
            "model_versions": {g: e.stats.model_version
                               for g, e in engines.items()},
            "events": progress["served"]})
    active = set(engines)
    idle_sleep = 0.001
    push_heartbeat(hb, worker_id, 0, 0)  # alive, engines constructed
    while active:
        if lc is not None:
            # between run() calls every engine is at a batch boundary;
            # the client throttles itself to the heartbeat-ish cadence
            lc.poll_and_swap()
        progressed = False
        for g in list(active):
            eng = engines[g]
            if eng.queues.stopped:
                active.discard(g)
                continue
            before = eng.stats.events
            eng.run()          # drains this group's current backlog
            progressed = eng.stats.events > before or progressed
        if progressed:
            idle_sleep = 0.001
        elif active:
            time.sleep(idle_sleep)
            idle_sleep = min(idle_sleep * 2, 0.016)
    events_total = sum(e.stats.events for e in engines.values())
    rewards_total = sum(e.stats.rewards for e in engines.values())
    push_heartbeat(hb, worker_id, events_total, rewards_total)  # final
    hb.close()
    reconnects = client.reconnects
    client.close()
    return {
        "worker": worker_id,
        "events": events_total,
        "rewards": rewards_total,
        "replayed": replayed,
        "groups": sorted(engines),
        "engine": True,
        "heartbeats_dropped": hb.dropped,
        "broker_reconnects": reconnects,
    }


@dataclass
class ScaleoutResult:
    n_workers: int
    throughput_events: int
    decisions_per_sec: float
    paced_events: int
    p50_latency_ms: float
    p90_latency_ms: float
    best_action_fraction: float   # last-30% convergence onto planted arms
    worker_stats: List[Dict] = field(default_factory=list)
    # heartbeat-derived: per-worker events/sec over each
    # worker's own heartbeat interval, and the workers flagged by
    # detect_stragglers on the final heartbeat set
    worker_throughput: Dict[int, float] = field(default_factory=dict)
    stragglers: List[int] = field(default_factory=list)
    heartbeats: int = 0
    # fleet telemetry: per-worker latest reports shipped over
    # the broker, and their merge_reports fold — the thing --metrics-out
    # writes. Both empty unless the run was telemetry-armed.
    worker_reports: Dict[int, Dict] = field(default_factory=dict)
    fleet_report: Optional[Dict] = None
    # sampled cross-process tracing: stamp count collected
    # across driver + workers and the Chrome-trace path written, when
    # the run was trace-armed
    trace_stamps: int = 0
    trace_out: Optional[str] = None
    # the port's own: each worker's seconds from spawn to its first
    # heartbeat (process start, imports, its learners built on the
    # device: on a card, the CUDA context)
    worker_start_s: Dict[int, float] = field(default_factory=dict)


# the broker's own module file, run as a script: it imports nothing of the
# package, where ``python -m`` would import torch through the package's
# ``__init__`` before the broker listens
_BROKER_SCRIPT = str(Path(__file__).with_name("miniredis.py"))
BROKER_START_S = 60.0


def _start_broker(host: str):
    """A broker subprocess on a port it binds itself, once it listens:
    (process, port, its stderr file). A broker that exits first, or does
    not listen within ``BROKER_START_S``, fails the run with its stderr."""
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, _BROKER_SCRIPT, "--host", host, "--port", "0"],
        stdout=subprocess.PIPE, stderr=err, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], BROKER_START_S)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("miniredis listening "):
        exited = proc.poll()
        proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
        err.seek(0)
        why = (f"exited with code {exited}" if exited is not None else
               f"did not listen in {BROKER_START_S:.0f} s")
        message = err.read()[-1500:]
        err.close()
        raise RuntimeError(f"the broker subprocess {why}: {message!r}")
    return proc, int(line.rsplit(":", 1)[1]), err


@contextlib.contextmanager
def _broker(host: str, server: Optional[MiniRedisServer] = None):
    """Yield a flushed client to a RESP broker: the given in-process
    ``server`` (e.g. a real/external one for tests), else a fresh broker
    SUBPROCESS — its connection threads must not share the driver's GIL
    (an in-process ThreadingTCPServer makes every added worker steal
    driver cycles). Yields (client, host, port)."""
    broker_proc = err = None
    if server is None:
        broker_proc, port, err = _start_broker(host)
    else:
        host, port = server.host, server.port
    try:
        client = connect_with_retry(host, port)
        client.flushall()
        yield client, host, port
    finally:
        if broker_proc is not None:
            broker_proc.terminate()
            broker_proc.wait(timeout=10)
            broker_proc.stdout.close()
            err.close()


# the directory that holds the avenir_tpu_torch package
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def _spawn_worker(host: str, port: int, worker_id: int, n_workers: int,
                  groups: Sequence[str], learner_type: str,
                  actions: Sequence[str], config: Dict, seed: int,
                  replay: bool = False, decision_io_ms: float = 0.0,
                  grouping: str = "fields",
                  engine: bool = False, telemetry: bool = False,
                  event_timestamps: bool = False,
                  lifecycle_dir: Optional[str] = None,
                  trace: bool = False,
                  device: DeviceLike = "cuda") -> subprocess.Popen:
    """One worker subprocess, its learners on ``device``. The package's
    root goes first on its ``PYTHONPATH``, so a driver run from any
    directory spawns workers of the same tree."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    cmd = [sys.executable, "-m", "avenir_tpu_torch.stream.scaleout",
           "--worker", "--host", host, "--port", str(port),
           "--worker-id", str(worker_id),
           "--n-workers", str(n_workers), "--groups", ",".join(groups),
           "--learner-type", learner_type, "--actions", ",".join(actions),
           "--config", json.dumps(config), "--seed", str(seed),
           "--decision-io-ms", str(decision_io_ms),
           "--grouping", grouping, "--device", str(device)]
    if replay:
        cmd.append("--replay")
    if engine:
        cmd.append("--engine")
    if telemetry:
        cmd.append("--telemetry")
    if event_timestamps:
        cmd.append("--event-timestamps")
    if lifecycle_dir:
        cmd += ["--lifecycle-dir", lifecycle_dir]
    if trace:
        cmd.append("--trace")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _spawn_workers(host: str, port: int, n_workers: int,
                   groups: Sequence[str], learner_type: str,
                   actions: Sequence[str], config: Dict, seed: int,
                   decision_io_ms: float = 0.0,
                   grouping: str = "fields",
                   engine: bool = False, telemetry: bool = False,
                   event_timestamps: bool = False,
                   lifecycle_dir: Optional[str] = None,
                   trace: bool = False,
                   device: DeviceLike = "cuda"
                   ) -> List[subprocess.Popen]:
    return [_spawn_worker(host, port, w, n_workers, groups, learner_type,
                          actions, config, seed,
                          decision_io_ms=decision_io_ms, grouping=grouping,
                          engine=engine, telemetry=telemetry,
                          event_timestamps=event_timestamps,
                          lifecycle_dir=lifecycle_dir,
                          trace=trace, device=device)
            for w in range(n_workers)]


def _await_first_heartbeats(client, procs: Sequence[subprocess.Popen],
                           spawned_at: float,
                           timeout_s: float = 180.0) -> Dict[int, float]:
    """Wait until every worker has pushed its first heartbeat (read in
    place: the queue is drained after the run) and return each worker's
    seconds from ``spawned_at`` to it. A worker that exits first fails
    the run with its stderr, instead of the warmup waiting for answers
    that never come."""
    start: Dict[int, float] = {}
    deadline = time.monotonic() + timeout_s
    while len(start) < len(procs):
        for raw in client.lrange(HEARTBEAT_QUEUE, 0, -1):
            hb = json.loads(raw.decode())
            w = int(hb["worker"])
            start[w] = min(start.get(w, math.inf), hb["ts"] - spawned_at)
        for w, p in enumerate(procs):
            if w not in start and p.poll() is not None:
                _, err = p.communicate()
                raise RuntimeError(f"worker {w} exited before its first "
                                   f"heartbeat: {err[-1500:]}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"only workers {sorted(start)} of "
                               f"{len(procs)} started in {timeout_s:.0f}s")
        time.sleep(0.01)
    return start


def _consume_one(client: MiniRedisClient, ctr, rng, t_push,
                 latencies: List[float],
                 picks: List[Tuple[str, str]],
                 trace_map: Optional[Dict[str, str]] = None) -> bool:
    """Pop one action line, record latency/pick, issue the planted-CTR
    reward. False when the action queue is empty. A traced event's
    reward (``trace_map``) carries the trace id in its value
    field so the owning worker's fold closes the loop with a
    ``reward_fold`` stamp."""
    raw = client.rpop("actionQueue")
    if raw is None:
        return False
    event_id, _, action = raw.decode().partition(",")
    action = action.split(",")[0]
    g = event_id.partition(":")[0]
    latencies.append(time.perf_counter() - t_push[event_id])
    picks.append((g, action))
    reward = 1.0 if rng.random() < ctr[g][action] else 0.0
    value = str(reward)
    if trace_map is not None:
        tid = trace_map.pop(event_id, None)
        if tid is not None:
            from avenir_tpu_torch.obs import tracing as _tracing
            value = _tracing.attach_reward_trace(value, tid)
    client.lpush(f"rewardQueue:{g}", f"{action},{value}")
    return True


def _drive(client: MiniRedisClient, groups: Sequence[str],
           ctr: Dict[str, Dict[str, float]], n_events: int,
           rate: Optional[float], rng, t_push: Dict[str, float],
           latencies: List[float], picks: List[Tuple[str, str]],
           shuffle: bool = False, stamp: bool = False,
           trace_map: Optional[Dict[str, str]] = None) -> None:
    """Throughput mode (``rate=None``): BURST all events up-front so every
    group carries backlog and worker parallelism — not this driver's serial
    reward loop — sets the drain time. Paced mode: inject at ``rate``/s and
    consume as answers arrive, measuring per-event serving latency.
    ``shuffle`` pushes every event onto the single shared ``eventQueue``
    (the shuffleGrouping spout) instead of the per-group queues. ``stamp``
    appends an enqueue timestamp (``id|ts``, the event.timestamps contract)
    so telemetry-armed workers measure true queue wait; workers write
    actions under the bare id, so ``t_push``/answer bookkeeping is
    unchanged. ``trace_map`` (requires ``stamp``) additionally
    promotes 1-in-N events to ``id|ts|traceid`` — the sampling decision
    lives in the process-wide :class:`~avenir_tpu_torch.obs.tracing.
    TraceContext` — stamping ``producer_enqueue`` and remembering the id
    so the event's reward carries the same trace."""
    from avenir_tpu_torch.obs import tracing as _tracing

    def push(sent):
        g = groups[sent % len(groups)]
        event_id = f"{g}:{sent}"
        t_push[event_id] = time.perf_counter()
        payload = event_id
        if stamp:
            now = time.time()
            payload = f"{event_id}|{now}"
            if trace_map is not None:
                tid = _tracing.context().maybe_start()
                if tid is not None:
                    payload = f"{payload}|{tid}"
                    trace_map[event_id] = tid
                    _tracing.context().record(tid, "producer_enqueue",
                                              ts=now)
        client.lpush("eventQueue" if shuffle else f"eventQueue:{g}",
                     payload)
    if rate is None:
        for sent in range(n_events):
            push(sent)
        answered = 0
        while answered < n_events:
            if _consume_one(client, ctr, rng, t_push, latencies, picks,
                            trace_map):
                answered += 1
            else:
                time.sleep(0.0005)
        return
    sent = answered = 0
    next_at = time.perf_counter()
    while answered < n_events:
        if sent < n_events and time.perf_counter() >= next_at:
            # schedule the next slot BEFORE the lpush so the broker RTT
            # does not silently shave the injection rate
            next_at = time.perf_counter() + 1.0 / rate
            push(sent)
            sent += 1
        if not _consume_one(client, ctr, rng, t_push, latencies, picks,
                            trace_map):
            time.sleep(0.0005)
        else:
            answered += 1


def run_scaleout(n_workers: int, *, n_groups: int = 8, n_actions: int = 4,
                 throughput_events: int = 1000, paced_events: int = 200,
                 paced_rate: float = 100.0, learner_type: str = "softMax",
                 seed: int = 7, host: str = "localhost",
                 server: Optional[MiniRedisServer] = None,
                 decision_io_ms: float = 0.0,
                 grouping: str = "fields",
                 engine: bool = False,
                 metrics_out: Optional[str] = None,
                 event_timestamps: bool = False,
                 lifecycle_dir: Optional[str] = None,
                 trace_out: Optional[str] = None,
                 trace_sample: int = 64,
                 device: DeviceLike = "cuda",
                 on_workers_up: Optional[
                     Callable[[Dict[int, float]], None]] = None
                 ) -> ScaleoutResult:
    """Measure N serving workers against one broker (started here unless
    passed in). Every event must come back answered exactly once.
    ``grouping="shuffle"`` runs the reference's shuffleGrouping discipline
    (shared event queue, private per-worker learners — see
    :func:`shuffle_worker_main`) instead of per-group ownership.
    ``engine=True`` runs the workers on the pipelined ``ServingEngine``
    path (fields grouping only). ``metrics_out`` arms worker telemetry:
    every worker ships its obs report over the broker on the heartbeat
    cadence and the merged FLEET report (one file, attributable per
    source) lands at that path as JSONL + ``.prom`` — plus in
    ``ScaleoutResult.fleet_report``/``worker_reports``. Straggler
    detection then also uses per-worker decision-latency p99.
    ``event_timestamps`` stamps every driven event ``id|ts`` so workers
    measure true enqueue→pop queue wait (fields grouping only).
    ``trace_out`` arms sampled cross-process tracing: 1 in
    ``trace_sample`` events travels as ``id|ts|traceid`` (implies
    ``event_timestamps``), its reward echoes the trace id, workers ship
    their producer/broker-pop/dispatch/resolve/reward-fold stamps over
    the broker on the heartbeat cadence, and the merged Chrome-trace
    JSON (Perfetto-viewable) lands at that path. Every worker builds its
    learners on ``device``; the driver waits for each worker's first
    heartbeat (its learners built) before it drives, records the seconds
    from spawn to it in ``ScaleoutResult.worker_start_s``, and calls
    ``on_workers_up`` with them, while every worker is still alive."""
    worker_device = device_type(device)
    _require(n_workers >= 1, f"need >= 1 worker, got {n_workers}")
    _require(n_groups >= 1, f"need >= 1 group, got {n_groups}")
    _require(throughput_events >= 0 and paced_events >= 0,
             "event counts must be non-negative")
    _require(paced_rate > 0, f"paced_rate must be positive, "
                             f"got {paced_rate}")
    if engine and grouping == "shuffle":
        raise ValueError("engine workers support fields grouping only")
    if trace_out:
        event_timestamps = True     # traces ride the stamped payloads
    if event_timestamps and grouping == "shuffle":
        raise ValueError(
            "event.timestamps is wired through the fields-grouping "
            "loops/engines; shuffle workers do not parse stamped payloads")
    shuffle = grouping == "shuffle"
    trace_map: Optional[Dict[str, str]] = None
    if trace_out:
        from avenir_tpu_torch.obs import tracing as _tracing
        _tracing.context().enable(sample_every=trace_sample)
        trace_map = {}
    try:
        return _run_scaleout_measured(
            n_workers, n_groups=n_groups, n_actions=n_actions,
            throughput_events=throughput_events,
            paced_events=paced_events, paced_rate=paced_rate,
            learner_type=learner_type, seed=seed, host=host,
            server=server, decision_io_ms=decision_io_ms,
            grouping=grouping, engine=engine, metrics_out=metrics_out,
            event_timestamps=event_timestamps,
            lifecycle_dir=lifecycle_dir, trace_out=trace_out,
            trace_map=trace_map, shuffle=shuffle, device=worker_device,
            on_workers_up=on_workers_up)
    finally:
        if trace_out:
            # a failed run must not leak enabled tracing (or its stale
            # stamps) into the process's next traced run
            from avenir_tpu_torch.obs import tracing as _tracing
            _tracing.context().disable()
            _tracing.context().drain()


def _run_scaleout_measured(n_workers, *, n_groups, n_actions,
                           throughput_events, paced_events, paced_rate,
                           learner_type, seed, host, server,
                           decision_io_ms, grouping, engine, metrics_out,
                           event_timestamps, lifecycle_dir, trace_out,
                           trace_map, shuffle, device,
                           on_workers_up) -> ScaleoutResult:
    import numpy as np
    rng = np.random.default_rng(seed)
    groups = [f"g{i}" for i in range(n_groups)]
    actions = [f"a{i}" for i in range(n_actions)]
    # planted: one clearly-best arm per group (the lead_gen.py shape)
    ctr = {}
    for g in groups:
        best = int(rng.integers(n_actions))
        ctr[g] = {a: (0.8 if i == best else 0.15)
                  for i, a in enumerate(actions)}
    # batch.size=8: each event asks for 8 ranked selections (the
    # nextActions() batch contract, ReinforcementLearner.java:86-91) —
    # and makes the per-event learner work heavy enough that worker
    # parallelism, not the driver's serial reward loop, sets throughput
    config = {"current.decision.round": 1, "batch.size": 8}

    with _broker(host, server) as (client, broker_host, broker_port):
        if trace_out:
            # a shared (or AOF-restored) broker may still hold stamps a
            # prior failed traced run's workers flushed; they must not
            # merge into this run's trace file
            from avenir_tpu_torch.obs import tracing as _tracing
            _tracing.read_stamps(client)
        spawned_at = time.time()
        procs = _spawn_workers(broker_host, broker_port, n_workers, groups,
                               learner_type, actions, config, seed,
                               decision_io_ms=decision_io_ms,
                               grouping=grouping, engine=engine,
                               telemetry=metrics_out is not None,
                               event_timestamps=event_timestamps,
                               lifecycle_dir=lifecycle_dir,
                               trace=trace_out is not None, device=device)
        try:
            start_s = _await_first_heartbeats(client, procs, spawned_at)
            if on_workers_up is not None:
                on_workers_up(dict(start_s))
            t_push: Dict[str, float] = {}
            latencies: List[float] = []
            picks: List[Tuple[str, str]] = []
            # warmup: a worker's first events pay its first launches and
            # lazily loaded modules; excluded from latencies AND from
            # tracing — a sampled warmup event would ship its inflated
            # dispatch→resolve gap to Perfetto as if it were
            # representative serving latency
            _drive(client, groups, ctr, 4 * n_groups, None, rng,
                   t_push, [], [], shuffle=shuffle,
                   stamp=event_timestamps, trace_map=None)
            t_push.clear()

            t0 = time.perf_counter()
            _drive(client, groups, ctr, throughput_events, None, rng,
                   t_push, [], picks, shuffle=shuffle,
                   stamp=event_timestamps, trace_map=trace_map)
            throughput_s = time.perf_counter() - t0

            t_push.clear()
            _drive(client, groups, ctr, paced_events, paced_rate, rng,
                   t_push, latencies, picks, shuffle=shuffle,
                   stamp=event_timestamps, trace_map=trace_map)

            if shuffle:
                # one sentinel per worker on the shared queue
                for _ in range(n_workers):
                    client.lpush("eventQueue", STOP_SENTINEL)
            else:
                for g in groups:
                    client.lpush(f"eventQueue:{g}", STOP_SENTINEL)
            worker_stats = []
            for p in procs:
                out, err = _collect_worker(p, timeout=120)
                if p.returncode != 0:
                    raise RuntimeError(f"worker failed: {err[-1500:]}")
                worker_stats.append(json.loads(out.splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        total = sum(w["events"] for w in worker_stats)
        expected = 4 * n_groups + throughput_events + paced_events
        if total != expected:      # exactly-once delivery is the contract
            raise RuntimeError(
                f"workers answered {total} events, expected {expected}")
        # the ack ledger must retire every entry on the happy path
        if shuffle:
            left = sum(client.llen(f"pendingQueue:shuffle:w{w}")
                       for w in range(n_workers))
        else:
            left = sum(client.llen(f"pendingQueue:{g}") for g in groups)
        if left:
            raise RuntimeError(f"{left} un-acked ledger entries left behind")

        heartbeats = read_heartbeats(client)

        # fleet telemetry: each worker's LATEST shipped report, merged
        # into one attributable fleet report and written atomically
        worker_reports = read_worker_reports(client)
        fleet_report = None
        if worker_reports:
            from avenir_tpu_torch.obs import exporters as obs_exporters
            fleet_report = obs_exporters.merge_reports(
                [worker_reports[w] for w in sorted(worker_reports)])
            if metrics_out:
                obs_exporters.write_report(fleet_report, metrics_out)
        latency_p99 = worker_latency_p99(worker_reports)

        # sampled traces: driver stamps + every worker's shipped stamps,
        # merged into one Perfetto-viewable Chrome-trace file
        n_stamps = 0
        if trace_out:
            from avenir_tpu_torch.obs import tracing as _tracing
            stamps = _tracing.context().drain()
            stamps.extend(_tracing.read_stamps(client))
            _tracing.write_chrome_trace(stamps, trace_out)
            n_stamps = len(stamps)

        tail = picks[-int(0.3 * len(picks)):]
        best_frac = sum(ctr[g][a] > 0.5 for g, a in tail) / max(len(tail), 1)
        lat = sorted(latencies)
        return ScaleoutResult(
            n_workers=n_workers,
            throughput_events=throughput_events,
            decisions_per_sec=throughput_events / throughput_s,
            paced_events=paced_events,
            p50_latency_ms=1e3 * lat[len(lat) // 2] if lat else 0.0,
            p90_latency_ms=1e3 * lat[int(0.9 * len(lat))] if lat else 0.0,
            best_action_fraction=best_frac,
            worker_stats=worker_stats,
            worker_throughput=worker_throughput(heartbeats),
            stragglers=detect_stragglers(heartbeats,
                                         latency_p99=latency_p99 or None),
            heartbeats=len(heartbeats),
            worker_reports=worker_reports,
            fleet_report=fleet_report,
            trace_stamps=n_stamps,
            trace_out=trace_out if trace_out else None,
            worker_start_s=start_s)


@dataclass
class ChaosResult:
    n_events: int
    unique_answered: int          # after driver-side dedup by event id
    duplicates: int               # answers replay served a second time
    replayed: int                 # ledger entries the replacement reclaimed
    pending_left: int             # un-acked ledger entries at the end
    killed_at: int                # unique answers when SIGKILL was sent
    worker_stats: List[Dict] = field(default_factory=list)


def run_chaos(n_workers: int = 2, *, n_groups: int = 4, n_actions: int = 4,
              n_events: int = 400, kill_after: int = 100,
              learner_type: str = "softMax", seed: int = 13,
              host: str = "localhost", timeout_s: float = 120.0,
              server: Optional[MiniRedisServer] = None,
              engine: bool = False,
              device: DeviceLike = "cuda") -> ChaosResult:
    """Failure-injection run: SIGKILL one worker mid-stream, respawn it
    with ``replay.failed.message=true`` semantics, and verify NO event is
    lost. The kill window can leave answered-but-unacked events, which the
    replacement serves again — at-least-once delivery, exactly Storm's
    ack/replay guarantee — so the driver deduplicates answers by event id;
    after dedup every one of ``n_events`` events is answered exactly once
    (asserted by the chaos test). ``engine=True`` runs the pipelined
    workers: the answered-but-unacked crash window widens to a full
    micro-batch (write and ack are batch-granular), so duplicates bound
    at ~batch size per killed worker instead of ~1 — still at-least-once,
    still exactly-once after dedup. Every worker, the replacement too,
    builds its learners on ``device``."""
    import numpy as np
    import signal as _signal
    worker_device = device_type(device)
    _require(n_workers >= 1, f"need >= 1 worker, got {n_workers}")
    _require(n_groups >= 1, f"need >= 1 group, got {n_groups}")
    _require(0 < kill_after < n_events,
             f"kill_after={kill_after} must fire inside the stream "
             f"(0 < kill_after < n_events={n_events})")
    rng = np.random.default_rng(seed)
    groups = [f"g{i}" for i in range(n_groups)]
    actions = [f"a{i}" for i in range(n_actions)]
    ctr = {g: {a: (0.8 if i == int(rng.integers(n_actions)) else 0.15)
               for i, a in enumerate(actions)} for g in groups}
    config = {"current.decision.round": 1, "batch.size": 4}

    procs: List[subprocess.Popen] = []
    try:
        with _broker(host, server) as (client, host, broker_port):
            procs = _spawn_workers(host, broker_port, n_workers, groups,
                                   learner_type, actions, config, seed,
                                   engine=engine, device=worker_device)
            for sent in range(n_events):
                g = groups[sent % len(groups)]
                client.lpush(f"eventQueue:{g}", f"{g}:{sent}")

            answered: set = set()
            duplicates = 0
            killed_at = -1
            deadline = time.monotonic() + timeout_s
            while len(answered) < n_events:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"chaos run stalled: {len(answered)}/{n_events} "
                        f"answered, {duplicates} duplicates")
                raw = client.rpop("actionQueue")
                if raw is None:
                    # the kill itself can race the last pops; nudge the loop
                    time.sleep(0.001)
                else:
                    event_id, _, action = raw.decode().partition(",")
                    action = action.split(",")[0]
                    g = event_id.partition(":")[0]
                    if event_id in answered:
                        duplicates += 1  # replayed answer: dedup, no reward
                    else:
                        answered.add(event_id)
                        reward = (1.0 if rng.random() < ctr[g][action]
                                  else 0.0)
                        client.lpush(f"rewardQueue:{g}", f"{action},{reward}")
                if killed_at < 0 and len(answered) >= kill_after:
                    # SIGKILL (not terminate): the worker must get NO chance
                    # to ack or clean up — the crash the ledger exists for
                    killed_at = len(answered)
                    procs[0].send_signal(_signal.SIGKILL)
                    procs[0].wait(timeout=30)
                    procs[0].stdout.close()
                    procs[0].stderr.close()
                    procs[0] = _spawn_worker(
                        host, broker_port, 0, n_workers, groups,
                        learner_type, actions, config, seed + 999,
                        replay=True, engine=engine, device=worker_device)

            for g in groups:
                client.lpush(f"eventQueue:{g}", STOP_SENTINEL)
            worker_stats = []
            for p in procs:
                out, err = _collect_worker(p, timeout=60)
                if p.returncode != 0:
                    raise RuntimeError(f"worker failed: {err[-1500:]}")
                worker_stats.append(json.loads(out.splitlines()[-1]))
            pending_left = sum(client.llen(f"pendingQueue:{g}")
                               for g in groups)
            return ChaosResult(
                n_events=n_events, unique_answered=len(answered),
                duplicates=duplicates,
                replayed=sum(w.get("replayed", 0) for w in worker_stats),
                pending_left=pending_left, killed_at=killed_at,
                worker_stats=worker_stats)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _require(cond: bool, msg: str) -> None:
    """Harness precondition: a topology that cannot
    support the scenario fails in microseconds with a clear ValueError,
    never minutes later with a stall, an IndexError mid-chaos, or a
    kill mark that silently never fires."""
    if not cond:
        raise ValueError(msg)


# the JAX module's flags for the elastic half, refused until it is ported
_REFUSED_FLAGS = ("brokers", "elastic", "handoff_dir", "fleet_engine",
                  "coordinator")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int)
    ap.add_argument("--worker-id", type=int)
    ap.add_argument("--n-workers", type=int, default=2)
    ap.add_argument("--groups", default="")
    ap.add_argument("--learner-type", default="softMax")
    ap.add_argument("--actions", default="")
    ap.add_argument("--config", default="{}")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every worker's learners live (default "
                         "cuda; each worker opens its own CUDA context)")
    ap.add_argument("--replay", action="store_true",
                    help="worker mode: reclaim un-acked pending events on "
                         "startup (replay.failed.message=true)")
    ap.add_argument("--sweep", default="1,2,4",
                    help="driver mode: worker counts to measure")
    ap.add_argument("--events", type=int, default=1000)
    ap.add_argument("--decision-io-ms", type=float, default=0.0,
                    help="simulated blocking IO per served event: the "
                         "regime where workers scale even on one core")
    ap.add_argument("--grouping", default="fields",
                    choices=("fields", "shuffle"),
                    help="fields = per-group ownership (default, stronger "
                         "semantics); shuffle = the reference's "
                         "shuffleGrouping with private per-worker learners")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the pipelined ServingEngine "
                         "(bulk transport + dispatch-then-fetch) instead "
                         "of the per-event step loop (fields grouping)")
    ap.add_argument("--telemetry", action="store_true",
                    help="worker mode: arm the obs TelemetryHub and ship "
                         "this worker's report over the broker on the "
                         "heartbeat cadence (the fleet-merge input)")
    ap.add_argument("--event-timestamps", action="store_true",
                    help="events carry id|enqueue_ts payloads: measure "
                         "true queue wait into engine.queue_wait "
                         "(fields grouping)")
    ap.add_argument("--lifecycle-dir", default=None, metavar="PATH",
                    help="subscribe to the snapshot registry at PATH: "
                         "workers hot-swap newly published learner-state "
                         "snapshots at batch boundaries, polled on the "
                         "heartbeat cadence (fields grouping)")
    ap.add_argument("--broker-reconnect", action="store_true",
                    help="worker mode: survive broker restarts — redial "
                         "with capped backoff + jitter, resend in-flight "
                         "sweeps, reconcile the pending ledger")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="driver mode: arm worker telemetry and write the "
                         "merged FLEET report (JSONL + .prom) here")
    ap.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="worker mode: serve live /metrics, "
                         "/metrics/rates and /healthz on PORT (0 = "
                         "auto-assign; the bound port is printed as a "
                         "JSON line so harnesses can find it)")
    ap.add_argument("--obs-flight", default=None, metavar="PATH",
                    help="worker mode: arm the flight recorder — the "
                         "live metrics ring dumps to PATH on crash, "
                         "SIGUSR2, or SLO breach")
    ap.add_argument("--obs-slo-ms", type=float, default=None,
                    help="worker mode: flight-dump when a window's "
                         "engine.decision_latency p99 crosses this bar")
    ap.add_argument("--trace", action="store_true",
                    help="worker mode: record broker-pop/dispatch/"
                         "resolve/reward-fold stamps for trace-carrying "
                         "payloads (id|ts|traceid) and ship them over "
                         "the broker on the heartbeat cadence")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="driver mode: sample 1-in-N events into a "
                         "cross-process trace and write the merged "
                         "Chrome-trace JSON (Perfetto-viewable) here")
    ap.add_argument("--trace-sample", type=int, default=64,
                    help="driver mode: trace every Nth event "
                         "(default 64)")
    # the elastic half's flags: parsed so that they are refused by name
    for flag in _REFUSED_FLAGS:
        name = "--" + flag.replace("_", "-")
        if flag in ("brokers", "handoff_dir"):
            ap.add_argument(name, default=None, help=argparse.SUPPRESS)
        else:
            ap.add_argument(name, action="store_true",
                            help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in _REFUSED_FLAGS:
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet "
                     f"({_REBALANCE}); run the workers on one broker")

    if args.worker:
        # stuck-worker debugging: SIGUSR1 dumps every thread's stack to
        # stderr (the driver captures it), without killing the worker
        import faulthandler
        import signal as _sig
        faulthandler.register(_sig.SIGUSR1, all_threads=True)
        if args.telemetry:
            # arm the full obs layer BEFORE the loops are built so every
            # span/gauge of this worker's lifetime lands in the shipped
            # report; worker_id in meta keeps the fleet merge attributable
            from avenir_tpu_torch.obs import exporters as obs_exporters
            obs_exporters.hub().enable().set_meta(worker_id=args.worker_id)
        live_obs = None
        if args.obs_port is not None or args.obs_flight:
            # the live half: metrics pump + optional scrape
            # endpoint + optional flight recorder, armed before serving
            # so the first window covers the warmup. The bound port is
            # printed as its own JSON line (stdout is line-JSON already;
            # drivers parse the LAST line for stats) so a harness can
            # curl a port-0 auto-assigned endpoint mid-run.
            from avenir_tpu_torch.obs.live import start_live_obs
            wid = args.worker_id
            # alerting rides along: the declared default
            # SLOs evaluated per window, transitions logged beside the
            # flight file (<base>.alerts.jsonl), /alerts + healthz
            # degradation live on the same scrape port
            alerts_path = None
            if args.obs_flight:
                base = re.sub(r"\.flight\.jsonl$", "", args.obs_flight)
                alerts_path = base + ".alerts.jsonl"
            live_obs = start_live_obs(
                port=args.obs_port, flight_path=args.obs_flight,
                slo_p99_ms=args.obs_slo_ms,
                health_provider=lambda: {"worker_id": wid},
                alerts=True, alerts_path=alerts_path,
                alert_source=f"w{wid}")
            if live_obs.port is not None:
                print(json.dumps({"worker": args.worker_id,
                                  "obs_port": live_obs.port}), flush=True)
        if args.trace:
            from avenir_tpu_torch.obs import tracing as obs_tracing
            obs_tracing.context().enable()
        if args.grouping == "shuffle":
            stats = shuffle_worker_main(
                args.host, args.port, args.worker_id,
                args.n_workers, args.groups.split(","),
                args.learner_type, args.actions.split(","),
                json.loads(args.config), args.seed,
                replay=args.replay,
                decision_io_ms=args.decision_io_ms,
                device=args.device)
        else:
            stats = worker_main(
                args.host, args.port, args.worker_id,
                args.n_workers, args.groups.split(","),
                args.learner_type, args.actions.split(","),
                json.loads(args.config), args.seed,
                replay=args.replay,
                decision_io_ms=args.decision_io_ms,
                engine=args.engine,
                event_timestamps=args.event_timestamps,
                lifecycle_dir=args.lifecycle_dir,
                broker_reconnect=args.broker_reconnect,
                device=args.device)
        if live_obs is not None:
            stats["obs_port"] = live_obs.port
            if live_obs.alerts is not None:
                # end-of-run health beside the perf stats: firing/
                # pending counts + any page names this run produced
                stats["alerts"] = live_obs.alerts.brief()
            live_obs.stop()
        from avenir_tpu_torch.stream import faultnet as _faultnet
        injector = _faultnet.from_env()
        if injector is not None:
            # the soak gate needs proof faults actually hit the workers
            stats["faults_injected"] = sum(injector.injected.values())
        print(json.dumps(stats), flush=True)
        return 0

    for n in [int(v) for v in args.sweep.split(",")]:
        r = run_scaleout(n, throughput_events=args.events,
                         learner_type=args.learner_type,
                         decision_io_ms=args.decision_io_ms,
                         grouping=args.grouping,
                         engine=args.engine,
                         metrics_out=args.metrics_out,
                         event_timestamps=args.event_timestamps,
                         lifecycle_dir=args.lifecycle_dir,
                         trace_out=args.trace_out,
                         trace_sample=args.trace_sample,
                         device=args.device)
        out = {
            "n_workers": r.n_workers,
            "grouping": args.grouping,
            "engine": args.engine,
            "device": args.device,
            "decision_io_ms": args.decision_io_ms,
            "decisions_per_sec": round(r.decisions_per_sec, 1),
            "p50_latency_ms": round(r.p50_latency_ms, 2),
            "p90_latency_ms": round(r.p90_latency_ms, 2),
            "best_action_fraction": round(r.best_action_fraction, 3),
            "worker_throughput": {str(w): round(t, 1) for w, t
                                  in sorted(r.worker_throughput.items())},
            "worker_start_s": {str(w): round(t, 3) for w, t
                               in sorted(r.worker_start_s.items())},
            "stragglers": r.stragglers,
        }
        if r.fleet_report is not None:
            dl = r.fleet_report["spans"].get("engine.decision_latency", {})
            out["fleet_decision_latency"] = {
                "count": dl.get("count", 0),
                "p50_ms": round(dl.get("p50_ms", 0.0), 3),
                "p99_ms": round(dl.get("p99_ms", 0.0), 3)}
            if args.metrics_out:
                out["metrics_out"] = args.metrics_out
        if r.trace_out:
            out["trace_out"] = r.trace_out
            out["trace_stamps"] = r.trace_stamps
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
