"""Sampled cross-process event tracing -> Chrome-trace JSON.

Counterpart of ``avenir_tpu/obs/tracing.py``, copied (pure stdlib).

The fleet's histograms say HOW SLOW decisions are; nothing says WHERE
one decision spent its time across processes. This module is the
Dapper-shaped answer at the smallest possible footprint: the producer
promotes 1-in-N events from the stamped ``id|enqueue_ts`` wire mode to
``id|enqueue_ts|traceid``, and every stage that touches a stamped
payload drops a wall-clock stamp into a bounded process-local buffer:

    producer_enqueue  driver, when the event is pushed
    broker_pop        worker, when the payload comes off the queue
    dispatch          worker, when the select is dispatched to the device
    resolve           worker, when the readback materializes the actions
    reward_fold       worker, when the (traced) reward folds into state

Rewards ride the same opt-in: a traced reward is ``action,reward|traceid``
(the trace id appended to the VALUE field, which the drain peels before
the float parse). The wire format is byte-identical when tracing is off
— stamping is the producer's choice, parsing falls through untouched
payloads unchanged — and sampling keeps the hot loop bare: untraced
events (N-1 of N) cost one ``is None`` check per stage.

Workers flush their buffers over the broker (``traceQueue``, batched on
the heartbeat cadence); the driver merges them with its own stamps and
exports Chrome-trace JSON (``chrome_trace`` / ``write_chrome_trace``)
viewable in Perfetto or chrome://tracing — per-process tracks, one flow
per trace id, segments named for the stage gaps (``queue_wait``,
``dispatch``, ``compute``, ``reward_lag``).
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Deque, Dict, List, Optional

# stamp kinds in end-to-end order; the export names inter-stamp
# segments after the gap they cover
TRACE_STAMPS = ("producer_enqueue", "broker_pop", "dispatch", "resolve",
                "reward_fold")
_SEGMENTS = {
    ("producer_enqueue", "broker_pop"): "queue_wait",
    ("broker_pop", "dispatch"): "dispatch",
    ("dispatch", "resolve"): "compute",
    ("resolve", "reward_fold"): "reward_lag",
}

# the broker list worker buffers flush to (scaleout deployments)
TRACE_QUEUE = "traceQueue"

# best-effort backstop: a fleet whose workers trace but whose driver
# never drains (--trace with no --trace-out run) must not grow the
# broker (and its AOF) without bound — past this depth, flushes drop
# their stamps instead of pushing (sampling is lossy by design)
TRACE_QUEUE_MAX = 65536


class TraceContext:
    """Process-wide trace state: sampling (producer side), a bounded
    stamp buffer (every side), both disabled-by-default and free when
    disabled (one attribute read per stage)."""

    def __init__(self, sample_every: int = 64, max_stamps: int = 8192):
        self.enabled = False
        self.sample_every = max(int(sample_every), 1)
        self._seq = 0
        self._buf: Deque[Dict] = collections.deque(maxlen=max_stamps)
        self._lock = threading.Lock()
        self._pid = os.getpid()     # cached: record() is on the hot path

    def enable(self, sample_every: Optional[int] = None) -> "TraceContext":
        if sample_every is not None:
            self.sample_every = max(int(sample_every), 1)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def maybe_start(self) -> Optional[str]:
        """Producer-side sampling decision: every ``sample_every``-th
        call mints a trace id (``t<pid>-<seq>`` — unique per process,
        and processes never mint for each other). None (the common
        case) means this event travels unstamped on the unchanged wire
        format."""
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            if self._seq % self.sample_every:
                return None
            return f"t{self._pid}-{self._seq}"

    def record(self, trace_id: Optional[str], stamp: str,
               ts: Optional[float] = None) -> None:
        """Drop one stamp — a no-op unless tracing is on AND the payload
        carried a trace id (the per-stage cost for the N-1 untraced
        events is the caller's ``if trace_id`` check)."""
        if trace_id is None or not self.enabled:
            return
        self._buf.append({"trace": trace_id, "stamp": stamp,
                          "ts": time.time() if ts is None else ts,
                          "pid": self._pid})

    def drain(self) -> List[Dict]:
        """Take every buffered stamp (worker flush / driver export)."""
        out: List[Dict] = []
        while True:
            try:
                out.append(self._buf.popleft())
            except IndexError:
                return out

    def pending(self) -> int:
        return len(self._buf)


_CTX = TraceContext()


def context() -> TraceContext:
    return _CTX


def record_if_on(trace_id: Optional[str], stamp: str,
                 ts: Optional[float] = None) -> None:
    """Module-level stamp hook for the serving layers: one attribute
    read + one None check when tracing is off or the event is
    unsampled."""
    if trace_id is not None and _CTX.enabled:
        _CTX.record(trace_id, stamp, ts)


def record_batch(traces: Optional[List[str]], stamp: str) -> None:
    """Batch-granular stamps — the ONE home for the "every sampled
    trace id in this popped batch gets ``stamp`` at a single shared
    clock read" idiom (both engines, the loop's batch path), so segment
    boundaries line up across a batch's traces. The untraced common
    case costs one truthiness check."""
    if not traces or not _CTX.enabled:
        return
    now_ts = time.time()
    for trace in traces:
        _CTX.record(trace, stamp, now_ts)


# --------------------------------------------------------------------------
# wire helpers (the reward-value side; the event side lives in
# stream.loop beside split_event_timestamp, its stamped-id sibling)
# --------------------------------------------------------------------------

# trace ids are minted exclusively by TraceContext.maybe_start as
# ``t<pid>-<seq>``; the wire parsers accept ONLY that shape, so an
# unstamped payload that merely contains '|' keeps its
# byte-identity instead of misparsing its tail as a trace id
_TRACE_ID_RE = re.compile(r"t\d+-\d+\Z")


def is_trace_id(s: str) -> bool:
    return bool(_TRACE_ID_RE.match(s))


def attach_reward_trace(value: str, trace_id: Optional[str]) -> str:
    """Producer side: ``"0.0" -> "0.0|t123-64"`` for traced rewards,
    unchanged otherwise."""
    return value if trace_id is None else f"{value}|{trace_id}"


def split_reward_trace(value: str) -> tuple:
    """``(float reward, trace id or None)`` off a reward VALUE field.
    The fast path — every untraced reward — is one successful
    ``float()``; only a value that fails to parse pays the rpartition.
    A value that parses neither way raises ValueError exactly as the
    bare ``float()`` did before tracing existed."""
    try:
        return float(value), None
    except ValueError:
        head, sep, tail = value.rpartition("|")
        if sep and is_trace_id(tail):
            return float(head), tail
        raise


# --------------------------------------------------------------------------
# broker transport (scaleout workers -> driver)
# --------------------------------------------------------------------------

def push_stamps(client, ctx: Optional[TraceContext] = None) -> int:
    """Flush this process's stamp buffer to the broker in ONE lpush —
    rides the heartbeat cadence, so tracing adds no per-event round
    trips. No-op (and never raises) when tracing is off or the buffer
    is empty; returns the number of stamps shipped."""
    ctx = _CTX if ctx is None else ctx
    if not ctx.enabled:
        return 0
    stamps = ctx.drain()
    if not stamps:
        return 0
    try:
        # one llen per flush (heartbeat cadence, not per event): an
        # unconsumed traceQueue stops growing at TRACE_QUEUE_MAX
        if (hasattr(client, "llen")
                and int(client.llen(TRACE_QUEUE)) >= TRACE_QUEUE_MAX):
            return 0
        client.lpush(TRACE_QUEUE, *[json.dumps(s, sort_keys=True)
                                    for s in stamps])
    except Exception:
        return 0              # tracing must never sink a serving worker
    return len(stamps)


def read_stamps(client) -> List[Dict]:
    """Drain every shipped stamp off the broker (driver side)."""
    out: List[Dict] = []
    while True:
        raw = client.rpop(TRACE_QUEUE)
        if raw is None:
            return out
        try:
            # bytes from MiniRedis/redis-py, str from redis-py with
            # decode_responses=True — both must parse, not silently drop
            out.append(json.loads(
                raw.decode() if isinstance(raw, bytes) else raw))
        except ValueError:
            continue


# --------------------------------------------------------------------------
# Chrome-trace export
# --------------------------------------------------------------------------

def stamps_by_trace(stamps: List[Dict]) -> Dict[str, List[Dict]]:
    """Group + time-order stamps per trace id (secondary key: the
    canonical stamp order, so two stamps inside one clock tick still
    export in pipeline order)."""
    order = {s: i for i, s in enumerate(TRACE_STAMPS)}
    by: Dict[str, List[Dict]] = {}
    for s in stamps:
        by.setdefault(str(s.get("trace")), []).append(s)
    for trace in by.values():
        trace.sort(key=lambda s: (s.get("ts", 0.0),
                                  order.get(s.get("stamp"), 99)))
    return by


def chrome_trace(stamps: List[Dict]) -> Dict:
    """Chrome Trace Event JSON (the Perfetto-compatible legacy format):
    per stamp an instant event on its real pid's track, per adjacent
    stamp pair a complete ("X") slice named for the segment it covers,
    and flow arrows (s/f) tying one decision's path across process
    tracks. Timestamps are microseconds since the earliest stamp."""
    by = stamps_by_trace(stamps)
    t0 = min((s.get("ts", 0.0) for trace in by.values() for s in trace),
             default=0.0)
    events: List[Dict] = []

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    pids = sorted({s.get("pid", 0)
                   for trace in by.values() for s in trace})
    for pid in pids:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"pid {pid}"}})
    for trace_id, trace in sorted(by.items()):
        for s in trace:
            events.append({"ph": "i", "s": "p",
                           "name": s.get("stamp", "?"),
                           "pid": s.get("pid", 0), "tid": 0,
                           "ts": us(s.get("ts", 0.0)),
                           "cat": "stamp",
                           "args": {"trace": trace_id}})
        for a, b in zip(trace, trace[1:]):
            seg = _SEGMENTS.get((a.get("stamp"), b.get("stamp")),
                                f"{a.get('stamp')}->{b.get('stamp')}")
            dur = max(us(b.get("ts", 0.0)) - us(a.get("ts", 0.0)), 0.1)
            events.append({"ph": "X", "name": seg, "cat": "segment",
                           "pid": b.get("pid", 0), "tid": 0,
                           "ts": us(a.get("ts", 0.0)), "dur": dur,
                           "args": {"trace": trace_id}})
        if len(trace) > 1:
            first, last = trace[0], trace[-1]
            events.append({"ph": "s", "id": trace_id, "name": "decision",
                           "cat": "flow", "pid": first.get("pid", 0),
                           "tid": 0, "ts": us(first.get("ts", 0.0))})
            events.append({"ph": "f", "id": trace_id, "name": "decision",
                           "cat": "flow", "bp": "e",
                           "pid": last.get("pid", 0),
                           "tid": 0, "ts": us(last.get("ts", 0.0))})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"format": "avenir-trace-v1",
                          "traces": len(by)}}


def write_chrome_trace(stamps: List[Dict], path: str) -> str:
    """Atomic (temp + rename) Chrome-trace dump; returns ``path``."""
    from avenir_tpu_torch.obs.exporters import _atomic_write
    doc = chrome_trace(stamps)
    _atomic_write(path, lambda fh: json.dump(doc, fh, sort_keys=True))
    return path
