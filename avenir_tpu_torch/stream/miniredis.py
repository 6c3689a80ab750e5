"""Minimal Redis-protocol (RESP) list broker + client.

Counterpart of ``avenir_tpu/stream/miniredis.py``, copied (pure stdlib);
the client's fault injection takes an explicit injector only.

The reference's serving topology decouples producers and consumers through
Redis lists (RedisSpout.java rpop, RedisActionWriter.java lpush,
RedisRewardReader.java lindex cursor). This module provides the smallest
self-contained broker speaking that exact wire contract — LPUSH / RPOP /
LINDEX / LLEN / DEL / FLUSHALL / PING over RESP — so multi-process serving
(the ``num.workers`` scale-out, ReinforcementLearnerTopology.java:64-82)
runs and is testable with zero external infrastructure. A real Redis server
is a drop-in replacement: ``MiniRedisClient`` mirrors the redis-py subset
``stream.loop.RedisQueues`` consumes (bytes in, bytes out).

Fault tolerance: the client carries a default socket timeout and
surfaces :class:`BrokerUnavailable` instead of hanging on a dead broker;
``reconnect=True`` arms transparent reconnection with capped exponential
backoff + jitter and at-least-once command resend (the ack/replay ledger
plus downstream dedup complete the exactly-once effect — see
``RedisQueues.recover_in_flight``). The server side gains an append-only
command log (``aof_path``): every mutating command is logged after it
executes, and a restarted broker replays the log back to its pre-crash
state — a SIGKILLed broker loses at most the single command whose log
write the kill interrupted, which the same at-least-once contract absorbs.
``SET``/``GET`` round out the subset with the single-key atomic record the
ownership rebalancer swaps assignments through (stream/rebalance.py).

Control-plane fault tolerance adds the conditional-write
family: ``SETNX`` (first-writer-wins creation), ``CAS`` (swap iff the
stored bytes match — the lease renewal/takeover primitive), and the
fencing pair ``FSET``/``FBUMP`` (a per-key monotone fence floor; writes
carrying a token below the floor bounce with ``-FENCED``, surfacing
client-side as :class:`FencedWrite`). Floors are AOF-logged and replay
with the store, so a SIGKILLed control shard restarts still fencing.

Single-process uses need none of this — ``InProcQueues`` stays the default.
"""

from __future__ import annotations

import json
import os
import random
import socket
import socketserver
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# blocking socket ops (connect, send, reply read) give up after this long
# by default: a dead broker must surface as BrokerUnavailable, never as an
# indefinite hang in a worker's recv path
DEFAULT_TIMEOUT = 10.0


class BrokerUnavailable(ConnectionError):
    """The broker cannot be reached: connect/send/reply timed out or was
    refused, and reconnection (when armed) exhausted its deadline."""


class FencedWrite(RuntimeError):
    """A fenced write (FSET/FBUMP) carried a token below the key's fence
    floor: the writer has been deposed by a newer lease holder and must
    stop publishing. Raised client-side from the broker's -FENCED reply
    — the on-the-wire rejection the split-brain gate asserts."""


# --------------------------------------------------------------------------
# RESP encoding/decoding (the subset the list commands need)
# --------------------------------------------------------------------------

def _encode_bulk(val: Optional[bytes]) -> bytes:
    if val is None:
        return b"$-1\r\n"
    return b"$%d\r\n%s\r\n" % (len(val), val)


def _read_line(rfile) -> bytes:
    line = rfile.readline()
    if not line or not line.endswith(b"\r\n"):
        raise ConnectionError("client closed")
    return line[:-2]


def _read_command(rfile) -> Optional[List[bytes]]:
    """One client command (RESP array of bulk strings); None on EOF."""
    first = rfile.readline()
    if not first:
        return None
    if not first.endswith(b"\r\n") or first[:1] != b"*":
        raise ConnectionError(f"malformed RESP header {first!r}")
    n = int(first[1:-2])
    parts = []
    for _ in range(n):
        header = _read_line(rfile)
        if header[:1] != b"$":
            raise ConnectionError(f"expected bulk string, got {header!r}")
        size = int(header[1:])
        body = rfile.read(size + 2)
        if len(body) != size + 2:
            raise ConnectionError("short read")
        parts.append(body[:-2])
    return parts


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        srv: "MiniRedisServer" = self.server.owner  # type: ignore[attr-defined]
        # a pipeline's replies go out one write each: without NODELAY the
        # second waits for the client's delayed ACK of the first (~40 ms
        # a pipeline on Linux)
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        srv._client_connected()
        try:
            while True:
                try:
                    cmd = _read_command(self.rfile)
                except ConnectionError:
                    return
                if cmd is None:
                    return
                try:
                    reply = srv.execute(cmd)
                except ConnectionError:
                    # simulated crash (crash_after): drop the connection
                    # with no reply, exactly what a SIGKILLed broker
                    # looks like
                    return
                self.wfile.write(reply)
                self.wfile.flush()
        finally:
            srv._client_disconnected()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


# the commands the AOF must log: everything that changes store state.
# Reads (LRANGE/LINDEX/LLEN/GET/PING) replay to the same answer for free.
# SETNX/CAS/FSET/FBUMP are logged even when they decline the write: the
# decline is a pure function of replayed state (and fence floors), so
# replay reproduces exactly the same accept/reject sequence — and the
# floors themselves MUST persist across a SIGKILL + AOF restart, or a
# restarted control shard would forget it ever fenced a stale leader.
_MUTATING = frozenset((b"LPUSH", b"RPUSH", b"RPOP", b"LPOP", b"RPOPLPUSH",
                       b"LREM", b"DEL", b"FLUSHALL", b"SET",
                       b"SETNX", b"CAS", b"FSET", b"FBUMP"))


#: AOF flush policies. ``always`` = flush (one
#: write syscall) after every mutating command, so a confirmed reply
#: implies a durable log record — the durability the chaos harness's
#: SIGKILL gates assume. ``batch`` = buffer log records and flush on a
#: short idle timer and on close: per-command syscalls disappear from
#: the hot path (measurable at 1M decisions/min on every shard), at the
#: cost of a bounded durability window — a SIGKILL can lose up to
#: ``aof_flush_interval_s`` of CONFIRMED mutations (exactly redis's own
#: ``appendfsync everysec`` trade, one level up). The serving tier's
#: at-least-once + dedup discipline turns most of that window into
#: bounded duplicates, but a producer's un-resent LPUSH inside it is
#: gone — kill-durability scenarios must pin ``always``.
AOF_FLUSH_POLICIES = ("always", "batch")
AOF_FLUSH_INTERVAL_S = 0.05


class MiniRedisServer:
    """Threaded in-memory list store speaking the RESP list subset.

    ``aof_path`` arms crash durability: each mutating command is appended
    (RESP-encoded) to the log after it executes, and a server constructed
    over an existing log replays it before serving — so a broker SIGKILL
    + restart resumes from the pre-crash store (a torn final record from
    the kill is truncated away on replay). ``aof_flush`` picks the flush
    policy (see :data:`AOF_FLUSH_POLICIES`): the default ``batch``
    buffers records and flushes on an idle timer
    (``aof_flush_interval_s``) and on close — the per-mutation
    flush syscall is off the hot path, with a durability window of at
    most one interval; ``always`` restores the flush-per-command
    behavior a kill-durability gate needs. Neither fsyncs: the log
    protects against broker-process death, not host power loss.

    ``crash_after=N`` (tests only) simulates that SIGKILL
    deterministically: after N executed commands the server answers
    nothing and drops every connection — in-flight pipelines lose their
    replies mid-batch exactly as a real kill loses them."""

    def __init__(self, host: str = "localhost", port: int = 0,
                 aof_path: Optional[str] = None,
                 crash_after: Optional[int] = None,
                 aof_flush: str = "batch",
                 aof_flush_interval_s: float = AOF_FLUSH_INTERVAL_S):
        if aof_flush not in AOF_FLUSH_POLICIES:
            raise ValueError(f"aof_flush {aof_flush!r} not one of "
                             f"{AOF_FLUSH_POLICIES}")
        self._lists: Dict[bytes, deque] = {}
        self._strings: Dict[bytes, bytes] = {}
        # per-key fence floor: the largest fencing token a
        # FSET/FBUMP ever carried for the key. A fenced write below the
        # floor is rejected — the broker-side half of the coordinator
        # lease protocol, which makes a deposed leader's publish
        # structurally impossible rather than merely epoch-ignored.
        # Floors survive DEL (deleting a record must not re-admit a
        # stale writer) and replay from the AOF; FLUSHALL clears them
        # (the explicit full-reset a test harness uses).
        self._fences: Dict[bytes, int] = {}
        self._lock = threading.Lock()
        self._aof = None
        self._aof_path = aof_path
        self._aof_flush = aof_flush
        self._aof_interval = max(float(aof_flush_interval_s), 0.001)
        self._aof_dirty = False
        self._flush_stop: Optional[threading.Event] = None
        self._executed = 0
        self._crash_after = crash_after
        self._clients = 0           # live connections (INFO gauge)
        if aof_path:
            self._replay_aof(aof_path)
            self._aof = open(aof_path, "ab")
            if aof_flush == "batch":
                self._flush_stop = threading.Event()
                threading.Thread(target=self._flush_loop,
                                 daemon=True).start()
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.owner = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)

    def _flush_loop(self) -> None:
        """Idle flusher for the ``batch`` policy: wake every interval and
        flush iff mutations landed since the last flush — the durability
        window is one interval, the hot path pays zero flush syscalls."""
        stop = self._flush_stop
        while not stop.wait(self._aof_interval):
            with self._lock:
                if self._aof is not None and self._aof_dirty:
                    self._aof.flush()
                    self._aof_dirty = False

    def _replay_aof(self, path: str) -> None:
        """Rebuild the store from the command log. A partial tail record
        (the command a SIGKILL interrupted mid-write) is discarded AND
        truncated away, so appending resumes on a record boundary."""
        if not os.path.exists(path):
            return
        good = 0
        with open(path, "rb") as fh:
            while True:
                try:
                    cmd = _read_command(fh)
                except (ConnectionError, ValueError):
                    break                       # torn tail: stop here
                if cmd is None:
                    break
                self._apply(cmd[0].upper(), cmd[1:])
                good = fh.tell()
        if good < os.path.getsize(path):
            with open(path, "r+b") as fh:
                fh.truncate(good)

    def start(self) -> "MiniRedisServer":
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() blocks on an event only serve_forever() sets — calling
        # it on a constructed-but-never-started server would hang forever
        if self._thread.is_alive():
            self._tcp.shutdown()
        self._tcp.server_close()
        if self._flush_stop is not None:
            self._flush_stop.set()
        with self._lock:
            if self._aof is not None:
                self._aof.close()      # close() flushes buffered records
                self._aof = None

    def __enter__(self) -> "MiniRedisServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _client_connected(self) -> None:
        with self._lock:
            self._clients += 1

    def _client_disconnected(self) -> None:
        with self._lock:
            self._clients -= 1

    # -- command dispatch --------------------------------------------------

    def execute(self, cmd: List[bytes]) -> bytes:
        name = cmd[0].upper()
        with self._lock:
            if (self._crash_after is not None
                    and self._executed >= self._crash_after):
                raise ConnectionError("simulated broker crash")
            self._executed += 1
            reply = self._apply(name, cmd[1:])
            if self._aof is not None and name in _MUTATING:
                # logged AFTER the apply: a kill between the two loses
                # exactly that one mutation, which the client's
                # at-least-once resend re-issues after reconnect
                self._aof.write(_encode_command(cmd))
                if self._aof_flush == "always":
                    self._aof.flush()
                else:
                    self._aof_dirty = True   # idle flusher's signal
            return reply

    def _apply(self, name: bytes, args: List[bytes]) -> bytes:
        if name == b"PING":
            return b"+PONG\r\n"
        if name == b"INFO":
            # broker introspection: queue depths,
            # AOF byte size, connected clients, total commands — the
            # coordinator polls this into broker.* hub gauges, making
            # broker saturation (the known wall for the 1M/min run)
            # visible instead of inferred. Read-only: not AOF-logged.
            depths = {key.decode(): len(q)
                      for key, q in self._lists.items() if q}
            lines = [
                "# avenir-miniredis",
                f"connected_clients:{self._clients}",
                f"total_commands_processed:{self._executed}",
                f"aof_enabled:{1 if self._aof is not None else 0}",
                f"aof_bytes:{self._aof.tell() if self._aof else 0}",
                f"aof_flush:{self._aof_flush}",
                f"lists:{len(depths)}",
                f"total_list_items:{sum(depths.values())}",
                # queue names carry colons (eventQueue:g0), so depths
                # travel as one JSON field instead of key:value lines
                "queue_depths:" + json.dumps(depths, sort_keys=True),
            ]
            return _encode_bulk(("\r\n".join(lines) + "\r\n").encode())
        if name == b"SET":
            # the single-key atomic record (ownership assignments ride
            # this: one epoch-numbered JSON blob swapped in one command)
            self._strings[args[0]] = args[1]
            return b"+OK\r\n"
        if name == b"SETNX":
            # first-writer-wins creation: the lease-acquisition
            # primitive (a standby claiming an EMPTY lease key; exactly
            # one of N racing claimants gets the 1 reply)
            if args[0] in self._strings:
                return b":0\r\n"
            self._strings[args[0]] = args[1]
            return b":1\r\n"
        if name == b"CAS":
            # conditional swap on the EXACT stored bytes:
            # ``CAS key expected new`` installs ``new`` iff the current
            # value is byte-equal to ``expected``. The lease record
            # rides this — renewals and takeovers are CAS on the raw
            # JSON blob, so a renewal that raced a takeover (or vice
            # versa) loses cleanly instead of clobbering. A missing key
            # never matches (creation is SETNX's job).
            current = self._strings.get(args[0])
            if current is None or current != args[1]:
                return b":0\r\n"
            self._strings[args[0]] = args[2]
            return b":1\r\n"
        if name == b"FSET":
            # fenced SET: ``FSET key token value`` applies iff ``token``
            # is >= the key's fence floor, and raises the floor to it.
            # A deposed leader (holding a smaller token than the
            # floor a takeover bumped) gets -FENCED on the wire — the
            # split-brain guard enforced where it must be: at the
            # single writer-ordering point, not in every reader.
            token = int(args[1])
            floor = self._fences.get(args[0], 0)
            if token < floor:
                return (b"-FENCED stale token %d < floor %d for '%s'\r\n"
                        % (token, floor, args[0]))
            self._fences[args[0]] = token
            self._strings[args[0]] = args[2]
            return b"+OK\r\n"
        if name == b"FBUMP":
            # raise the fence floor WITHOUT touching the value: the
            # first thing a takeover does after winning the lease CAS.
            # After the bump, no smaller-token FSET can land — so the
            # GET that follows reads a record no stale leader can
            # retroactively change (the takeover read-fence ordering).
            token = int(args[1])
            floor = self._fences.get(args[0], 0)
            if token < floor:
                return (b"-FENCED stale token %d < floor %d for '%s'\r\n"
                        % (token, floor, args[0]))
            self._fences[args[0]] = token
            return b":%d\r\n" % token
        if name == b"FGET":
            # read the fence floor (0 when the key was never fenced):
            # how a claimant that never observed the previous leader
            # learns the token it must exceed. Read-only: not logged.
            return b":%d\r\n" % self._fences.get(args[0], 0)
        if name == b"GET":
            return _encode_bulk(self._strings.get(args[0]))
        if name == b"LPUSH":
            q = self._lists.setdefault(args[0], deque())
            for val in args[1:]:
                q.appendleft(val)
            return b":%d\r\n" % len(q)
        if name == b"RPUSH":
            # tail-side append: queue migration splices an old shard's
            # entries BELOW a new shard's fresh arrivals (oldest stays
            # at the tail, where consumers pop/read first), keeping
            # tail-relative reward cursors valid across the move
            q = self._lists.setdefault(args[0], deque())
            for val in args[1:]:
                q.append(val)
            return b":%d\r\n" % len(q)
        if name == b"RPOP":
            q = self._lists.get(args[0])
            if len(args) >= 2:
                # Redis 6.2 count form: array of up to count popped
                # values (oldest first under lpush producers), null
                # array when the key is empty/missing
                count = int(args[1])
                if not q:
                    return b"*-1\r\n"
                popped = [q.pop() for _ in range(min(count, len(q)))]
                return b"*%d\r\n" % len(popped) + b"".join(
                    _encode_bulk(v) for v in popped)
            return _encode_bulk(q.pop() if q else None)
        if name == b"LPOP":
            # head-side pop (newest under lpush producers) — the
            # reject-new admission shed takes arrivals off the head in
            # one command instead of per-event round trips
            q = self._lists.get(args[0])
            if len(args) >= 2:
                count = int(args[1])
                if not q:
                    return b"*-1\r\n"
                popped = [q.popleft()
                          for _ in range(min(count, len(q)))]
                return b"*%d\r\n" % len(popped) + b"".join(
                    _encode_bulk(v) for v in popped)
            return _encode_bulk(q.popleft() if q else None)
        if name == b"RPOPLPUSH":
            # atomic move (the reliable-queue primitive the ack/replay
            # ledger rides): nothing is ever in neither list
            q = self._lists.get(args[0])
            if not q:
                return _encode_bulk(None)
            val = q.pop()
            self._lists.setdefault(args[1], deque()).appendleft(val)
            return _encode_bulk(val)
        if name == b"LREM":
            q = self._lists.get(args[0])
            count, val = int(args[1]), args[2]
            if not q:
                return b":0\r\n"
            if count == 1:
                # the ledger-ack hot path (64 per engine batch):
                # deque.remove is the same head-first first-match
                # semantics at C speed, no list rebuild
                try:
                    q.remove(val)
                    return b":1\r\n"
                except ValueError:
                    return b":0\r\n"
            if count == -1:
                try:
                    q.reverse()
                    q.remove(val)
                    return b":1\r\n"
                except ValueError:
                    return b":0\r\n"
                finally:
                    q.reverse()
            # count>0: head-first; count<0: tail-first; 0: all
            removed, items = 0, list(q)   # index 0 = head (LPUSH side)
            if count < 0:
                items.reverse()
            limit = abs(count) if count != 0 else len(items)
            kept = []
            for item in items:
                if item == val and removed < limit:
                    removed += 1
                else:
                    kept.append(item)
            if count < 0:
                kept.reverse()
            self._lists[args[0]] = deque(kept)
            return b":%d\r\n" % removed
        if name == b"LRANGE":
            q = self._lists.get(args[0])
            lo, hi = int(args[1]), int(args[2])
            items = list(q) if q else []
            n = len(items)
            lo = max(lo + n if lo < 0 else lo, 0)
            hi = hi + n if hi < 0 else hi
            # a stop still negative after conversion is out of range:
            # real Redis replies with an empty array, not a slice
            sel = items[lo:hi + 1] if 0 <= hi and lo <= hi else []
            return b"*%d\r\n" % len(sel) + b"".join(
                _encode_bulk(v) for v in sel)
        if name == b"LINDEX":
            q = self._lists.get(args[0])
            idx = int(args[1])
            if q is None:
                return _encode_bulk(None)
            pos = idx if idx >= 0 else len(q) + idx
            if 0 <= pos < len(q):
                return _encode_bulk(q[pos])
            return _encode_bulk(None)
        if name == b"LLEN":
            q = self._lists.get(args[0])
            return b":%d\r\n" % (len(q) if q else 0)
        if name == b"DEL":
            n = 0
            for key in args:
                n += 1 if self._lists.pop(key, None) is not None else 0
                n += 1 if self._strings.pop(key, None) is not None else 0
            return b":%d\r\n" % n
        if name == b"FLUSHALL":
            self._lists.clear()
            self._strings.clear()
            self._fences.clear()
            return b"+OK\r\n"
        return b"-ERR unknown command '%s'\r\n" % name


# --------------------------------------------------------------------------
# client (the redis-py subset RedisQueues consumes)
# --------------------------------------------------------------------------

def _encode_command(parts) -> bytes:
    return b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


class MiniRedisClient:
    """Tiny blocking client; method-compatible with redis.StrictRedis for
    the list commands (returns bytes, like redis-py without decoding).

    ``pipeline()`` returns a buffering view with the same command
    methods: N commands go out in ONE socket write and the N replies are
    read back together — the transport primitive that collapses the
    serving loop's per-event round trips. ``calls`` counts broker round
    trips (a pipeline ``execute`` is one), which the serving bench uses
    to report round-trips-per-batch.

    Every blocking socket op observes ``timeout`` — a dead or hung broker
    surfaces as :class:`BrokerUnavailable`, never an indefinite recv hang.
    ``reconnect=True`` additionally survives broker restarts: on a
    connection failure the client redials with capped exponential backoff
    + jitter (up to ``reconnect_timeout`` per outage) and RESENDS the
    in-flight command or pipeline batch. Resend is at-least-once — the
    lost reply's command may have executed — so it is only safe under the
    ledger + dedup discipline the serving tier already runs;
    ``reconnects`` counts successful redials, which ``RedisQueues`` uses
    to trigger its in-flight-ledger reconciliation."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = DEFAULT_TIMEOUT,
                 reconnect: bool = False,
                 reconnect_timeout: float = 10.0,
                 faults=None):
        self.host, self.port = host, port
        self._timeout = timeout
        self._reconnect_armed = bool(reconnect)
        self._reconnect_timeout = float(reconnect_timeout)
        self._lock = threading.Lock()
        self.calls = 0
        self.reconnects = 0
        # deterministic network fault injection: an explicit injector
        # (``stream/faultnet.FaultNet``: ``on_connect(endpoint)``,
        # ``on_op(endpoint, client)``); None is off, at one attribute
        # check per op. Nothing arms it from the environment.
        self._faults = faults
        self._drop_reply = False
        self._connect()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def _arm_reply_drop(self) -> None:
        """Faultnet hook: kill the connection AFTER the next send lands
        — the command executes broker-side, its reply is lost, and the
        resend path must absorb the duplicate (the at-least-once
        window, injected on purpose)."""
        self._drop_reply = True

    def _connect(self) -> None:
        if self._faults is not None:
            self._faults.on_connect(self.endpoint)
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self._timeout)
        self._rfile = self._sock.makefile("rb")

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def _unavailable(self, exc: Exception) -> BrokerUnavailable:
        return BrokerUnavailable(
            f"broker {self.host}:{self.port} unavailable: {exc!r}")

    @staticmethod
    def _backoff(attempt: int) -> float:
        """Capped exponential backoff + jitter (uniform 0.5-1.5x): keeps
        a restarted broker from being stampeded by every worker redialing
        in lockstep."""
        return min(0.02 * (2 ** attempt), 0.5) * (0.5 + random.random())

    def _failover(self, exc: OSError, state: Dict) -> None:
        """Shared resend bookkeeping for ``_call``/``_call_many``: the
        FIRST failure of an operation arms a per-operation deadline
        (``reconnect_timeout``); every subsequent failure — including a
        broker that accepts redials but dies again mid-command — backs
        off and redials until that single deadline expires. Without the
        operation-level bound, a listening-but-dead broker would loop
        connect/resend/fail forever."""
        if not self._reconnect_armed:
            raise self._unavailable(exc) from exc
        now = time.monotonic()
        if "deadline" not in state:
            state["deadline"] = now + self._reconnect_timeout
        elif now > state["deadline"]:
            raise self._unavailable(exc) from exc
        else:
            time.sleep(self._backoff(state["attempt"]))
        self._redial(exc, state["deadline"])
        state["attempt"] += 1

    def _redial(self, cause: Exception, deadline: float) -> None:
        """Reconnect with backoff until ``deadline``, else raise
        BrokerUnavailable."""
        self.close()
        attempt = 0
        while True:
            if time.monotonic() > deadline:
                raise self._unavailable(cause) from cause
            try:
                self._connect()
                self.reconnects += 1
                return
            except OSError as exc:
                cause = exc
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._unavailable(cause) from cause
            time.sleep(min(self._backoff(attempt), remaining))
            attempt += 1

    def _call(self, *parts: bytes):
        msg = _encode_command(parts)
        with self._lock:
            self.calls += 1
            state: Dict = {"attempt": 0}
            while True:
                try:
                    if self._faults is not None:
                        self._faults.on_op(self.endpoint, self)
                    self._sock.sendall(msg)
                    self._maybe_drop_reply()
                    return self._reply()
                except RuntimeError:
                    raise             # -ERR reply: the stream is intact
                except OSError as exc:
                    self._failover(exc, state)  # then resend
                    # (at-least-once: the lost reply's command may have
                    # executed — ledger + dedup absorb the repeat)

    def _call_many(self, commands):
        """One write carrying every buffered command, then the matching
        replies in order (the pipeline transport). Error replies are
        collected — never left unread, which would desync the stream —
        and the first one raises after the batch completes. A connection
        failure anywhere in the batch (with reconnect armed) redials and
        resends the WHOLE batch: partial replies are discarded, because
        without them there is no telling which commands executed."""
        msg = b"".join(_encode_command(parts) for parts in commands)
        with self._lock:
            self.calls += 1
            state: Dict = {"attempt": 0}
            while True:
                try:
                    if self._faults is not None:
                        self._faults.on_op(self.endpoint, self)
                    self._sock.sendall(msg)
                    self._maybe_drop_reply()
                    replies, first_err = [], None
                    for _ in commands:
                        try:
                            replies.append(self._reply())
                        except RuntimeError as exc:  # -ERR: stream intact
                            replies.append(exc)
                            if first_err is None:
                                first_err = exc
                    break
                except OSError as exc:
                    self._failover(exc, state)
        if first_err is not None:
            raise first_err
        return replies

    def _maybe_drop_reply(self) -> None:
        """Second half of the faultnet ``drop_reply`` injection: the
        send already landed (the broker will execute the batch); kill
        the connection before reading, exactly what a broker-side
        half-close at the wrong moment does."""
        if self._drop_reply:
            self._drop_reply = False
            self.close()
            raise OSError(f"faultnet: {self.endpoint} reply dropped")

    def _reply(self):
        line = _read_line(self._rfile)
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b":":
            return int(rest)
        if kind == b"$":
            size = int(rest)
            if size < 0:
                return None
            body = self._rfile.read(size + 2)
            if len(body) != size + 2:    # EOF mid-reply must not truncate
                raise ConnectionError("short bulk reply")
            return body[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:                     # null array (RPOP count on empty)
                return None
            return [self._reply() for _ in range(n)]
        if kind == b"-":
            raise RuntimeError(rest.decode())
        raise ConnectionError(f"unexpected reply {line!r}")

    @staticmethod
    def _b(v) -> bytes:
        return v if isinstance(v, bytes) else str(v).encode()

    def pipeline(self) -> "MiniRedisPipeline":
        return MiniRedisPipeline(self)

    def ping(self):
        return self._call(b"PING")

    def info(self) -> Dict:
        """Parsed INFO reply: int-valued ``connected_clients`` /
        ``total_commands_processed`` / ``aof_bytes`` / ``lists`` /
        ``total_list_items`` plus the ``queue_depths`` dict
        (``{queue name: pending entries}``) — the broker-saturation
        signal the coordinator folds into ``broker.*`` hub gauges."""
        raw = self._call(b"INFO")
        out: Dict = {}
        for line in (raw or b"").decode().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(":")
            if key == "queue_depths":
                try:
                    out[key] = json.loads(value) if value else {}
                except ValueError:
                    out[key] = {}
            else:
                try:
                    out[key] = int(value)
                except ValueError:
                    out[key] = value
        return out

    def set(self, key, value):
        return self._call(b"SET", self._b(key), self._b(value))

    def setnx(self, key, value) -> int:
        """First-writer-wins SET: 1 if this call created the key."""
        return self._call(b"SETNX", self._b(key), self._b(value))

    def cas(self, key, expected, new) -> int:
        """Compare-and-swap on the exact stored bytes: 1 if swapped.
        A missing key never matches (use :meth:`setnx` to create)."""
        return self._call(b"CAS", self._b(key), self._b(expected),
                          self._b(new))

    def fset(self, key, token: int, value):
        """Fenced SET: applies iff ``token`` >= the key's fence floor
        (raising the floor to it); raises :class:`FencedWrite` when the
        broker rejects a stale token."""
        try:
            return self._call(b"FSET", self._b(key), self._b(int(token)),
                              self._b(value))
        except RuntimeError as exc:
            if str(exc).startswith("FENCED"):
                raise FencedWrite(str(exc)) from exc
            raise

    def fbump(self, key, token: int) -> int:
        """Raise ``key``'s fence floor to ``token`` without changing the
        value (the takeover read-fence); :class:`FencedWrite` if the
        floor is already above ``token``."""
        try:
            return self._call(b"FBUMP", self._b(key),
                              self._b(int(token)))
        except RuntimeError as exc:
            if str(exc).startswith("FENCED"):
                raise FencedWrite(str(exc)) from exc
            raise

    def fget(self, key) -> int:
        """The key's current fence floor (0 = never fenced)."""
        return self._call(b"FGET", self._b(key))

    def get(self, key) -> Optional[bytes]:
        return self._call(b"GET", self._b(key))

    def lpush(self, key, *values) -> int:
        return self._call(b"LPUSH", self._b(key),
                          *[self._b(v) for v in values])

    def rpush(self, key, *values) -> int:
        return self._call(b"RPUSH", self._b(key),
                          *[self._b(v) for v in values])

    def rpop(self, key, count: Optional[int] = None):
        if count is not None:
            return self._call(b"RPOP", self._b(key), self._b(count))
        return self._call(b"RPOP", self._b(key))

    def lpop(self, key, count: Optional[int] = None):
        if count is not None:
            return self._call(b"LPOP", self._b(key), self._b(count))
        return self._call(b"LPOP", self._b(key))

    def rpoplpush(self, src, dst) -> Optional[bytes]:
        return self._call(b"RPOPLPUSH", self._b(src), self._b(dst))

    def lrem(self, key, count, value) -> int:
        return self._call(b"LREM", self._b(key), self._b(count),
                          self._b(value))

    def lrange(self, key, start, stop) -> List[bytes]:
        return self._call(b"LRANGE", self._b(key), self._b(start),
                          self._b(stop))

    def lindex(self, key, index) -> Optional[bytes]:
        return self._call(b"LINDEX", self._b(key), self._b(index))

    def llen(self, key) -> int:
        return self._call(b"LLEN", self._b(key))

    def delete(self, *keys) -> int:
        return self._call(b"DEL", *[self._b(k) for k in keys])

    def flushall(self):
        return self._call(b"FLUSHALL")


class MiniRedisPipeline:
    """Buffered command batch over one client: the redis-py ``pipeline``
    subset (transaction-less). Command methods mirror the client's,
    return ``self`` for chaining, and ``execute()`` ships the batch in
    one round trip, returning the replies in command order."""

    def __init__(self, client: MiniRedisClient):
        self._client = client
        self._commands: List[tuple] = []

    def __len__(self) -> int:
        return len(self._commands)

    def _queue(self, *parts: bytes) -> "MiniRedisPipeline":
        self._commands.append(parts)
        return self

    def lpush(self, key, *values):
        return self._queue(b"LPUSH", self._client._b(key),
                           *[self._client._b(v) for v in values])

    def rpop(self, key, count: Optional[int] = None):
        if count is not None:
            return self._queue(b"RPOP", self._client._b(key),
                               self._client._b(count))
        return self._queue(b"RPOP", self._client._b(key))

    def lpop(self, key, count: Optional[int] = None):
        if count is not None:
            return self._queue(b"LPOP", self._client._b(key),
                               self._client._b(count))
        return self._queue(b"LPOP", self._client._b(key))

    def rpoplpush(self, src, dst):
        return self._queue(b"RPOPLPUSH", self._client._b(src),
                           self._client._b(dst))

    def lrem(self, key, count, value):
        return self._queue(b"LREM", self._client._b(key),
                           self._client._b(count), self._client._b(value))

    def lrange(self, key, start, stop):
        return self._queue(b"LRANGE", self._client._b(key),
                           self._client._b(start), self._client._b(stop))

    def lindex(self, key, index):
        return self._queue(b"LINDEX", self._client._b(key),
                           self._client._b(index))

    def llen(self, key):
        return self._queue(b"LLEN", self._client._b(key))

    def execute(self) -> List:
        commands, self._commands = self._commands, []
        if not commands:
            return []
        return self._client._call_many(commands)


def connect_with_retry(host: str, port: int, timeout: float = 10.0,
                       socket_timeout: Optional[float] = None,
                       **client_kw) -> MiniRedisClient:
    """Client to a broker that may still be starting (subprocess spawn).
    Raises :class:`BrokerUnavailable` once ``timeout`` (the overall
    budget) is spent — a never-accepting or never-answering endpoint
    fails loudly instead of hanging the caller, since each attempt's
    connect/ping observes ``socket_timeout`` (the client default when
    None). Extra kwargs (``reconnect=``...) pass through to
    :class:`MiniRedisClient`."""
    if socket_timeout is not None:
        client_kw["timeout"] = socket_timeout
    deadline = time.monotonic() + timeout
    last: Exception = BrokerUnavailable(f"no broker at {host}:{port}")
    while True:
        client = None
        try:
            client = MiniRedisClient(host, port, **client_kw)
            client.ping()
            return client
        except (ConnectionError, OSError) as exc:
            last = exc
            if client is not None:     # connected but ping failed: no leak
                client.close()
            if time.monotonic() > deadline:
                raise BrokerUnavailable(
                    f"no broker at {host}:{port} after {timeout:.1f}s "
                    f"of retries: {last!r}") from last
            time.sleep(0.05)


def main(argv=None) -> int:
    """Standalone broker process (``python -m avenir_tpu_torch.stream.miniredis
    --port N``): keeps the broker's connection threads out of any client's
    GIL — the deployment run_scaleout uses."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--aof", default=None, metavar="PATH",
                    help="append-only command log: mutations are logged "
                         "and replayed on start, so a SIGKILLed broker "
                         "restarted over the same file resumes its "
                         "pre-crash store (the chaos-harness contract)")
    ap.add_argument("--aof-flush", default="batch",
                    choices=AOF_FLUSH_POLICIES,
                    help="AOF flush policy: 'batch' (default) buffers "
                         "log records and flushes on a short idle timer "
                         "— no per-command flush syscall, durability "
                         "window of ~50ms on SIGKILL; 'always' flushes "
                         "per mutation (a confirmed reply implies a "
                         "durable record — the kill-chaos contract)")
    args = ap.parse_args(argv)
    srv = MiniRedisServer(args.host, args.port, aof_path=args.aof,
                          aof_flush=args.aof_flush)
    print(f"miniredis listening {srv.host}:{srv.port}", flush=True)
    srv._thread.start()
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
