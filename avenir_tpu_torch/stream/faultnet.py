"""Deterministic network fault injection for the MiniRedis client layer.

Counterpart of ``avenir_tpu/stream/faultnet.py`` (the standard library,
copied), with the same schedules bit for bit: a seed's decisions are the
JAX package's. Chaos by SIGKILL alone leaves out the other family of
failures a fleet sees: connections dropped mid-command, replies that
never arrive (the command ran), one direction of a flow blackholed, a
(client, shard) pair partitioned for a window while the rest flows. This
module injects them where every broker byte passes, the
:class:`~avenir_tpu_torch.stream.miniredis.MiniRedisClient` socket layer.

- **Deterministic**: a decision is a function of ``(seed, endpoint, op
  index)`` through md5 (never ``hash()``, which Python salts a process),
  so a seeded schedule is the same in every run and process, and a
  failing soak replays.
- **Faults surface as OSError**, so the client's failover (capped-backoff
  redial and at-least-once resend) is what is under test. A ``drop``
  raises before the send (the command never reached the broker); a
  ``drop_reply`` kills the connection after it (the command may have
  run: the at-least-once window the ledger and dedup exist for); a
  blackhole window refuses every op and redial for a span of attempts,
  one side of a partition.

Arming is explicit: ``attach(client_or_fleet, faultnet)``, or the
``faults=`` argument of a client; ``None`` disarms. :func:`from_env`
reads ``AVENIR_FAULTNET`` (the JSON :meth:`FaultNet.env` writes) into one
process-wide injector for a harness to attach; the port's client does not
arm itself from the environment.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

FAULTNET_ENV = "AVENIR_FAULTNET"

#: decision kinds, in evaluation order (first match wins)
KINDS = ("blackhole", "drop", "drop_reply", "delay")


def _unit(seed: int, endpoint: str, op: int, salt: str) -> float:
    """Uniform [0, 1) from md5 — the cross-process-stable coin."""
    digest = hashlib.md5(
        f"{seed}:{endpoint}:{op}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2 ** 64


class FaultNet:
    """Seeded fault schedule over (endpoint, op index) plus manual
    partition switches.

    ``drop_rate`` / ``drop_reply_rate`` / ``delay_rate`` are per-op
    probabilities; ``delay_ms`` the injected reply latency.
    ``window_rate`` arms seeded blackhole windows: op indices are
    bucketed ``window_ops`` wide and a selected bucket rejects every op
    (and every redial) in it — a partition of that (client, endpoint)
    pair lasting ~``window_ops`` attempts. ``block(endpoint)`` /
    ``unblock(endpoint)`` are the scripted switches a directed scenario
    uses (leader partitioned from its control shard while a standby
    claims the lease).

    Thread-safe; per-endpoint op counters are shared across every
    client the injector is attached to in this process."""

    def __init__(self, seed: int = 0, *, drop_rate: float = 0.0,
                 drop_reply_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_ms: float = 10.0, window_rate: float = 0.0,
                 window_ops: int = 6):
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.drop_reply_rate = float(drop_reply_rate)
        self.delay_rate = float(delay_rate)
        self.delay_ms = float(delay_ms)
        self.window_rate = float(window_rate)
        self.window_ops = max(int(window_ops), 1)
        self._ops: Dict[str, int] = {}
        self._blocked: set = set()
        self._lock = threading.Lock()
        # injected-fault counters by kind (telemetry + gate assertions)
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}

    # -- configuration plumbing --------------------------------------------

    def to_config(self) -> Dict:
        return {"seed": self.seed, "drop_rate": self.drop_rate,
                "drop_reply_rate": self.drop_reply_rate,
                "delay_rate": self.delay_rate, "delay_ms": self.delay_ms,
                "window_rate": self.window_rate,
                "window_ops": self.window_ops}

    @classmethod
    def from_config(cls, cfg: Dict) -> "FaultNet":
        return cls(cfg.get("seed", 0),
                   drop_rate=cfg.get("drop_rate", 0.0),
                   drop_reply_rate=cfg.get("drop_reply_rate", 0.0),
                   delay_rate=cfg.get("delay_rate", 0.0),
                   delay_ms=cfg.get("delay_ms", 10.0),
                   window_rate=cfg.get("window_rate", 0.0),
                   window_ops=cfg.get("window_ops", 6))

    def env(self) -> str:
        """The ``AVENIR_FAULTNET``-style JSON a subprocess worker arms
        itself from (sorted keys: the spec is part of reproducibility)."""
        return json.dumps(self.to_config(), sort_keys=True)

    # -- the schedule ------------------------------------------------------

    def decide(self, endpoint: str, op: int) -> Optional[str]:
        """The fault (or None) for this endpoint's ``op``-th operation —
        a pure function of (seed, endpoint, op): the deterministic
        schedule itself, with no side effects."""
        if self.window_rate > 0.0:
            bucket = op // self.window_ops
            if _unit(self.seed, endpoint, bucket, "window") \
                    < self.window_rate:
                return "blackhole"
        if self.drop_rate > 0.0 and \
                _unit(self.seed, endpoint, op, "drop") < self.drop_rate:
            return "drop"
        if self.drop_reply_rate > 0.0 and \
                _unit(self.seed, endpoint, op, "reply") \
                < self.drop_reply_rate:
            return "drop_reply"
        if self.delay_rate > 0.0 and \
                _unit(self.seed, endpoint, op, "delay") < self.delay_rate:
            return "delay"
        return None

    def plan(self, endpoint: str, n_ops: int) -> List[Optional[str]]:
        """The first ``n_ops`` decisions for ``endpoint`` — what the
        bit-identical-reproduction gate serializes and compares across
        two independent runs/processes."""
        return [self.decide(endpoint, op) for op in range(n_ops)]

    # -- scripted partitions ----------------------------------------------

    def block(self, endpoint: str) -> None:
        """Partition this process from ``endpoint``: every op and every
        redial to it fails until :meth:`unblock` — one side of a network
        partition, scripted."""
        with self._lock:
            self._blocked.add(endpoint)

    def unblock(self, endpoint: str) -> None:
        with self._lock:
            self._blocked.discard(endpoint)

    def blocked(self, endpoint: str) -> bool:
        with self._lock:
            return endpoint in self._blocked

    # -- client hooks ------------------------------------------------------

    def _next_op(self, endpoint: str) -> int:
        with self._lock:
            op = self._ops.get(endpoint, 0)
            self._ops[endpoint] = op + 1
            return op

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def on_connect(self, endpoint: str) -> None:
        """Consulted from ``MiniRedisClient._connect``: a blocked
        endpoint refuses the dial, so a partition also defeats the redial
        loop (the client's reconnect deadline then turns it into
        BrokerUnavailable, as an unreachable host would)."""
        if self.blocked(endpoint):
            raise OSError(f"faultnet: {endpoint} partitioned (connect)")

    def on_op(self, endpoint: str, client=None) -> None:
        """Consulted once per command/pipeline send attempt, BEFORE the
        bytes go out. Raises OSError for drop/blackhole (the command
        never reaches the broker), sleeps for delay, and for drop_reply
        arms the post-send reply kill via ``client``."""
        if self.blocked(endpoint):
            self._count("blackhole")
            raise OSError(f"faultnet: {endpoint} partitioned")
        op = self._next_op(endpoint)
        fault = self.decide(endpoint, op)
        if fault is None:
            return
        if fault == "blackhole":
            self._count("blackhole")
            raise OSError(f"faultnet: {endpoint} blackholed (op {op})")
        if fault == "drop":
            self._count("drop")
            raise OSError(f"faultnet: {endpoint} dropped conn (op {op})")
        if fault == "delay":
            self._count("delay")
            time.sleep(self.delay_ms / 1e3)
            return
        if fault == "drop_reply" and client is not None:
            self._count("drop_reply")
            client._arm_reply_drop()


_GLOBAL: Optional[FaultNet] = None
_GLOBAL_LOCK = threading.Lock()


def from_env() -> Optional[FaultNet]:
    """The process-wide injector ``AVENIR_FAULTNET`` (JSON config)
    describes: one shared instance, so its op counters advance together
    across every client it is attached to. None when the variable is
    unset or does not parse (fault injection must never be the fault)."""
    raw = os.environ.get(FAULTNET_ENV)
    if not raw:
        return None
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            try:
                _GLOBAL = FaultNet.from_config(json.loads(raw))
            except (ValueError, TypeError):
                return None
        return _GLOBAL


def attach(target, faults: Optional[FaultNet]) -> None:
    """Arm (or disarm, with None) fault injection on a
    ``MiniRedisClient`` or a ``BrokerFleet`` (every current and future
    shard client)."""
    if hasattr(target, "set_faults"):       # BrokerFleet
        target.set_faults(faults)
    else:
        target._faults = faults
