"""Sharded broker fleet: the queue keyspace partitioned by group across
brokers.

Counterpart of ``avenir_tpu/stream/fleet.py`` over the port's
``stream/miniredis.py`` and ``stream/loop.RedisQueues``, with the same
routing maps and the same wire. One MiniRedis broker is a single-core
Python event loop: past a few workers it saturates before the learners
do. The fleet partitions the queue keyspace across N brokers, as the
reference's Storm topology would scale its Redis tier:

- **Consistent-hash routing** (:func:`consistent_route`): every group's
  key family (``eventQueue:<g>``, ``pendingQueue:<g>``,
  ``rewardQueue:<g>`` and its share of ``actionQueue``) lives wholly on
  one shard, chosen by a hash ring over the shard ids. The ring is seeded
  from md5, so every process computes the same map (``hash()`` is salted
  a process), and smoothed with virtual nodes, so adding or removing a
  broker moves about 1/N of the groups.
- **Client layer** (:class:`BrokerFleet`): one lazily dialed
  ``MiniRedisClient`` a shard; the reconnect counter and the
  ``recover_in_flight`` ledger reconciliation are per connection and per
  group.
- **Fan-out transport** (:class:`ShardedQueues`): the union queue view
  over a worker's groups. Each bulk op (``pop_events``,
  ``write_and_ack``, ``drain_rewards``, ``shed_events``) builds one
  pipelined sweep an owned shard and runs the sweeps concurrently (socket
  I/O releases the GIL), keeping every per-group invariant: pops are
  atomic RPOPLPUSH moves into the group's ledger, acks retire the
  verbatim raw bytes, shed accounting is exact (every retired payload is
  returned), and a shard's reconnect reconciles its groups' ledgers
  (``recover_in_flight``) as on one broker. A shard's error propagates
  once every sweep has settled: no sweep swallows it.
- :func:`migrate_group_queues` moves a re-routed group's queues from its
  old shard to its new one.

The fleet is opt-in (``broker.shards``); one broker never imports it.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.stream.loop import RedisQueues
from avenir_tpu_torch.stream.miniredis import (
    MiniRedisClient, connect_with_retry)

#: vnodes per shard on the hash ring: enough to smooth the partition
#: (spread stays within a few percent of even at 64) without making the
#: ring build measurable. Part of the routing contract — changing it
#: remaps groups, so it travels with the record implicitly via the
#: routing map itself (workers consume the MAP, never re-derive it).
DEFAULT_VNODES = 64


def _hash64(key: str) -> int:
    """Stable 64-bit ring position. md5, NOT ``hash()``: Python salts
    string hashes per process (PYTHONHASHSEED), and the one property a
    routing map must have is that every process computes the same one."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


def consistent_route(groups: Sequence[str], shard_ids: Sequence[int],
                     vnodes: int = DEFAULT_VNODES) -> Dict[str, int]:
    """Group -> shard id via a consistent-hash ring: each shard owns
    ``vnodes`` points; a group lands on the first point clockwise of its
    own hash. Deterministic across processes; adding/removing one shard
    re-homes only the groups whose arc the change touched (~1/N)."""
    shards = sorted(set(int(s) for s in shard_ids))
    if not shards:
        raise ValueError("cannot route groups over an empty fleet")
    points: List[Tuple[int, int]] = sorted(
        (_hash64(f"shard:{sid}:vnode:{v}"), sid)
        for sid in shards for v in range(vnodes))
    keys = [p for p, _ in points]
    out: Dict[str, int] = {}
    for g in groups:
        i = bisect.bisect_right(keys, _hash64(f"group:{g}")) % len(points)
        out[g] = points[i][1]
    return out


def parse_endpoints(spec) -> List[Tuple[str, int]]:
    """Broker endpoints from ``"host:port,host:port"`` (or an iterable
    of strings / (host, port) pairs). Order matters: the index is the
    shard id."""
    if isinstance(spec, str):
        items: Sequence = [s for s in spec.split(",") if s.strip()]
    else:
        items = list(spec)
    out: List[Tuple[str, int]] = []
    for item in items:
        if isinstance(item, (tuple, list)):
            host, port = item
        else:
            host, _, port = str(item).strip().rpartition(":")
            if not host:
                raise ValueError(
                    f"broker endpoint {item!r} is not host:port")
        out.append((str(host), int(port)))
    if not out:
        raise ValueError("no broker endpoints in spec")
    return out


def format_endpoints(endpoints: Sequence[Tuple[str, int]]) -> List[str]:
    return [f"{host}:{port}" for host, port in endpoints]


class BrokerFleet:
    """One client per broker shard, dialed lazily and shared, each with
    the client's default socket timeout; a broker that is still starting
    is dialed again for up to ``_CONNECT_TIMEOUT`` seconds."""

    _CONNECT_TIMEOUT = 10.0

    def __init__(self, endpoints):
        self.endpoints = parse_endpoints(endpoints)
        self._clients: Dict[int, MiniRedisClient] = {}
        self._lock = threading.Lock()
        self._faults = None

    @property
    def n_shards(self) -> int:
        return len(self.endpoints)

    def client(self, shard: int) -> MiniRedisClient:
        """The shard's client, dialing on first use."""
        shard = int(shard)
        with self._lock:
            c = self._clients.get(shard)
            if c is not None:
                return c
        host, port = self.endpoints[shard]
        c = connect_with_retry(host, port, timeout=self._CONNECT_TIMEOUT,
                               faults=self._faults)
        with self._lock:
            # a concurrent dial may have won; keep ONE client per shard
            live = self._clients.setdefault(shard, c)
        if live is not c:
            c.close()
        return live

    def set_faults(self, faults) -> None:
        """Arm (or disarm, with None) deterministic fault injection on
        every current and future shard client (``stream/faultnet.py``)."""
        with self._lock:
            self._faults = faults
            clients = list(self._clients.values())
        for c in clients:
            c._faults = faults

    def flushall(self) -> None:
        for shard in range(self.n_shards):
            self.client(shard).flushall()

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


class ShardedQueues:
    """Union queue view over one worker's owned groups across a fleet.

    Events/rewards for group ``g`` live wholly on ``routing[g]``; this
    adapter presents them as ONE queue surface speaking the same bulk
    protocol the serving engines already drive (``pop_events`` /
    ``write_and_ack`` / ``drain_rewards`` / ``shed_events`` /
    ``depth``), with each bulk op issuing one pipelined sweep per owned
    shard, concurrently. Per-group semantics are exactly the
    single-broker ``RedisQueues``'s — each group keeps its own ledger,
    reward cursor and backlog gauge through a private sub-adapter — so
    exactly-once-after-dedup and exact shed accounting carry over
    unchanged.

    Payloads follow the
    :class:`~avenir_tpu_torch.stream.engine.GroupedServingEngine`
    contract: events arrive as ``"<group><delim><rest>"`` (acks route on
    the prefix), drained rewards come back as
    ``("<group><delim><action>", value)``. ``stop_sentinel`` arms
    per-group retirement: a popped sentinel is acked, its group drops out
    of every later sweep, and ``stopped`` turns True once every group
    retired (a shed sweep that swallows a sentinel pushes it back)."""

    def __init__(self, fleet: BrokerFleet, groups: Sequence[str],
                 routing: Dict[str, int], *,
                 stop_sentinel: Optional[str] = None,
                 group_delim: str = ":", field_delim: str = ","):
        if not groups:
            raise ValueError("ShardedQueues needs at least one group")
        self._fleet = fleet
        self.groups = list(groups)
        self.routing = {g: int(routing[g]) for g in self.groups}
        self._delim = group_delim
        self.delim = field_delim
        self._sentinel = stop_sentinel
        self._stopped: Dict[str, bool] = {g: False for g in self.groups}
        self._sub: Dict[str, RedisQueues] = {
            g: RedisQueues(event_queue=f"eventQueue:{g}",
                           action_queue="actionQueue",
                           reward_queue=f"rewardQueue:{g}",
                           pending_queue=f"pendingQueue:{g}",
                           field_delim=field_delim,
                           client=fleet.client(self.routing[g]))
            for g in self.groups}
        self.reward_backlog = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        # rotating start offset for budget splits: when a sweep's cap is
        # smaller than the group count, the remainder (and any zero
        # budgets) must not always fall on the same tail groups —
        # fairness across sweeps, not just within one
        self._rr = 0

    # -- fan-out plumbing ---------------------------------------------------

    def _shards(self) -> List[int]:
        return sorted(set(self.routing.values()))

    def _by_shard(self, groups: Sequence[str]) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for g in groups:
            out.setdefault(self.routing[g], []).append(g)
        return out

    def _live_groups(self) -> List[str]:
        return [g for g in self.groups if not self._stopped[g]]

    def _fanout(self, jobs: Dict[int, Callable[[], object]]
                ) -> Dict[int, object]:
        """Run one job per shard; concurrently when there is more than
        one shard (each job owns its shard's client for the duration —
        the client's own lock serializes any stray sharing). The first
        failure propagates after every job settles, so a raising shard
        can never leave another shard's sweep mid-flight."""
        if len(jobs) <= 1:
            return {s: fn() for s, fn in jobs.items()}
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(len(self._shards()), 1),
                thread_name_prefix="fleet-sweep")
        futs = {s: self._pool.submit(fn) for s, fn in sorted(jobs.items())}
        out: Dict[int, object] = {}
        first_exc: Optional[BaseException] = None
        for s, f in futs.items():
            try:
                out[s] = f.result()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
        return out

    def _group_of(self, event_id: str) -> str:
        group = event_id.partition(self._delim)[0]
        if group not in self._sub:
            raise ValueError(f"event {event_id!r} routes to group "
                             f"{group!r}, which this view does not own "
                             f"(owned: {self.groups})")
        return group

    @staticmethod
    def _split_budget(n: int, parts: int) -> List[int]:
        """n split across parts, summing to exactly n (the union sweep
        must never over-pop its caller's cap)."""
        base, rem = divmod(max(n, 0), max(parts, 1))
        return [base + (1 if i < rem else 0) for i in range(parts)]

    def _budgets(self, groups: List[str], n: int) -> Dict[str, int]:
        """Per-group budgets summing to exactly ``n``, with the split's
        remainder rotating across calls so no group systematically
        starves when ``n`` < the group count."""
        if not groups:
            return {}
        off = self._rr % len(groups)
        self._rr += 1
        order = groups[off:] + groups[:off]
        return dict(zip(order, self._split_budget(n, len(order))))

    # -- events -------------------------------------------------------------

    def pop_events(self, max_n: int) -> List[str]:
        """Up to ``max_n`` events across every live owned group: one
        pipelined RPOPLPUSH sweep per owned shard (groups round-robin
        interleaved within the shard's pipeline), sweeps concurrent
        across shards. Every non-nil reply was atomically moved into ITS
        group's ledger server-side; holes are skipped exactly like the
        single-broker sweep. A shard whose client reconnected mid-sweep
        reconciles that shard's groups' ledgers afterward
        (``recover_in_flight``) — strictly after the replies are noted,
        the single-broker ordering discipline."""
        if max_n <= 0:
            return []
        live = self._live_groups()
        if not live:
            return []
        budgets = self._budgets(live, max_n)
        by_shard = self._by_shard([g for g in live if budgets[g] > 0])

        def sweep(shard: int, groups: List[str]):
            client = self._fleet.client(shard)
            marker = client.reconnects
            plan: List[str] = []
            p = client.pipeline()
            remaining = {g: budgets[g] for g in groups}
            while any(remaining.values()):
                for g in groups:           # round-robin: fairness per sweep
                    if remaining[g] > 0:
                        remaining[g] -= 1
                        p.rpoplpush(f"eventQueue:{g}", f"pendingQueue:{g}")
                        plan.append(g)
            return marker, plan, p.execute()

        results = self._fanout(
            {s: (lambda s=s, gs=gs: sweep(s, gs))
             for s, gs in by_shard.items()})
        out: List[str] = []
        for shard in sorted(results):
            marker, plan, replies = results[shard]
            client = self._fleet.client(shard)
            retired: set = set()
            for g, raw in zip(plan, replies):
                if raw is None:
                    continue
                sub = self._sub[g]
                decoded = sub.note_popped(raw)
                if self._sentinel is not None and decoded == self._sentinel:
                    sub.ack_event(decoded)     # the sentinel needs no replay
                    self._stopped[g] = True
                    retired.add(g)
                    continue
                if g in retired:
                    # a real event popped AFTER the group's sentinel in
                    # this same pipelined sweep (an at-least-once requeue
                    # landing post-sentinel, or a concurrent-owner
                    # overlap): the pop already moved it into the ledger
                    # server-side, and this view will never sweep the
                    # group again — push it back for whoever still
                    # serves the group, THEN retire the ledger copy
                    # (queue-before-lrem: a crash in between degrades to
                    # a dedup'd duplicate, never loss)
                    client.lpush(f"eventQueue:{g}", raw)
                    sub.ack_event(decoded)
                    continue
                out.append(decoded)
            if client.reconnects != marker:
                # the shard failed over mid-sweep: reclaim ITS groups'
                # orphaned ledger entries, after the notes above
                for g in by_shard[shard]:
                    self._sub[g].recover_in_flight()
        return out

    def pop_event(self) -> Optional[str]:
        events = self.pop_events(1)
        return events[0] if events else None

    def ack_events(self, event_ids: Sequence[str]) -> None:
        """Every ledger LREM in one pipelined round trip per shard,
        concurrent across shards."""
        if not event_ids:
            return
        cmds: Dict[int, List[Tuple[str, int, object]]] = {}
        for event_id in event_ids:
            g = self._group_of(event_id)
            cmd = self._sub[g].ack_command(event_id)
            if cmd is not None:
                cmds.setdefault(self.routing[g], []).append(cmd)

        def sweep(shard: int, triples):
            p = self._fleet.client(shard).pipeline()
            for queue, count, raw in triples:
                p.lrem(queue, count, raw)
            p.execute()

        self._fanout({s: (lambda s=s, t=t: sweep(s, t))
                      for s, t in cmds.items()})

    def ack_event(self, event_id: str) -> None:
        self.ack_events([event_id])

    def write_actions(self, event_id: str, actions: Sequence[str]) -> None:
        self._sub[self._group_of(event_id)].write_actions(event_id, actions)

    def write_actions_bulk(self, entries) -> None:
        by_shard: Dict[int, List[str]] = {}
        for event_id, actions in entries:
            g = self._group_of(event_id)
            by_shard.setdefault(self.routing[g], []).append(
                self.delim.join([event_id] + list(actions)))

        def sweep(shard: int, payloads: List[str]):
            self._fleet.client(shard).lpush("actionQueue", *payloads)

        self._fanout({s: (lambda s=s, p=p: sweep(s, p))
                      for s, p in by_shard.items()})

    def write_and_ack(self, entries) -> None:
        """Answer + retire a batch: per owned shard, ONE pipeline
        carrying that shard's multi-value action LPUSH followed by its
        ledger LREMs — writes strictly before acks in command order on
        every shard, so the at-least-once window stays the broker's own
        sequencing, per shard. Shards proceed concurrently: a worker
        death mid-call leaves each shard either fully
        answered-and-acked or fully replayable, never a torn shard."""
        if not entries:
            return
        plan: Dict[int, Tuple[List[str], List]] = {}
        for event_id, actions in entries:
            g = self._group_of(event_id)
            payloads, acks = plan.setdefault(self.routing[g], ([], []))
            payloads.append(self.delim.join([event_id] + list(actions)))
            cmd = self._sub[g].ack_command(event_id)
            if cmd is not None:
                acks.append(cmd)

        def sweep(shard: int, payloads: List[str], acks) -> None:
            p = self._fleet.client(shard).pipeline()
            p.lpush("actionQueue", *payloads)
            for queue, count, raw in acks:
                p.lrem(queue, count, raw)
            p.execute()

        self._fanout({s: (lambda s=s, pl=pl: sweep(s, *pl))
                      for s, pl in plan.items()})

    def shed_events(self, max_n: int, newest: bool = False) -> List[str]:
        """Admission shed across the union: one pipelined bulk-pop sweep
        per owned shard (RPOP count per group for drop-oldest, LPOP
        count for reject-new), concurrent across shards, ledger
        deliberately bypassed — the single-broker shed contract. Every
        retired payload is returned: the exact-accounting record sums
        across shards with no gaps. A swallowed stop sentinel is pushed
        back to its queue head."""
        if max_n <= 0:
            return []
        live = self._live_groups()
        if not live:
            return []
        budgets = self._budgets(live, max_n)
        by_shard = self._by_shard([g for g in live if budgets[g] > 0])

        def sweep(shard: int, groups: List[str]):
            client = self._fleet.client(shard)
            p = client.pipeline()
            for g in groups:
                if newest:
                    p.lpop(f"eventQueue:{g}", budgets[g])
                else:
                    p.rpop(f"eventQueue:{g}", budgets[g])
            return p.execute()

        results = self._fanout(
            {s: (lambda s=s, gs=gs: sweep(s, gs))
             for s, gs in by_shard.items()})
        out: List[str] = []
        for shard in sorted(results):
            for g, raws in zip(by_shard[shard], results[shard]):
                for raw in (raws or []):
                    decoded = raw.decode()
                    if (self._sentinel is not None
                            and decoded == self._sentinel):
                        # never discard the retire signal
                        self._fleet.client(shard).lpush(
                            f"eventQueue:{g}", self._sentinel)
                        continue
                    out.append(decoded)
        return out

    # -- rewards ------------------------------------------------------------

    def drain_rewards(self, max_items: Optional[int] = None
                      ) -> List[Tuple[str, float]]:
        """Bounded reward sweep across every owned group (stopped groups
        included — their backlogs still need folding at shutdown): per
        owned shard ONE pipeline carrying each group's LRANGE+LLEN
        cursor sweep, concurrent across shards. Pairs come back
        ``("<group><delim><action>", value)`` so a multi-group consumer
        can route the fold; per-group cursors/backlogs live in the
        sub-adapters exactly as on one broker."""
        cap_total = (RedisQueues._DRAIN_MAX if max_items is None
                     else max(int(max_items), 0))
        budgets = self._budgets(list(self.groups), cap_total)
        by_shard = self._by_shard([g for g in self.groups
                                   if budgets[g] > 0])
        if not by_shard:
            return []

        def sweep(shard: int, groups: List[str]):
            p = self._fleet.client(shard).pipeline()
            for g in groups:
                self._sub[g].queue_reward_sweep(p, budgets[g])
            return p.execute()

        results = self._fanout(
            {s: (lambda s=s, gs=gs: sweep(s, gs))
             for s, gs in by_shard.items()})
        out: List[Tuple[str, float]] = []
        for shard in sorted(results):
            replies = results[shard]
            for i, g in enumerate(by_shard[shard]):
                raws, total = replies[2 * i], replies[2 * i + 1]
                for action_id, value in self._sub[g].apply_reward_sweep(
                        raws, total):
                    out.append((f"{g}{self._delim}{action_id}", value))
        self.reward_backlog = sum(s.reward_backlog
                                  for s in self._sub.values())
        return out

    # -- introspection ------------------------------------------------------

    def depth(self) -> Optional[int]:
        """Pending events across every live owned group: one pipelined
        LLEN sweep per shard."""
        live = self._live_groups()
        if not live:
            return 0
        by_shard = self._by_shard(live)

        def sweep(shard: int, groups: List[str]):
            p = self._fleet.client(shard).pipeline()
            for g in groups:
                p.llen(f"eventQueue:{g}")
            return p.execute()

        results = self._fanout(
            {s: (lambda s=s, gs=gs: sweep(s, gs))
             for s, gs in by_shard.items()})
        return sum(int(v) for replies in results.values() for v in replies)

    def recover_in_flight(self) -> int:
        return sum(s.recover_in_flight() for s in self._sub.values())

    def pending_left(self) -> int:
        """Un-acked ledger entries across owned groups (harness gate)."""
        return sum(int(self._fleet.client(self.routing[g]).llen(
            f"pendingQueue:{g}")) for g in self.groups)

    @property
    def stopped(self) -> bool:
        return all(self._stopped.values())

    def stopped_groups(self) -> List[str]:
        return sorted(g for g, s in self._stopped.items() if s)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def migrate_group_queues(fleet: BrokerFleet, group: str, old: int,
                         new: int, tail: bool = True) -> int:
    """Move a re-routed group's key family from its old shard to its new
    one: the event queue and reward queue copy wholesale, and the
    pending ledger REPLAYS onto the new event queue (a ledger entry is
    an un-acked pop; its old consumer can no longer ack across the
    move). Copy-then-delete: a coordinator crash between the two leaves
    the entries on BOTH shards — re-served and absorbed by dedup —
    never on neither. Returns entries moved.

    ``tail=True`` is the INITIAL splice, performed synchronously at the
    record flip: the moved entries predate anything a new-record
    producer pushed, so they land BELOW the fresh ones (RPUSH,
    newest-first) — consumers pop oldest-first as if the queues had
    always been one, and a kept group's tail-relative reward cursor
    (its consumed prefix = the old queue's oldest entries, still at the
    extreme tail) survives the move. ``tail=False`` is for LATER
    straggler sweeps: those entries arrived AFTER the flip, are
    unconsumed by construction, and must land at the head like any
    fresh producer push — a tail splice there would bury them below a
    kept consumer's cursor (never read) while shifting consumed
    rewards back into its window (double-folded).

    The old side is cleared by LREM-ing EXACTLY the copied entries
    (one occurrence per copied instance, pipelined), never DEL: a
    stale producer pushing to the old shard between the snapshot and
    the clear must have its entry survive for the next straggler
    sweep — a DEL would erase it uncopied, the one loss this layer
    exists to prevent. (With byte-equal duplicates LREM may remove the
    newer twin; the net multiset is identical.)"""
    oc, nc = fleet.client(old), fleet.client(new)
    moved = 0
    for src, dst in ((f"eventQueue:{group}", f"eventQueue:{group}"),
                     (f"pendingQueue:{group}", f"eventQueue:{group}"),
                     (f"rewardQueue:{group}", f"rewardQueue:{group}")):
        raws = oc.lrange(src, 0, -1)     # head->tail = newest->oldest
        if not raws:
            continue
        if tail:
            nc.rpush(dst, *raws)
        else:
            nc.lpush(dst, *reversed(raws))
        moved += len(raws)
        p = oc.pipeline()
        for raw in raws:
            p.lrem(src, 1, raw)
        p.execute()
    return moved
