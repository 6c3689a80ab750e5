"""Online RL serving loop: the Storm topology around one learner.

Counterpart of ``avenir_tpu/stream/loop.py``, with ``GroupedLearner``
(many contexts, one batched step). The reference's always-on path is a
Storm topology (ReinforcementLearnerTopology.java:42-85): RedisSpout
polls an event queue, shuffle-groups tuples to ReinforcementLearnerBolt
instances which drain rewards, call ``learner.nextActions()`` and push
selections to an action queue (ReinforcementLearnerBolt.java:93-125).
Here the topology is a host queue loop around the learner, whose state
lives on the card:

    queues in -> drain rewards (setReward) -> next actions -> queue out

in the bolt's reward-drain-then-select order, with events micro-batched
(up to 64 a batch) in ``run``.

Queue adapters: in-process deques, and a Redis adapter wire-compatible
with the reference's lists (event rpop, action lpush
``eventID,action[,action...]``, reward lindex cursor — RedisSpout.java /
RedisActionWriter.java / RedisRewardReader.java); ``redis`` is imported
only when no client is given (``stream/miniredis.py`` is one). Their bulk
methods (``pop_events``, ``write_and_ack``, ``shed_events``, ...) are the
serving engine's transport (``stream/engine.py``): a batch in about three
broker round trips.
"""

from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from avenir_tpu_torch.models.bandits.learners import (
    ALGORITHMS, FIELDS, Learner, LearnerConfig, LearnerState,
    build_action_index, resolve_action_id)
from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.obs import tracing as _tracing
from avenir_tpu_torch.utils import jrandom
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device


def split_event_timestamp(payload: str) -> Tuple[str, Optional[float]]:
    """:func:`split_event_stamp` without the trace id: ``(event_id,
    ts)``."""
    event_id, ts, _ = split_event_stamp(payload)
    return event_id, ts


def split_event_stamp(payload: str
                      ) -> Tuple[str, Optional[float], Optional[str]]:
    """Split the opt-in event stamps: bare ``id``, ``id|enqueue_ts``, or
    ``id|enqueue_ts|traceid`` (a sampled trace context). Returns
    ``(event_id, ts, trace_id)``; a payload that parses as neither comes
    back unchanged with both extras None, so the wire format is the same
    until the producer opts in."""
    head, sep, tail = payload.rpartition("|")
    if not sep:
        return payload, None, None
    try:
        return head, float(tail), None
    except ValueError:
        pass
    # the 3-field form accepts only a minted t<pid>-<seq> tail: an
    # unstamped id like "user|42|page" comes back unchanged
    if _tracing.is_trace_id(tail):
        event_id, sep2, ts = head.rpartition("|")
        if sep2:
            try:
                return event_id, float(ts), tail
            except ValueError:
                pass
    return payload, None, None


def strip_event_stamps(raws: Sequence[str], tel
                       ) -> Tuple[List[str], Optional[List[str]]]:
    """Peel enqueue timestamps and trace ids off a popped batch: returns
    ``(bare ids, the batch's trace ids or None when none appeared)``.
    Bare ids feed the action writes; callers keep ``raws`` for acks (the
    ledger stores the verbatim popped bytes). Each stamped payload's
    enqueue-to-pop gap lands in the ``engine.queue_wait`` histogram (one
    clock read a batch), and each traced payload gets a ``broker_pop``
    stamp."""
    now = time.time()
    ids: List[str] = []
    traces: Optional[List[str]] = None
    for raw in raws:
        if "|" not in raw:
            ids.append(raw)
            continue
        event_id, ts, trace = split_event_stamp(raw)
        ids.append(event_id)
        if ts is not None and tel.enabled:
            tel.record("engine.queue_wait", max(now - ts, 0.0) * 1e3)
        if trace is not None:
            if traces is None:
                traces = []
            traces.append(trace)
            _tracing.record_if_on(trace, "broker_pop", ts=now)
    return ids, traces


def record_reward_fold(tel, t_start: float, n: int) -> None:
    """The per-reward fold-time record of the ``engine.reward_fold``
    histogram (``t_start`` read just before the fold, after the drain's
    I/O). Callers gate on ``tel.enabled``."""
    if n:
        tel.record("engine.reward_fold",
                   (time.perf_counter() - t_start) * 1e3 / n, n)


# --------------------------------------------------------------------------
# queue adapters
# --------------------------------------------------------------------------

class InProcQueues:
    """Event/action/reward queues in one process (deque-backed). The bulk
    methods (``pop_events``, ``write_actions_bulk``, ``write_and_ack``,
    ``ack_events``) let the serving engine drive every adapter the same
    way; here they are loops."""

    def __init__(self):
        self.events: deque = deque()
        self.actions: deque = deque()
        self.rewards: deque = deque()
        self.reward_backlog = 0

    def push_event(self, event_id: str) -> None:
        self.events.appendleft(event_id)

    def pop_event(self) -> Optional[str]:
        return self.events.pop() if self.events else None

    def pop_events(self, max_n: int) -> List[str]:
        out = []
        while self.events and len(out) < max_n:
            out.append(self.events.pop())
        return out

    def ack_event(self, event_id: str) -> None:
        """In one process a popped event cannot be orphaned: no ledger."""

    def ack_events(self, event_ids: Sequence[str]) -> None:
        pass

    def shed_events(self, max_n: int, newest: bool = False) -> List[str]:
        """Admission control's shed: up to ``max_n`` events removed
        unserved, the newest arrivals with ``newest`` (reject-new), else
        the oldest (drop-oldest)."""
        out = []
        while self.events and len(out) < max_n:
            out.append(self.events.popleft() if newest
                       else self.events.pop())
        return out

    def push_reward(self, action_id: str, reward: float) -> None:
        self.rewards.appendleft((action_id, reward))

    def drain_rewards(self, max_items: Optional[int] = None
                      ) -> List[Tuple[str, float]]:
        out = []
        while self.rewards and (max_items is None or len(out) < max_items):
            out.append(self.rewards.pop())
        self.reward_backlog = len(self.rewards)
        return out

    def write_actions(self, event_id: str, actions: Sequence[str]) -> None:
        self.actions.appendleft((event_id, list(actions)))

    def write_actions_bulk(
            self, entries: Sequence[Tuple[str, Sequence[str]]]) -> None:
        for event_id, actions in entries:
            self.write_actions(event_id, actions)

    def write_and_ack(
            self, entries: Sequence[Tuple[str, Sequence[str]]]) -> None:
        """The write, then the acks (no ledger in one process)."""
        self.write_actions_bulk(entries)
        self.ack_events([event_id for event_id, _ in entries])

    def pop_action(self):
        return self.actions.pop() if self.actions else None

    def depth(self) -> Optional[int]:
        """Pending-event count (telemetry queue-depth gauge)."""
        return len(self.events)


class RedisQueues:
    """Wire-compatible with the reference's Redis lists."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 event_queue: str = "eventQueue",
                 action_queue: str = "actionQueue",
                 reward_queue: str = "rewardQueue",
                 field_delim: str = ",",
                 client=None,
                 pending_queue: Optional[str] = None):
        """``client`` is anything speaking rpop/lpush/lindex (the port's
        ``MiniRedisClient``, a test fake, a redis-py client); without one
        the ``redis`` package connects to ``host:port``.

        ``pending_queue`` arms the ack/replay ledger: ``pop_event``
        becomes an atomic RPOPLPUSH into the ledger, ``ack_event`` removes
        the entry once the answer is written, and :func:`reclaim_pending`
        replays whatever a dead consumer left behind. Ack-after-answer
        makes delivery at-least-once (Storm's guarantee); consumers
        deduplicate by event id to complete the exactly-once effect."""
        if client is None:
            try:
                import redis  # type: ignore
            except ImportError as exc:
                raise RuntimeError(
                    "RedisQueues needs the 'redis' package or a client "
                    "(stream.miniredis.MiniRedisClient); use InProcQueues "
                    "for one process") from exc
            client = redis.StrictRedis(host=host, port=port)
        self._r = client
        self.event_queue = event_queue
        self.action_queue = action_queue
        self.reward_queue = reward_queue
        self.pending_queue = pending_queue
        self.delim = field_delim
        # the reference's RedisRewardReader walks the list from the tail
        # (oldest under lpush producers) with a negative decrementing cursor
        self._reward_cursor = -1
        # unread rewards left behind by the last bounded drain (gauge)
        self.reward_backlog = 0
        # ledger entries are the RAW popped payloads; an ack may name the
        # event by id or by payload: id/payload -> raw bytes
        self._pending_raw: dict = {}
        # raw payload -> count of ledger entries this consumer popped and
        # has not acked: entries beyond these counts are pops whose
        # replies a dead connection swallowed (recover_in_flight)
        self._in_flight: Counter = Counter()

    # one drain_rewards call sweeps at most this many entries, a multiple
    # of the learner's fused reward chunk (256), so bounding the sweep
    # never moves a chunk boundary
    _DRAIN_MAX = 4096

    def note_popped(self, raw: bytes) -> str:
        """The bookkeeping of one raw payload popped outside this adapter
        (a sweep over several adapters' queues on one pipeline): decoded,
        and noted in the ledger's bookkeeping when it is armed, as
        ``pop_event`` and ``pop_events`` do a reply."""
        decoded = raw.decode()
        if self.pending_queue is not None:
            self._note_pending(decoded, raw)
        return decoded

    def ack_command(self, event_id: str) -> Optional[Tuple[str, int, bytes]]:
        """The (pending_queue, count, raw) LREM that retires one ledger
        entry, its bookkeeping dropped, for a caller that batches several
        adapters' acks on one pipeline. None when no ledger is armed."""
        if self.pending_queue is None:
            return None
        return (self.pending_queue, 1, self._ack_raw(event_id))

    def _note_pending(self, decoded: str, raw: bytes) -> None:
        """Key one popped payload by the full payload and by its id
        prefix, each a FIFO of raw payloads (an ack retires the oldest
        match, as LREM count=1 from the head does)."""
        self._pending_raw.setdefault(decoded, []).append(raw)
        self._pending_raw.setdefault(
            decoded.partition(self.delim)[0], []).append(raw)
        self._in_flight[raw] += 1

    def _reconnects(self) -> Optional[int]:
        """The client's reconnect counter; None for clients without the
        failover transport."""
        return getattr(self._r, "reconnects", None)

    def recover_in_flight(self) -> int:
        """After a broker failover, push back onto the event queue every
        ledger entry beyond this consumer's in-flight counts (pops whose
        replies were lost): at-least-once, deduplicated downstream.
        Returns the number replayed. Safe because each pending ledger has
        exactly one consumer."""
        if self.pending_queue is None:
            return 0
        raws = self._r.lrange(self.pending_queue, 0, -1)
        have = Counter(raws)
        n = 0
        for raw, count in have.items():
            for _ in range(count - self._in_flight.get(raw, 0)):
                # requeue before retiring the ledger copy: a crash between
                # the two leaves the event in both lists (a duplicate),
                # never in neither (a loss)
                self._r.lpush(self.event_queue, raw)
                self._r.lrem(self.pending_queue, 1, raw)
                n += 1
        return n

    def pop_event(self) -> Optional[str]:
        marker = self._reconnects()
        if self.pending_queue is not None:
            raw = self._r.rpoplpush(self.event_queue, self.pending_queue)
        else:
            raw = self._r.rpop(self.event_queue)
        if raw is not None:
            decoded = raw.decode()
            if self.pending_queue is not None:
                self._note_pending(decoded, raw)
        else:
            decoded = None
        if marker is not None and self._reconnects() != marker:
            # reconcile after noting this pop, or its own ledger entry
            # would read as an orphan
            self.recover_in_flight()
        return decoded

    def pop_events(self, max_n: int) -> List[str]:
        """Up to ``max_n`` events in one broker round trip: pipelined
        RPOPLPUSHes with the ledger armed (each move atomic, so a crash
        mid-batch loses nothing), RPOP with a count otherwise."""
        if max_n <= 0:
            return []
        marker = self._reconnects()
        if self.pending_queue is not None:
            p = self._r.pipeline()
            for _ in range(max_n):
                p.rpoplpush(self.event_queue, self.pending_queue)
            raws = p.execute()
        else:
            raws = self._r.rpop(self.event_queue, max_n) or []
        out = []
        for raw in raws:
            if raw is None:
                # an empty reply is not the end: a producer can push
                # between two pipelined pops ([nil, X, nil]), and every
                # value was moved into the ledger, so skip, do not stop
                continue
            decoded = raw.decode()
            if self.pending_queue is not None:
                self._note_pending(decoded, raw)
            out.append(decoded)
        if marker is not None and self._reconnects() != marker:
            # a failover resent the sweep: after noting this sweep's pops,
            # put the lost sweep's ledger entries back on the event queue
            self.recover_in_flight()
        return out

    def shed_events(self, max_n: int, newest: bool = False) -> List[str]:
        """Admission control's shed: up to ``max_n`` events in one broker
        command, RPOP with a count (the oldest; drop-oldest) or LPOP (the
        newest; reject-new). It bypasses the pending ledger: shed work is
        discarded by design and needs no replay. The payloads returned
        are the caller's count of what was shed."""
        if max_n <= 0:
            return []
        cmd = self._r.lpop if newest else self._r.rpop
        raws = cmd(self.event_queue, max_n)
        return [raw.decode() for raw in (raws or [])]

    def _ack_raw(self, event_id: str):
        """Resolve an ack to the verbatim raw ledger bytes and drop the
        host-side bookkeeping."""
        fifo = self._pending_raw.get(event_id)
        raw = fifo.pop(0) if fifo else event_id
        if isinstance(raw, bytes):
            decoded = raw.decode()
            for key in (decoded, decoded.partition(self.delim)[0]):
                entries = self._pending_raw.get(key)
                if entries and raw in entries:
                    entries.remove(raw)
                if entries == []:
                    del self._pending_raw[key]
            if self._in_flight[raw] > 1:
                self._in_flight[raw] -= 1
            else:
                self._in_flight.pop(raw, None)
        return raw

    def ack_event(self, event_id: str) -> None:
        """Retire one ledger entry, after the answer is written (a death
        in between leaves the event replayable)."""
        if self.pending_queue is not None:
            self._r.lrem(self.pending_queue, 1, self._ack_raw(event_id))

    def ack_events(self, event_ids: Sequence[str]) -> None:
        """Every LREM in one pipelined round trip, after the whole batch's
        answers are written (a death before it replays the batch)."""
        if self.pending_queue is None or not event_ids:
            return
        p = self._r.pipeline()
        for event_id in event_ids:
            p.lrem(self.pending_queue, 1, self._ack_raw(event_id))
        p.execute()

    def drain_rewards(self, max_items: Optional[int] = None
                      ) -> List[Tuple[str, float]]:
        """Cursor scan like RedisRewardReader, tail-first (oldest under
        lpush producers), never re-reading, in one bounded LRANGE round
        trip where the client has it. At most ``max_items`` (default
        ``_DRAIN_MAX``) entries a call; the rest is ``reward_backlog``."""
        cap = self._DRAIN_MAX if max_items is None else max(int(max_items), 0)
        out: List[Tuple[str, float]] = []
        if hasattr(self._r, "lrange"):
            pipe = getattr(self._r, "pipeline", None)
            if pipe is not None:
                p = pipe()
                self.queue_reward_sweep(p, cap)
                raws, total = p.execute()
            else:
                start = self._reward_cursor - cap + 1
                raws = self._r.lrange(self.reward_queue, start,
                                      self._reward_cursor)
                total = self._r.llen(self.reward_queue)
            return self.apply_reward_sweep(raws, total)
        # clients without lrange: the lindex walk, the same bounded sweep
        while len(out) < cap:
            raw = self._r.lindex(self.reward_queue, self._reward_cursor)
            if raw is None:
                self.reward_backlog = 0
                break
            action_id, _, reward = raw.decode().partition(self.delim)
            out.append((action_id, self._reward_value(reward)))
            self._reward_cursor -= 1
        else:
            if hasattr(self._r, "llen"):
                self.reward_backlog = max(
                    int(self._r.llen(self.reward_queue))
                    + self._reward_cursor + 1, 0)
            else:
                probe = self._r.lindex(self.reward_queue,
                                       self._reward_cursor)
                self.reward_backlog = 1 if probe is not None else 0
        return out

    def queue_reward_sweep(self, pipe, cap: int) -> None:
        """Queue this adapter's bounded reward sweep (the LRANGE window
        off the cursor and an LLEN for the backlog) on a caller's
        pipeline; :meth:`apply_reward_sweep` takes the two replies."""
        start = self._reward_cursor - cap + 1
        pipe.lrange(self.reward_queue, start, self._reward_cursor)
        pipe.llen(self.reward_queue)

    def apply_reward_sweep(self, raws, total) -> List[Tuple[str, float]]:
        """One sweep's (LRANGE, LLEN) replies: the rewards oldest first
        (LRANGE gives newest first under LPUSH producers), the cursor
        moved past them, the backlog gauge refreshed."""
        out: List[Tuple[str, float]] = []
        for raw in reversed(raws):
            action_id, _, reward = raw.decode().partition(self.delim)
            out.append((action_id, self._reward_value(reward)))
        self._reward_cursor -= len(raws)
        self.reward_backlog = max(int(total) + self._reward_cursor + 1, 0)
        return out

    @staticmethod
    def _reward_value(reward: str) -> float:
        """Reward value field -> float, peeling an opt-in trace suffix
        (``0.0|t123-64``) into a ``reward_fold`` stamp."""
        try:
            return float(reward)
        except ValueError:
            value, trace = _tracing.split_reward_trace(reward)
            _tracing.record_if_on(trace, "reward_fold")
            return value

    def write_actions(self, event_id: str, actions: Sequence[str]) -> None:
        self._r.lpush(self.action_queue,
                      self.delim.join([event_id] + list(actions)))

    def _payloads(self, entries) -> List[str]:
        return [self.delim.join([event_id] + list(actions))
                for event_id, actions in entries]

    def write_actions_bulk(
            self, entries: Sequence[Tuple[str, Sequence[str]]]) -> None:
        """One LPUSH of every payload (a multi-value LPUSH pushes left to
        right, so the queue ends as after one ``write_actions`` an
        entry)."""
        if not entries:
            return
        self._r.lpush(self.action_queue, *self._payloads(entries))

    def write_and_ack(
            self, entries: Sequence[Tuple[str, Sequence[str]]]) -> None:
        """Answer and retire a whole batch in one round trip: the LPUSH
        and every ledger LREM on one pipeline, the writes before the acks.
        The broker runs them in order, so delivery stays at-least-once: a
        death before the send replays the batch, after it the batch is
        answered and acked."""
        if not entries:
            return
        if self.pending_queue is None:
            self.write_actions_bulk(entries)
            return
        p = self._r.pipeline()
        p.lpush(self.action_queue, *self._payloads(entries))
        for event_id, _ in entries:
            p.lrem(self.pending_queue, 1, self._ack_raw(event_id))
        p.execute()

    def depth(self) -> Optional[int]:
        """Pending-event count: one broker round trip, polled only while
        telemetry is enabled."""
        try:
            return int(self._r.llen(self.event_queue))
        except Exception:
            return None


def reclaim_pending(client, pending_queue: str, event_queue: str) -> int:
    """Replay a dead consumer's un-acked events back onto their event
    queue (``replay.failed.message=true``). Entries a crashed worker
    answered but had not acked are served twice (at-least-once). Returns
    the number of events replayed."""
    n = 0
    while client.rpoplpush(pending_queue, event_queue) is not None:
        n += 1
    return n


# --------------------------------------------------------------------------
# single-learner loop (the bolt)
# --------------------------------------------------------------------------

@dataclass
class LoopStats:
    events: int = 0
    rewards: int = 0
    actions_written: int = 0
    # gauges, not checkpointed (utils.checkpoint._COUNTER_NAMES holds the
    # three counters above); queue_depth and the latency percentiles fill
    # only while telemetry is enabled
    queue_depth: int = 0        # pending events after the last batch/step
    reward_lag: int = 0         # events served minus rewards folded
    event_p50_ms: float = 0.0   # per-event serving latency percentiles
    event_p95_ms: float = 0.0   # (batch mode: batch wall time / batch size)
    event_p99_ms: float = 0.0
    swaps: int = 0              # state swaps installed
    model_version: Optional[int] = None


class OnlineLearnerLoop:
    """The ReinforcementLearnerBolt loop around one learner on ``device``.

    With ``checkpoint_dir`` the loop checkpoints the learner state and the
    counters every ``checkpoint_interval`` events, and a new loop over the
    same directory resumes from the latest step — recovery the
    reference's always-on Storm path lacks."""

    def __init__(self, learner_type: str, actions: Sequence[str],
                 config: Dict[str, Any], queues, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval: int = 100,
                 event_timestamps: bool = False,
                 swap_source: Optional[Callable[[], Optional[Tuple]]] = None,
                 device: DeviceLike = "cuda"):
        self.learner = Learner(learner_type, actions, config, seed,
                               device=device)
        self.queues = queues
        self.stats = LoopStats()
        # process-wide tracer: free no-ops while telemetry is disabled
        self._tel = telemetry.tracer()
        # opt-in ``id|ts`` payloads: actions go out under the bare id, the
        # enqueue-to-pop gap lands in engine.queue_wait, acks use the raw
        # payload
        self._event_ts = bool(event_timestamps)
        # weighted ring of (per_event_ms, n_events), one entry a batch
        self._event_ms: deque = deque(maxlen=2048)
        # polled once a step/batch; returns (version, state) to swap in
        self._swap_source = swap_source
        self._ckpt = None
        self._ckpt_mod = None
        self._ckpt_interval = max(int(checkpoint_interval), 1)
        # rewards already folded into a restored state are skipped when an
        # append-only reward source (a reward file, a Redis list read from
        # a reset cursor) is drained again after a restart
        self._skip_rewards = 0
        # events applied before the restored checkpoint; callers replaying
        # an event file skip this many lines
        self.resumed_events = 0
        if checkpoint_dir:
            from avenir_tpu_torch.utils import checkpoint as C
            self._ckpt_mod = C
            self._ckpt = C.Checkpointer(checkpoint_dir, max_to_keep=2)
            if self._ckpt.latest_step() is not None:
                state, stats, _ = C.restore_loop_state(
                    self._ckpt, self.learner.state)
                self.learner.state = state
                self.stats = LoopStats(**stats)
                self._skip_rewards = self.stats.rewards
                self.resumed_events = self.stats.events

    def swap_state(self, snapshot, version=None) -> float:
        """Install a learner-state snapshot at a step/batch boundary: as
        stopping the loop, restoring the snapshot and resuming
        (``lifecycle.swap.install_state``). Returns the swap latency in
        ms (the ``lifecycle.swap`` span)."""
        from avenir_tpu_torch.lifecycle.swap import (
            install_state, record_swap)
        t0 = time.perf_counter()
        install_state(self.learner, snapshot)
        self.stats.swaps += 1
        if version is not None:
            self.stats.model_version = version
        return record_swap(self._tel, t0, version, self.stats.swaps)

    def _maybe_swap(self) -> None:
        """Poll the swap source at the top of a step/batch, before the
        reward drain (where a stop/restore/resume re-enters)."""
        if self._swap_source is None:
            return
        pending = self._swap_source()
        if pending is not None:
            version, snapshot = pending
            self.swap_state(snapshot, version=version)

    def _drain_new_rewards_counted(self) -> Tuple[List[Tuple[str, float]],
                                                  int]:
        """(pending rewards less the checkpoint-skipped ones, the raw
        sweep's size): a bounded sweep wholly consumed by the skip filter
        is not the end of the stream."""
        pairs = []
        raw = self.queues.drain_rewards()
        for action_id, reward in raw:
            if self._skip_rewards > 0:
                self._skip_rewards -= 1
                continue
            pairs.append((action_id, reward))
        return pairs, len(raw)

    def _drain_new_rewards(self) -> List[Tuple[str, float]]:
        return self._drain_new_rewards_counted()[0]

    def _fold_reward_batch(self, pairs: List[Tuple[str, float]]) -> None:
        """Fold one drained reward batch, with the ``loop.reward_fold``
        span and the per-reward ``engine.reward_fold`` histogram."""
        tel = self._tel.enabled
        t0 = time.perf_counter() if tel else 0.0
        with self._tel.span("loop.reward_fold"):
            self.learner.set_reward_batch(pairs)
        self.stats.rewards += len(pairs)
        if tel:
            record_reward_fold(self._tel, t0, len(pairs))

    def _save_checkpoint(self) -> None:
        self._ckpt_mod.save_loop_state(
            self._ckpt, self.stats.events, self.learner.state,
            vars(self.stats))

    def _maybe_checkpoint(self, events_before: Optional[int] = None) -> None:
        """Checkpoint on interval multiples; with ``events_before``, on any
        batch that crossed a multiple."""
        if not self._ckpt:
            return
        if events_before is None:
            if self.stats.events % self._ckpt_interval == 0:
                self._save_checkpoint()
        elif (events_before // self._ckpt_interval
              != self.stats.events // self._ckpt_interval):
            self._save_checkpoint()

    def refresh_latency_stats(self) -> None:
        """Fold the recorded per-event latencies into the percentile
        gauges (on ``run`` exit and ``close``)."""
        if not self._event_ms:
            return
        pct = telemetry.percentiles_weighted(list(self._event_ms))
        self.stats.event_p50_ms = pct[50]
        self.stats.event_p95_ms = pct[95]
        self.stats.event_p99_ms = pct[99]

    def _observe_event(self, n_events: int, elapsed_ms: float,
                       decision_ms: Optional[float] = None) -> None:
        """The reward-lag gauge always; the latency ring, span histograms
        and the depth poll only while telemetry is enabled."""
        self.stats.reward_lag = max(
            0, self.stats.events - self.stats.rewards)
        if not self._tel.enabled:
            return
        per_event = elapsed_ms / max(n_events, 1)
        self._event_ms.append((per_event, n_events))
        self._tel.record("loop.event", per_event, n_events)
        if decision_ms is not None:
            self._tel.record("engine.decision_latency", decision_ms,
                             n_events)
        depth = self.queues.depth() if hasattr(
            self.queues, "depth") else None
        if depth is not None:
            self.stats.queue_depth = depth

    def close(self) -> None:
        self.refresh_latency_stats()
        if self._ckpt:
            self._ckpt.close()
            self._ckpt = None

    def __enter__(self) -> "OnlineLearnerLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def step(self) -> bool:
        """Process one event (rewards drained first, like the bolt
        :96-99). Returns False when the event queue is empty."""
        self._maybe_swap()
        t0 = time.perf_counter()
        pairs = self._drain_new_rewards()
        tel = self._tel.enabled
        t_fold = time.perf_counter() if (tel and pairs) else 0.0
        for action_id, reward in pairs:
            self.learner.set_reward(action_id, reward)
            self.stats.rewards += 1
        if tel:
            record_reward_fold(self._tel, t_fold, len(pairs))
        t_pop = time.perf_counter() if tel else t0
        raw_event = self.queues.pop_event()
        if raw_event is None:
            self.stats.reward_lag = max(
                0, self.stats.events - self.stats.rewards)
            return False
        event_id, trace = raw_event, None
        if self._event_ts:
            ids, traces = strip_event_stamps([raw_event], self._tel)
            event_id = ids[0]
            trace = traces[0] if traces else None
        if trace is not None:
            _tracing.record_if_on(trace, "dispatch")
        selections = self.learner.next_actions()
        if trace is not None:
            _tracing.record_if_on(trace, "resolve")
        self.queues.write_actions(event_id, selections)
        # ack after the answer is written, by the raw payload
        self.queues.ack_event(raw_event)
        self.stats.events += 1
        self.stats.actions_written += len(selections)
        now = time.perf_counter()
        self._observe_event(
            1, (now - t0) * 1e3,
            decision_ms=(now - t_pop) * 1e3 if tel else None)
        self._maybe_checkpoint()
        return True

    def run(self, max_events: Optional[int] = None) -> LoopStats:
        """Drain the queues to completion with event micro-batching: the
        pending rewards fold in one batch, then up to 64 pending events
        select in one batch (the bolt's drain-then-process pattern). With
        pre-filled queues the rewards each event sees are those of the
        per-event ``step`` calls; with a live reward producer, rewards
        arriving mid-batch fold at the next batch boundary.

        Wrapped in the flight recorder's crash hook: with the live
        observability layer armed, the ring's last windows land beside
        the metrics file before an exception propagates."""
        from avenir_tpu_torch.obs.timeseries import run_with_flight_dump
        return run_with_flight_dump("loop", lambda: self._run(max_events))

    def _run(self, max_events: Optional[int] = None) -> LoopStats:
        processed = 0
        batch_size = self.learner.cfg.batch_size
        event_cap = Learner._SCAN_BUCKET_MAX
        while max_events is None or processed < max_events:
            self._maybe_swap()
            t_batch = time.perf_counter()
            pairs = self._drain_new_rewards()
            if pairs:
                self._fold_reward_batch(pairs)
            tel = self._tel.enabled
            t_pop = time.perf_counter() if tel else t_batch
            events: List[str] = []
            while (len(events) < event_cap
                   and (max_events is None
                        or processed + len(events) < max_events)):
                event_id = self.queues.pop_event()
                if event_id is None:
                    break
                events.append(event_id)
            if not events:
                # drained: finish any reward backlog a bounded sweep left,
                # looping on the raw sweep size (a restored checkpoint's
                # skip filter can consume a whole sweep)
                while True:
                    pairs, raw = self._drain_new_rewards_counted()
                    if pairs:
                        self._fold_reward_batch(pairs)
                    if raw == 0:
                        break
                self.stats.reward_lag = max(
                    0, self.stats.events - self.stats.rewards)
                break
            raws = events
            traces = None
            if self._event_ts:
                events, traces = strip_event_stamps(raws, self._tel)
            _tracing.record_batch(traces, "dispatch")
            with self._tel.span("loop.select"):
                selections = self.learner.next_action_batch(
                    len(events) * batch_size)
            _tracing.record_batch(traces, "resolve")
            events_before = self.stats.events
            for i, event_id in enumerate(events):
                sel = selections[i * batch_size:(i + 1) * batch_size]
                self.queues.write_actions(event_id, sel)
                self.queues.ack_event(raws[i])
                self.stats.events += 1
                self.stats.actions_written += len(sel)
            processed += len(events)
            now = time.perf_counter()
            self._observe_event(
                len(events), (now - t_batch) * 1e3,
                decision_ms=(now - t_pop) * 1e3 if tel else None)
            self._maybe_checkpoint(events_before)
        self.refresh_latency_stats()
        return self.stats


# --------------------------------------------------------------------------
# the grouped (multi-context) learner: one batched step for every context
# --------------------------------------------------------------------------

class GroupedLearner:
    """ReinforcementLearnerGroup as one stacked state and a batched step.

    Every context shares one algorithm, config and action set; their
    states are ``LearnerState``s whose tensors are stacked on a leading
    axis ``[G, ...]``, so ``next_all`` and ``reward_all`` over all
    contexts are one batched step each: the per-algorithm functions of
    ``models/bandits/learners.py`` mapped over that axis
    (``torch.func.vmap``). Each step writes its result into the stacked
    buffers in place, as the JAX package donates them, so the state keeps
    its storage across steps. ``next_all_async`` returns the ``[G]``
    actions where the state lives with nothing read to the host: the
    engine queues the next wave before it reads this one."""

    def __init__(self, learner_type: str, n_groups: int,
                 actions: Sequence[str], config: Dict[str, Any],
                 seed: int = 0, device: DeviceLike = "cuda"):
        if learner_type not in ALGORITHMS:
            raise ValueError(f"invalid learner type:{learner_type}")
        self.algo = ALGORITHMS[learner_type]
        self.actions = list(actions)
        self._action_index = build_action_index(self.actions)
        self.n_groups = n_groups
        self.cfg = (config if isinstance(config, LearnerConfig)
                    else LearnerConfig.from_dict(config))
        self.device = resolve_device(device)
        keys = jrandom.split(jrandom.prng_key(seed, self.device), n_groups)
        self.states = _stack_states(
            [self.algo.init(keys[g], len(self.actions), self.cfg)
             for g in range(n_groups)])
        # XLA compiles UCB's scaled reward over two or more contexts as a
        # scatter of a product rounded apart; over one it fuses the two
        self._reward_kw = (
            {"contract": False} if n_groups > 1 and learner_type in (
                "upperConfidenceBoundOne", "upperConfidenceBoundTwo")
            else {})

    def _step(self, fn, *args) -> Any:
        """``fn(state, *args) -> (state[, out])`` mapped over the contexts;
        the new state written into the stacked buffers."""
        names = [name for name, _ in FIELDS]

        def one(leaves, *xs):
            out = fn(LearnerState(**dict(zip(names, leaves))), *xs)
            state, rest = (out if isinstance(out, tuple) else (out, None))
            leaves = tuple(getattr(state, name) for name in names)
            return leaves if rest is None else (leaves, rest)

        leaves = tuple(getattr(self.states, name) for name in names)
        out = torch.func.vmap(one)(leaves, *args)
        new, rest = (out if isinstance(out[0], tuple) else (out, None))
        for old, value in zip(leaves, new):
            old.copy_(value)
        return rest

    def next_all_async(self):
        """One step for every context; the ``[G]`` actions where the state
        lives, nothing read to the host."""
        return self._step(lambda s: self.algo.next_action(s, self.cfg))

    def resolve_actions(self, actions) -> List[str]:
        """The blocking read of a ``next_all_async`` handle: action ids."""
        return [self.actions[int(a)] for a in actions.cpu().tolist()]

    def next_all(self) -> List[str]:
        """One action per context, one batched step for all of them."""
        return self.resolve_actions(self.next_all_async())

    def _resolve_action(self, action_id: str) -> int:
        return resolve_action_id(self._action_index, action_id)

    def reward_all(self, action_ids: Sequence[str],
                   rewards: Sequence[float]) -> None:
        idx = torch.tensor([self._resolve_action(a) for a in action_ids],
                           dtype=torch.int64, device=self.device)
        rew = torch.tensor(rewards, dtype=torch.float32, device=self.device)
        self._step(lambda s, a, r: self.algo.set_reward(
            s, a, r, cfg=self.cfg, **self._reward_kw), idx, rew)

    def reward_masked(self, action_idx, rewards, mask) -> None:
        """Apply (action index, reward) to the contexts where ``mask`` is
        True, in one batched step; the other contexts keep their state bit
        for bit (the update is computed and dropped by a ``where`` on
        every field)."""

        def masked(s, a, r, m):
            new = self.algo.set_reward(s, a, r, cfg=self.cfg,
                                       **self._reward_kw)
            return new.replace(**{
                name: torch.where(m, getattr(new, name), getattr(s, name))
                for name, _ in FIELDS})
        self._step(masked,
                   torch.as_tensor(action_idx, dtype=torch.int64).to(
                       self.device),
                   torch.as_tensor(rewards, dtype=torch.float32).to(
                       self.device),
                   torch.as_tensor(mask, dtype=torch.bool).to(self.device))


def _stack_states(states):
    """``LearnerState``s of one shape -> one of tensors stacked on a new
    leading axis."""
    return LearnerState(**{name: torch.stack([getattr(s, name)
                                              for s in states])
                           for name, _ in FIELDS})
