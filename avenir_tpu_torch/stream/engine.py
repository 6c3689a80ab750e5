"""The pipelined serving engine: a batch's decisions queued on the card
while the host does the previous batch's queue I/O.

Counterpart of ``avenir_tpu/stream/engine.py``: ``ServingEngine``,
``AdmissionControl``, ``BoostServingLearner``, ``AnnServingLearner`` and
``GroupedServingEngine`` (the multi-context engine over one stacked
``GroupedLearner``). ``OnlineLearnerLoop.run`` is synchronous: drain
rewards, select a micro-batch, wait for the card, write each action to the
queue one broker round trip at a time. The engine takes apart what needed
no waiting:

- **Dispatch, then fetch**: batch n+1's decisions are queued
  (``Learner.next_action_batch_async``, which reads nothing to the host)
  before batch n's actions are read and written, so the card computes
  while the host talks to the queues, and the host waits only for a
  result that is late.
- **Bulk transport**: one pipelined RPOPLPUSH sweep pops the batch, one
  bounded LRANGE sweep drains the rewards, one LPUSH writes every answer
  and the ledger's LREMs ride with it: about three round trips a batch
  (``stream.loop.RedisQueues``' bulk methods), the pending ledger's
  at-least-once delivery and each entry's wire format unchanged.
- **Adaptive micro-batching**: the event cap grows toward
  ``Learner._SCAN_BUCKET_MAX`` while pops come back full (throughput
  under a backlog) and shrinks toward ``min_batch`` when the queue runs
  shallow (latency when idle).
- **Admission control** (``AdmissionControl``): past a high-water mark of
  queue depth, events are retired unserved, counted exactly, until the
  depth falls to the low-water mark.

Against ``run()``: on queues filled before the run the engine writes the
same actions, byte for byte, and leaves the same state, bit for bit: it
calls the same state updates in the same order, its cap starts at the
loop's 64, and its drain bound is a multiple of the fused reward chunk.
With a live reward producer a reward that arrives while batch n is in
flight folds before batch n+2's decisions (``run()`` folds it before
n+1's): one batch more of staleness, the price of the overlap.

Telemetry, free while the tracer is off: spans ``engine.select`` (the
host waiting for a batch's actions), ``engine.io`` (queue I/O a batch),
``engine.decision_latency`` (pop to action written, one record a batch
weighted by its events) and ``engine.shed``; hub gauges
``engine.overlap_fraction``, ``engine.queue_depth``,
``engine.reward_backlog``, ``engine.shed_total``, ``engine.shedding``.
With ``event_timestamps`` (producers stamping ``id|enqueue_ts``) the
enqueue-to-pop gap lands in ``engine.queue_wait``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.models.bandits.learners import Learner
from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.obs import tracing as _tracing
from avenir_tpu_torch.utils.device import DeviceLike


@dataclass
class EngineStats:
    """Counters and overlap accounting of an engine, summed over its
    ``run`` calls."""

    events: int = 0
    rewards: int = 0
    actions_written: int = 0
    batches: int = 0
    swaps: int = 0                # states swapped in
    model_version: Optional[int] = None   # the version serving now
    # events popped and retired unserved past the high-water mark: events
    # + shed_total is every event the engine popped
    shed_total: int = 0
    select_wait_ms: float = 0.0   # host waiting for the card's actions
    io_ms: float = 0.0            # queue I/O
    dispatch_ms: float = 0.0      # host time queueing the card's work
    queue_depth: int = 0          # pending events (polled with telemetry)
    reward_backlog: int = 0       # unread rewards after the last drain
    batch_cap: int = 0            # the adaptive cap when run() returned
    # the cap a batch, bounded for an engine that lives as long as its
    # process: past the bound the oldest half goes, counted in
    # history_dropped
    cap_history: List[int] = field(default_factory=list)
    history_dropped: int = 0
    _CAP_HISTORY_MAX = 1024

    def note_cap(self, cap: int) -> None:
        self.cap_history.append(cap)
        if len(self.cap_history) > self._CAP_HISTORY_MAX:
            drop = self._CAP_HISTORY_MAX // 2
            del self.cap_history[:drop]
            self.history_dropped += drop

    @property
    def overlap_fraction(self) -> float:
        """The share of the host's time outside dispatch spent on queue
        I/O rather than waiting for the card: ``io / (io +
        select_wait)``. 1.0: every read found its actions computed, the
        I/O hid the card's work; 0.0: the engine waited as the loop does."""
        total = self.io_ms + self.select_wait_ms
        if total <= 0.0:
            return 1.0
        return min(max(self.io_ms / total, 0.0), 1.0)


def _publish_engine_gauges(stats: EngineStats,
                           extra: Optional[Dict[str, float]] = None
                           ) -> None:
    """The engine's gauges to the telemetry hub, while it is live."""
    if not telemetry.tracer().enabled:
        return
    from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
    gauges = {
        "engine.overlap_fraction": stats.overlap_fraction,
        "engine.reward_backlog": stats.reward_backlog,
        "engine.shed_total": stats.shed_total,
        "engine.history_dropped": stats.history_dropped,
    }
    if extra:
        gauges.update(extra)
    set_hub_gauges_if_live(gauges)


def warm_serving_paths(learner: Learner, rewards: bool = True) -> None:
    """Run every decomposition of a batch a live serving run can reach on
    ``learner`` once, before real traffic: each power-of-two fused chunk
    up to the cap, ``64 + k`` for the scalar remainders, and the same
    sizes of reward folds. On the card the first call of each shape pays
    its kernels' first loads and its allocations; inside a live batch
    that would stretch its decision latency. It changes the learner's
    state (selects advance the key, rewards update the counts): callers
    keep a copy of the state and restore it, or warm before traffic."""
    cap = max(Learner._SCAN_BUCKET_MAX * learner.cfg.batch_size, 1)
    r = 1
    while r <= min(cap, learner._FUSED_CHUNK_MAX):
        learner.resolve_action_batch(learner.next_action_batch_async(r))
        r *= 2
    for extra in (1, 2, 3, 5, 9, 17, 33):
        learner.resolve_action_batch(
            learner.next_action_batch_async(
                Learner._SCAN_BUCKET_MAX + extra))
    if not rewards:
        return
    action = learner.actions[0]
    r = 1
    while r <= learner._FUSED_CHUNK_MAX:
        learner.set_reward_batch([(action, 0.0)] * r)
        r *= 2
    for extra in (1, 2, 3, 5, 9, 17, 33):
        learner.set_reward_batch(
            [(action, 0.0)] * (Learner._SCAN_BUCKET_MAX + extra))


class BoostServingLearner:
    """Boosted-forest scoring behind the engine's learner protocol: the
    dispatch-then-fetch loop, the pending-ledger transport, admission
    control and the lifecycle's hot swap that serve bandits serve
    gradient-boosted margins. An event is a scoring request; the action
    written back is the predicted class label.

    The state is :func:`models.boost.serving_tables`' dict of tensors,
    every shape a function of (schema, rounds_budget, node_budget), so a
    drift retrain's model passes ``install_state``'s structure and shape
    check and swaps in between batches (``depth`` is a cap: a route past
    a leaf stays, so one cap serves every model under it). The feature
    rows are a ring of binned ids on the tables' device
    (:func:`models.boost.serving_bins` order): an n-event batch scores
    the next n rows, padded to a power of two, and
    ``next_action_batch_async`` only queues the card's work, reading
    nothing back, so the engine overlaps the read with its queue I/O as
    it does a bandit's."""

    def __init__(self, tables: Dict[str, Any], bins, class_values:
                 Sequence[str], *, depth: int, batch_size: int = 1):
        import types
        import torch
        self.state = tables
        self.actions = list(class_values)
        self.cfg = types.SimpleNamespace(batch_size=batch_size)
        dev = tables["split_col"].device
        self._bins = torch.as_tensor(bins, dtype=torch.int32).to(dev)
        self._depth = int(depth)
        self._cursor = 0
        self.reward_count = 0
        self.reward_sum = 0.0

    @staticmethod
    def _bucket(n: int) -> int:
        m = 1
        while m < n:
            m *= 2
        return m

    def warm(self, max_batch: int) -> None:
        """Run each power-of-two batch up to ``max_batch`` once, before
        live traffic (scoring changes no state)."""
        m = 1
        while m <= self._bucket(max_batch):
            self.resolve_action_batch(self.next_action_batch_async(m))
            m *= 2

    def next_action_batch_async(self, n: int):
        import torch
        from avenir_tpu_torch.models.boost import _serve_margins
        m = self._bucket(n)
        rows = self._bins.shape[0]
        idx = (torch.arange(m, device=self._bins.device)
               + self._cursor) % rows
        self._cursor = (self._cursor + n) % rows
        _margin, cls = _serve_margins(self.state,
                                      self._bins.index_select(0, idx),
                                      depth=self._depth)
        return (cls, n)

    def resolve_action_batch(self, handle) -> List[str]:
        cls, n = handle
        return [self.actions[c] for c in cls[:n].cpu().tolist()]

    def set_reward_batch(self, pairs: Sequence[Tuple[str, float]]) -> None:
        """Outcome feedback: boosting has no online update (the lifecycle's
        retrain is the update), so rewards only accumulate, where the
        engine's DriftMonitor taps them."""
        for _action, reward in pairs:
            self.reward_count += 1
            self.reward_sum += float(reward)


class AnnServingLearner:
    """Similar-user lookup behind the engine's learner protocol: an event
    is a "find users like this one" request, the action written back is
    the nearest neighbor's row id, and the model served is a
    :class:`~avenir_tpu_torch.models.live_ann.LiveAnnIndex`, so its recall
    under appends rides the engine's dispatch-then-fetch, its gates and
    its hot swap as any learner's.

    A rebuilt index is not shaped as the one it replaces (its lists
    depend on the grown table), so a swap goes through the learner's own
    :meth:`install_state` (``lifecycle.swap.install_state`` hands it the
    snapshot): the engine's swap protocol (batch boundary, the
    ``lifecycle.swap`` span, the version gauges) is a bandit's, the
    install is ``LiveAnnIndex.adopt`` with its tail replay. Appends
    (``live.append``) happen outside the learner.

    The query rows are a host ring: an n-event batch queries the next n
    rows, padded to a power of two, and its dispatch reads nothing back
    from the card."""

    def __init__(self, live, q_num, q_cat=None, *, k: int = 5,
                 n_probe: int = 0, batch_size: int = 1):
        import types
        import numpy as np
        self.live = live
        self.state = None         # swaps go through install_state
        self.actions = ["similar-user"]
        self.cfg = types.SimpleNamespace(batch_size=batch_size)
        self._q_num = (None if q_num is None
                       else np.asarray(q_num, np.float32))
        self._q_cat = None if q_cat is None else np.asarray(q_cat)
        self._rows = int((self._q_num if self._q_num is not None
                          else self._q_cat).shape[0])
        self._k = int(k)
        self._n_probe = int(n_probe)
        self._cursor = 0
        self.reward_count = 0
        self.reward_sum = 0.0

    @staticmethod
    def _bucket(n: int) -> int:
        m = 1
        while m < n:
            m *= 2
        return m

    def install_state(self, payload) -> None:
        """The swap hook ``lifecycle.swap.install_state`` delegates to:
        ``payload`` is ``(leaves, extra)`` of a published ivf-index
        snapshot; the index adopts it and replays the rows appended since
        into its new tails."""
        leaves, extra = payload
        self.live.adopt(leaves, extra)

    def warm(self, max_batch: int) -> None:
        """Run each power-of-two batch up to ``max_batch`` once (a query
        changes no state)."""
        m = 1
        while m <= self._bucket(max_batch):
            self.resolve_action_batch(self.next_action_batch_async(m))
            m *= 2

    def _probe(self) -> int:
        # an explicit n_probe holds across a rebuild that shrank nlist
        if self._n_probe <= 0:
            return 0
        return min(self._n_probe, self.live.index.nlist)

    def next_action_batch_async(self, n: int):
        import numpy as np
        m = self._bucket(n)
        idx = (self._cursor + np.arange(m)) % self._rows
        self._cursor = (self._cursor + n) % self._rows
        xn = None if self._q_num is None else self._q_num[idx]
        xc = None if self._q_cat is None else self._q_cat[idx]
        handle = self.live.query(xn, xc, k=self._k, n_probe=self._probe())
        return (handle, n)

    def resolve_action_batch(self, handle) -> List[str]:
        (_dist, ids), n = handle
        return [str(int(g)) for g in ids[:n, 0].cpu().tolist()]

    def set_reward_batch(self, pairs: Sequence[Tuple[str, float]]) -> None:
        """Outcome feedback: the rebuild is the update, so rewards only
        accumulate (the engine's DriftMonitor taps them)."""
        for _action, reward in pairs:
            self.reward_count += 1
            self.reward_sum += float(reward)


class AdmissionControl:
    """The serving engine's bounded-depth gate: graceful degradation in
    place of an unbounded queue.

    A hysteresis latch: shedding starts when the event queue's depth
    exceeds ``high_water`` and stops once it falls to ``low_water``
    (default ``high_water // 4``). While shedding, each engine iteration
    retires up to ``shed_chunk`` events unserved before its batch: one
    ``shed_events`` broker command on adapters that have it, else an
    over-popped sweep whose excess is acked through the ledger
    (:meth:`split`). Either way ``EngineStats.shed_total`` counts every
    retired event, so admitted and shed add up to everything popped.

    ``policy``: ``"reject-new"`` sheds the newest arrivals and serves the
    oldest in order (the bounded queue's gate); ``"drop-oldest"`` sheds
    the oldest, bounding how stale a decision gets under a backlog."""

    POLICIES = ("reject-new", "drop-oldest")

    def __init__(self, high_water: int, low_water: Optional[int] = None,
                 policy: str = "reject-new", shed_chunk: int = 256):
        if policy not in self.POLICIES:
            raise ValueError(f"shed policy {policy!r} not in "
                             f"{self.POLICIES}")
        self.high_water = int(high_water)
        self.low_water = (max(self.high_water // 4, 1)
                          if low_water is None else int(low_water))
        if not 0 < self.low_water <= self.high_water:
            raise ValueError(
                f"need 0 < low_water ({self.low_water}) <= high_water "
                f"({self.high_water})")
        self.policy = policy
        self.shed_chunk = max(int(shed_chunk), 1)
        self.shedding = False

    def update(self, depth: Optional[int]) -> bool:
        """Advance the latch with the queue's depth; whether to shed this
        iteration. An unknown depth (an adapter without ``depth()``) never
        sheds."""
        if depth is None:
            self.shedding = False
        elif self.shedding:
            if depth <= self.low_water:
                self.shedding = False
        elif depth > self.high_water:
            self.shedding = True
        return self.shedding

    def split(self, popped: List[str], admit_n: int
              ) -> Tuple[List[str], List[str]]:
        """(admitted, shed) of an over-full sweep, by the policy."""
        admit_n = max(admit_n, 0)
        if len(popped) <= admit_n:
            return popped, []
        if self.policy == "drop-oldest":
            return popped[len(popped) - admit_n:], \
                popped[:len(popped) - admit_n]
        return popped[:admit_n], popped[admit_n:]


class _AdaptiveCap:
    """Micro-batch sizing under load: a full pop means a backlog, so the
    cap doubles toward ``hi``; a short pop means the queue ran shallow,
    so it halves toward what arrived (not below ``lo``). It starts at
    ``hi``, so a filled queue's first batch is ``run()``'s."""

    def __init__(self, lo: int, hi: int):
        self.lo = max(int(lo), 1)
        self.hi = max(int(hi), self.lo)
        self.cap = self.hi

    def update(self, n_popped: int) -> int:
        if n_popped >= self.cap:
            self.cap = min(self.cap * 2, self.hi)
        else:
            # halve, but never below what arrived: a queue trickling 40 a
            # visit must not swing under a cap of 32
            self.cap = max(self.lo, n_popped, self.cap // 2)
        return self.cap


class ServingEngine:
    """The pipelined ReinforcementLearnerBolt: one learner on ``device``,
    queue adapters in, dispatch-then-fetch out. See the module docstring
    for the pipeline and its contract against ``run()``.

    ``on_batch`` (optional) is called with a batch's event count after
    its answers are written and acked. ``swap_source`` is polled at each
    batch boundary and returns ``(version, state)`` to swap in, or None.
    ``drift_monitor`` (``lifecycle.drift.DriftMonitor``) sees every
    drained reward."""

    def __init__(self, learner_type: str, actions: Sequence[str],
                 config: Dict[str, Any], queues, *, seed: int = 0,
                 min_batch: int = 8, max_batch: Optional[int] = None,
                 drain_max: Optional[int] = None,
                 learner: Optional[Learner] = None,
                 on_batch: Optional[Callable[[int], None]] = None,
                 event_timestamps: bool = False,
                 swap_source: Optional[Callable[[], Optional[Tuple]]] = None,
                 drift_monitor=None,
                 admission: Optional[AdmissionControl] = None,
                 device: DeviceLike = "cuda"):
        self.learner = (learner if learner is not None
                        else Learner(learner_type, actions, config, seed,
                                     device=device))
        self.queues = queues
        self.stats = EngineStats()
        self._cap = _AdaptiveCap(min_batch,
                                 max_batch or Learner._SCAN_BUCKET_MAX)
        self._drain_max = drain_max
        self._on_batch = on_batch
        self._tel = telemetry.tracer()
        # None (the default): no depth polls, no shedding, no extra
        # broker traffic
        self._admission = admission
        self._swap_source = swap_source
        self._drift = drift_monitor
        # opt-in ``id|ts`` payloads: actions go out under the bare id,
        # acks by the raw payload
        self._event_ts = bool(event_timestamps)
        self.stats.batch_cap = self._cap.cap

    # -- the lifecycle seam ------------------------------------------------

    def swap_state(self, snapshot, version=None) -> float:
        """Install a learner-state snapshot at a batch boundary: the same
        as stopping the engine, restoring the snapshot and resuming. A
        batch in flight already holds its actions (computed from the old
        state when it was queued) and resolves unchanged; the next
        dispatch reads the new state. The install is a copy
        (``lifecycle.swap.install_state``). Returns the swap's latency in
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
        """Poll the swap source at the top of a batch iteration, before
        the batch's reward drain (where a stop, restore and resume
        re-enters)."""
        if self._swap_source is None:
            return
        pending = self._swap_source()
        if pending is not None:
            version, snapshot = pending
            self.swap_state(snapshot, version=version)

    # -- the pipeline's stages ---------------------------------------------

    def _fold_rewards(self) -> Tuple[float, int]:
        """A bounded drain and the fold queued behind it: (seconds of
        broker I/O, pairs folded)."""
        t0 = time.perf_counter()
        pairs = self.queues.drain_rewards(self._drain_max)
        io_s = time.perf_counter() - t0
        if pairs:
            from avenir_tpu_torch.stream.loop import record_reward_fold
            tel = self._tel.enabled
            t1 = time.perf_counter() if tel else 0.0
            self.learner.set_reward_batch(pairs)
            self.stats.rewards += len(pairs)
            if tel:
                record_reward_fold(self._tel, t1, len(pairs))
            if self._drift is not None:
                self._drift.observe_rewards(r for _, r in pairs)
        self.stats.reward_backlog = int(self.queues.reward_backlog)
        return io_s, len(pairs)

    def _complete(self, events: List[str], acks: List[str], handles,
                  t_pop: float, traces, batch_size: int) -> None:
        """Finish a batch in flight: the path's one blocking read, then
        the batch's bulk write and bulk ack (the ack after the write: a
        death between them replays the batch). ``t_pop`` is the clock read
        before the batch's pop, the anchor of its events' decision
        latency; ``traces`` its sampled trace ids."""
        t0 = time.perf_counter()
        selections = self.learner.resolve_action_batch(handles)
        t1 = time.perf_counter()
        _tracing.record_batch(traces, "resolve")
        entries = [(event_id,
                    selections[i * batch_size:(i + 1) * batch_size])
                   for i, event_id in enumerate(events)]
        if not self._event_ts:
            self.queues.write_and_ack(entries)
        else:
            # the write ids differ from the ledger's raw payloads: write,
            # then ack the raws
            self.queues.write_actions_bulk(entries)
            self.queues.ack_events(acks)
        t2 = time.perf_counter()
        self.stats.select_wait_ms += (t1 - t0) * 1e3
        self.stats.io_ms += (t2 - t1) * 1e3
        self.stats.events += len(events)
        self.stats.actions_written += sum(len(e[1]) for e in entries)
        self.stats.batches += 1
        self.stats.note_cap(self._cap.cap)
        if self._tel.enabled:
            self._tel.record("engine.select", (t1 - t0) * 1e3)
            self._tel.record("engine.io", (t2 - t1) * 1e3)
            self._tel.record("engine.decision_latency",
                             (t2 - t_pop) * 1e3, len(events))
            depth = self.queues.depth()
            if depth is not None:
                self.stats.queue_depth = depth
            # the gauges a batch, so the queue depth moves during a ramp
            self._publish_gauges()
        if self._on_batch is not None:
            self._on_batch(len(events))

    def _note_shed(self, n: int, elapsed_s: float) -> None:
        # no io_ms here: both shed paths run inside the iteration's window
        # that run() already counts as I/O
        self.stats.shed_total += n
        if self._tel.enabled:
            self._tel.record("engine.shed", elapsed_s * 1e3, n)
            self._publish_gauges()

    def _shed_direct(self) -> None:
        """The shed: one bulk pop off the adapter (``shed_events``)
        around the ledger: shed work needs no replay."""
        t0 = time.perf_counter()
        shed = self.queues.shed_events(
            self._admission.shed_chunk,
            newest=self._admission.policy == "reject-new")
        if shed:
            self._note_shed(len(shed), time.perf_counter() - t0)

    def _shed(self, popped: List[str], admit_n: int) -> List[str]:
        """The shed on adapters without ``shed_events``: the sweep
        over-popped through the ledger, and each shed event is retired by
        an ack as an answered one is. Returns the admitted payloads in
        their order."""
        admitted, shed = self._admission.split(popped, admit_n)
        if shed:
            t0 = time.perf_counter()
            self.queues.ack_events(shed)
            self._note_shed(len(shed), time.perf_counter() - t0)
        return admitted

    def _publish_gauges(self) -> None:
        extra = {"engine.queue_depth": self.stats.queue_depth}
        if self._admission is not None:
            extra["engine.shedding"] = float(self._admission.shedding)
        _publish_engine_gauges(self.stats, extra=extra)

    # -- the loop ----------------------------------------------------------

    def run(self, max_events: Optional[int] = None) -> EngineStats:
        """Drain the queues (or serve ``max_events``), pipelined. An
        iteration: fold the drained rewards, pop the next micro-batch,
        queue its decisions, and only then read batch n-1's actions and
        do its queue I/O, behind batch n's work on the card.

        Wrapped in the flight recorder's crash hook: with the live
        observability layer armed, the ring's last windows land beside
        the metrics file before an exception propagates."""
        from avenir_tpu_torch.obs.timeseries import run_with_flight_dump
        return run_with_flight_dump(
            "engine", lambda: self._run_impl(max_events))

    def _run_impl(self, max_events: Optional[int] = None) -> EngineStats:
        learner = self.learner
        batch_size = learner.cfg.batch_size
        processed = 0
        pending: Optional[Tuple] = None
        last_folded = 0
        while True:
            self._maybe_swap()
            io_s, last_folded = self._fold_rewards()
            t0 = time.perf_counter()
            cap = self._cap.cap
            if max_events is not None:
                cap = min(cap, max_events - processed)
            pop_n = cap
            if self._admission is not None:
                # one depth poll an iteration drives the latch; while it
                # sheds, the excess is retired before the batch's pop
                depth = self.queues.depth()
                if depth is not None:
                    self.stats.queue_depth = depth
                if self._admission.update(depth):
                    if hasattr(self.queues, "shed_events"):
                        self._shed_direct()
                    else:
                        pop_n = cap + self._admission.shed_chunk
            # the decision-latency anchor leaves out the admission work,
            # which is no admitted event's; without admission the two
            # clocks are one
            t_anchor = (time.perf_counter() if self._admission is not None
                        else t0)
            events = self.queues.pop_events(pop_n)
            if pop_n > cap and len(events) > cap:
                events = self._shed(events, cap)
            t1 = time.perf_counter()
            acks = events
            traces = None
            if events and self._event_ts:
                from avenir_tpu_torch.stream.loop import strip_event_stamps
                events, traces = strip_event_stamps(acks, self._tel)
            handles = None
            if events:
                handles = learner.next_action_batch_async(
                    len(events) * batch_size)
                _tracing.record_batch(traces, "dispatch")
            t2 = time.perf_counter()
            self.stats.io_ms += (io_s + (t1 - t0)) * 1e3
            self.stats.dispatch_ms += (t2 - t1) * 1e3
            if self._tel.enabled and (io_s or events):
                self._tel.record("engine.io", (io_s + (t1 - t0)) * 1e3)
            if pending is not None:
                self._complete(*pending, batch_size)
            if not events:
                # an empty pop is a depth of 0: the latch must not leave
                # run() shedding when the shed itself emptied the queue
                # (pop_n 0 is the max_events bound, no signal)
                if self._admission is not None and pop_n > 0:
                    self._admission.update(0)
                break
            pending = (events, acks, handles, t_anchor, traces)
            processed += len(events)
            if max_events is None or processed < max_events:
                self._cap.update(len(events))
        # the queue is drained: fold the backlog the bounded sweeps left
        # (run()'s exit contract); the last drain came back empty unless
        # it hit the bound
        while last_folded:
            _, last_folded = self._fold_rewards()
        self.stats.batch_cap = self._cap.cap
        self._publish_gauges()
        return self.stats


class GroupedServingEngine:
    """Multi-context serving over one stacked ``GroupedLearner``.

    Events are ``"<group>:<rest>"``; rewards are payloads
    ``"<group>:<action>,<reward>"`` (the action id carries the group
    prefix). A micro-batch is cut into waves, wave w holding the w-th
    pending event of each context, and each wave is one batched
    ``next_all_async`` step whose ``[G]`` actions stay on the card until
    the next batch's waves are queued. Drained rewards fold through the
    masked batched ``reward_masked`` step, a reward-wave at a time.

    A documented deviation from serving each context with its own
    ``OnlineLearnerLoop``, as in the JAX package: a batched step advances
    every context, so in a wave where context g has no pending event, g's
    learner still takes its step and its drawn action is dropped (never
    written, never counted). Contexts with balanced traffic, the grouped
    learner's deployment shape, see the sequence they would see alone.

    ``run()`` is wrapped in the flight recorder's crash hook, as
    ``ServingEngine.run()`` is."""

    def __init__(self, learner_type: str, groups: Sequence[str],
                 actions: Sequence[str], config: Dict[str, Any], queues, *,
                 seed: int = 0, device: DeviceLike = "cuda"):
        from avenir_tpu_torch.stream.loop import GroupedLearner
        self.groups = list(groups)
        # group routing and reward resolution are dict lookups
        self._group_index = {g: i for i, g in enumerate(self.groups)}
        self.gl = GroupedLearner(learner_type, len(self.groups), actions,
                                 config, seed, device=device)
        self.queues = queues
        self.stats = EngineStats()
        self._cap = _AdaptiveCap(8, Learner._SCAN_BUCKET_MAX)
        self._tel = telemetry.tracer()

    def _split_group(self, payload: str) -> Tuple[int, str]:
        group, _, rest = payload.partition(":")
        idx = self._group_index.get(group)
        if idx is None:
            raise ValueError(f"unknown group {group!r} in {payload!r}")
        return idx, rest

    def _fold_rewards(self) -> None:
        """Drain ``group:action`` rewards and fold them as masked batched
        steps, one a reward-wave (a wave holds at most one reward of each
        context), each context's rewards in their order."""
        t0 = time.perf_counter()
        pairs = self.queues.drain_rewards()
        self.stats.io_ms += (time.perf_counter() - t0) * 1e3
        if not pairs:
            return
        tel = self._tel.enabled
        t_fold = time.perf_counter() if tel else 0.0
        n = len(self.groups)
        # wave w = the w-th reward of each context, by a counter a context
        waves: List[Dict[int, Tuple[int, float]]] = []
        depth: Dict[int, int] = {}
        for action_id, reward in pairs:
            gidx, action = self._split_group(action_id)
            aidx = self.gl._resolve_action(action)
            w = depth.get(gidx, 0)
            depth[gidx] = w + 1
            if w == len(waves):
                waves.append({})
            waves[w][gidx] = (aidx, reward)
        for wave in waves:
            idx = [0] * n
            rew = [0.0] * n
            mask = [False] * n
            for gidx, (aidx, reward) in wave.items():
                idx[gidx], rew[gidx], mask[gidx] = aidx, reward, True
            self.gl.reward_masked(idx, rew, mask)
        self.stats.rewards += len(pairs)
        if tel:
            from avenir_tpu_torch.stream.loop import record_reward_fold
            record_reward_fold(self._tel, t_fold, len(pairs))
        backlog = getattr(self.queues, "reward_backlog", None)
        if backlog is not None:
            self.stats.reward_backlog = int(backlog)

    def _make_waves(self, events: List[str]) -> List[List[Tuple[str, int]]]:
        """Wave w holds the w-th pending event of each context, in pop
        order, as ``(event id, group index)``."""
        waves: List[List[Tuple[str, int]]] = []
        depth: Dict[int, int] = {}
        for event_id in events:
            gidx, _ = self._split_group(event_id)
            w = depth.get(gidx, 0)
            depth[gidx] = w + 1
            if w == len(waves):
                waves.append([])
            waves[w].append((event_id, gidx))
        return waves

    def _complete(self, waves, handles, t_pop: float) -> None:
        import torch
        t0 = time.perf_counter()
        # the blocking read: every wave's actions at once
        resolved = (torch.stack(handles).cpu().tolist() if handles
                    else [])
        t1 = time.perf_counter()
        entries = [(event_id, [self.gl.actions[actions[gidx]]])
                   for wave, actions in zip(waves, resolved)
                   for event_id, gidx in wave]
        self.queues.write_and_ack(entries)
        t2 = time.perf_counter()
        n_events = len(entries)
        self.stats.select_wait_ms += (t1 - t0) * 1e3
        self.stats.io_ms += (t2 - t1) * 1e3
        self.stats.events += n_events
        self.stats.actions_written += n_events
        self.stats.batches += 1
        self.stats.note_cap(self._cap.cap)
        if self._tel.enabled:
            self._tel.record("engine.select", (t1 - t0) * 1e3)
            self._tel.record("engine.io", (t2 - t1) * 1e3)
            self._tel.record("engine.decision_latency",
                             (t2 - t_pop) * 1e3, n_events)

    def run(self, max_events: Optional[int] = None) -> EngineStats:
        """Drain the queues (or serve ``max_events``): each iteration folds
        the drained rewards, pops a micro-batch, queues its waves, and
        only then reads the previous batch's actions and writes them."""
        from avenir_tpu_torch.obs.timeseries import run_with_flight_dump
        return run_with_flight_dump(
            "engine", lambda: self._run_impl(max_events))

    def _run_impl(self, max_events: Optional[int] = None) -> EngineStats:
        processed = 0
        pending = None
        while True:
            self._fold_rewards()
            t0 = time.perf_counter()
            cap = self._cap.cap
            if max_events is not None:
                cap = min(cap, max_events - processed)
            events = self.queues.pop_events(cap)
            self.stats.io_ms += (time.perf_counter() - t0) * 1e3
            waves = self._make_waves(events)
            t1 = time.perf_counter()
            handles = [self.gl.next_all_async() for _ in waves]
            self.stats.dispatch_ms += (time.perf_counter() - t1) * 1e3
            if pending is not None:
                self._complete(*pending)
            if not events:
                break
            pending = (waves, handles, t0)
            processed += len(events)
            if max_events is None or processed < max_events:
                self._cap.update(len(events))
        while True:
            before = self.stats.rewards
            self._fold_rewards()
            if self.stats.rewards == before:
                break
        self.stats.batch_cap = self._cap.cap
        _publish_engine_gauges(self.stats)
        return self.stats
