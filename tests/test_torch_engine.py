"""The port's serving engine (``stream/engine.py``) and the queue adapters'
bulk methods against the JAX package's, on the CPU, on the same queues:
the actions written and the ``EngineStats`` counters exactly equal, the
learner's state bit-equal; the engine equal to the port's loop; the
dispatch reads nothing to the host."""

import functools

import numpy as np
import pytest
import torch

from avenir_tpu.stream import engine as JE
from avenir_tpu.stream import loop as JLOOP
from avenir_tpu.stream.miniredis import (
    MiniRedisClient as JClient, MiniRedisServer as JServer)

from avenir_tpu_torch.models.bandits.learners import Learner
from avenir_tpu_torch.stream import engine as TE
from avenir_tpu_torch.stream import loop as TLOOP
from avenir_tpu_torch.stream.miniredis import (
    MiniRedisClient as TClient, MiniRedisServer as TServer)

torch.set_num_threads(2)

ACTIONS = ["a", "b", "c"]
TYPES = ["intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
         "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
         "softMax", "actionPursuit", "rewardComparison", "exponentialWeight"]
CONFIG = {"batch.size": 2, "min.sample.size": "3",
          "min.reward.distr.sample": "2"}
COUNTERS = ("events", "rewards", "actions_written", "batches", "shed_total",
            "cap_history", "swaps", "model_version")


def _prefill(pkg_loop, n_events, n_rewards, stamp=False):
    q = pkg_loop.InProcQueues()
    for i in range(n_events):
        q.push_event(f"e{i:04d}|{1700000000 + i}" if stamp else f"e{i:04d}")
    for j in range(n_rewards):
        q.push_reward(ACTIONS[j % 3], 10.0 + j)
    return q


def _counters(stats):
    return {name: getattr(stats, name) for name in COUNTERS}


def _jax_state(state):
    import jax
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state)]


def _assert_state_equal(t_state, j_leaves):
    for (name, got), want in zip(t_state.to_numpy().items(), j_leaves):
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _engine(pkg, learner_type, queues, seed, **kw):
    if pkg is TE:
        kw.setdefault("device", "cpu")
    return pkg.ServingEngine(learner_type, ACTIONS, dict(CONFIG), queues,
                             seed=seed, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(learner_type, seed, n_events=333, n_rewards=48):
    """The JAX engine's run on prefilled queues: (actions, counters,
    state leaves), computed once a case."""
    q = _prefill(JLOOP, n_events, n_rewards)
    eng = _engine(JE, learner_type, q, seed)
    stats = eng.run()
    return list(q.actions), _counters(stats), _jax_state(eng.learner.state)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("learner_type", TYPES)
def test_bit_parity_prefilled(learner_type, seed):
    """The ten learners: actions, counters and state as the JAX engine's,
    and the actions and state of the port's own ``run()``."""
    want_actions, want_counters, want_state = _jax_run(learner_type, seed)
    q = _prefill(TLOOP, 333, 48)
    eng = _engine(TE, learner_type, q, seed)
    stats = eng.run()
    assert list(q.actions) == want_actions
    assert _counters(stats) == want_counters
    _assert_state_equal(eng.learner.state, want_state)
    q_loop = _prefill(TLOOP, 333, 48)
    loop = TLOOP.OnlineLearnerLoop(learner_type, ACTIONS, dict(CONFIG),
                                   q_loop, seed=seed, device="cpu")
    loop.run()
    assert list(q_loop.actions) == want_actions
    _assert_state_equal(loop.learner.state, want_state)


def test_dispatch_reads_nothing_to_the_host(monkeypatch):
    """``next_action_batch_async`` on each learner (and two with min-trial
    forcing, whose decisions all take the scalar steps, and the live ANN
    index's ``AnnServingLearner`` with appended rows in its tails, one of
    them past the build's int8 scale), at 1, 64, 256 and 64 + 9
    decisions, with every tensor-to-host read raising (the CPU's stand-in
    for ``torch.cuda.set_sync_debug_mode("error")``)."""
    from avenir_tpu_torch.models.live_ann import LiveAnnIndex
    from avenir_tpu_torch.stream.engine import AnnServingLearner
    learners = [Learner(t, ACTIONS, dict(CONFIG, **{"min.trial": m}), 3,
                        device="cpu")
                for t, m in [(t, -1) for t in TYPES]
                + [("softMax", 2), ("upperConfidenceBoundTwo", 2)]]
    for learner in learners:
        learner.set_reward_batch([(ACTIONS[i % 3], 40.0 + i)
                                  for i in range(12)])
    rng = np.random.default_rng(5)
    live = LiveAnnIndex(rng.random((600, 4), dtype=np.float32),
                        rng.integers(0, 3, (600, 2)), n_cat_bins=3,
                        nlist=8, n_iters=3, tail_budget=64, device="cpu")
    live.append(rng.random((40, 4), dtype=np.float32) * 2,
                rng.integers(0, 3, (40, 2)))
    learners.append(AnnServingLearner(
        live, rng.random((300, 4), dtype=np.float32) * 1.5,
        rng.integers(0, 3, (300, 2)), k=5))

    def host_read(*args, **kwargs):
        raise AssertionError("a host read in the dispatch")
    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    handles = [learner.next_action_batch_async(n)
               for learner in learners for n in (1, 64, 256, 73)]
    monkeypatch.undo()
    for learner, i in zip(learners, range(0, len(handles), 4)):
        for n, h in zip((1, 64, 256, 73), handles[i:i + 4]):
            assert len(learner.resolve_action_batch(h)) == n


def test_async_then_resolve_is_next_action_batch():
    for learner_type in ("softMax", "upperConfidenceBoundTwo"):
        a = Learner(learner_type, ACTIONS, dict(CONFIG), 5, device="cpu")
        b = Learner(learner_type, ACTIONS, dict(CONFIG), 5, device="cpu")
        for n in (1, 64, 300, 73):
            handles = a.next_action_batch_async(n)
            assert sum(take for _, take in handles) == n
            assert a.resolve_action_batch(handles) == \
                b.next_action_batch(n)
        assert a.resolve_action_batch([]) == []


def _redis_run(server_cls, client_cls, pkg_loop, pkg, mode):
    """softMax over a MiniRedis with the pending ledger armed: (the action
    queue's bytes oldest first, stats, broker round trips)."""
    with server_cls() as srv:
        client = client_cls(srv.host, srv.port)
        for i in range(300):
            client.lpush("eventQueue", f"e{i:04d}")
        for j in range(40):
            client.lpush("rewardQueue", f"{ACTIONS[j % 3]},{10.0 + j}")
        queues = pkg_loop.RedisQueues(client=client,
                                      pending_queue="pendingQueue")
        calls0 = client.calls
        kw = {"device": "cpu"} if pkg_loop is TLOOP else {}
        if mode == "loop":
            stats = pkg_loop.OnlineLearnerLoop(
                "softMax", ACTIONS, {"batch.size": 2}, queues, seed=3,
                **kw).run()
        else:
            stats = pkg.ServingEngine("softMax", ACTIONS, {"batch.size": 2},
                                      queues, seed=3, **kw).run()
        trips = client.calls - calls0
        assert client.llen("pendingQueue") == 0
        raws = []
        while (raw := client.rpop("actionQueue")) is not None:
            raws.append(raw)
        client.close()
    return raws, stats, trips


def test_bit_parity_over_miniredis_with_the_ledger():
    """The same bytes on the wire as the JAX engine and the port's loop,
    the ledger retired, and a tenth of the loop's round trips or fewer."""
    j_raws, j_stats, j_trips = _redis_run(JServer, JClient, JLOOP, JE,
                                          "engine")
    t_raws, t_stats, t_trips = _redis_run(TServer, TClient, TLOOP, TE,
                                          "engine")
    l_raws, l_stats, l_trips = _redis_run(TServer, TClient, TLOOP, TE,
                                          "loop")
    assert t_raws == j_raws == l_raws
    assert _counters(t_stats) == _counters(j_stats)
    assert t_trips == j_trips
    assert t_trips * 10 < l_trips, (t_trips, l_trips)


def test_max_events_and_cumulative_runs():
    out = []
    for pkg, loop_pkg in ((JE, JLOOP), (TE, TLOOP)):
        q = _prefill(loop_pkg, 200, 0)
        eng = _engine(pkg, "softMax", q, 1)
        first = _counters(eng.run(max_events=70))
        left = len(q.events)
        second = _counters(eng.run())
        out.append((first, left, second, list(q.actions)))
    assert out[1] == out[0]
    assert out[1][0]["events"] == 70 and out[1][1] == 130
    assert out[1][2]["events"] == 200


def _live_queues(pkg_loop):
    class LiveQueues(pkg_loop.InProcQueues):
        """A reward for every served action, pushed once the batch is
        written (a live consumer's)."""

        def __init__(self):
            super().__init__()
            self.fold_points = []

        def write_actions_bulk(self, entries):
            super().write_actions_bulk(entries)
            for event_id, actions in entries:
                self.push_reward(actions[0], 50.0)

        def drain_rewards(self, max_items=None):
            pairs = super().drain_rewards(max_items)
            if pairs:
                self.fold_points.append(len(pairs))
            return pairs
    return LiveQueues()


def test_live_rewards_fold_into_the_next_batch_as_jax():
    out = []
    for pkg, loop_pkg in ((JE, JLOOP), (TE, TLOOP)):
        q = _live_queues(loop_pkg)
        for i in range(300):
            q.push_event(f"e{i}")
        eng = pkg.ServingEngine("softMax", ACTIONS, {"batch.size": 1}, q,
                                seed=2, **({"device": "cpu"} if pkg is TE
                                           else {}))
        stats = eng.run()
        out.append((_counters(stats), q.fold_points, list(q.actions),
                    q.reward_backlog))
    assert out[1] == out[0]
    assert out[1][0]["rewards"] == 300 and max(out[1][1]) > 1


def test_the_cap_grows_and_shrinks_as_jax():
    rng = np.random.default_rng(4)
    pops = [int(x) for x in rng.integers(0, 80, 60)]
    for lo, hi in ((8, 64), (1, 16), (5, 5)):
        jcap, tcap = JE._AdaptiveCap(lo, hi), TE._AdaptiveCap(lo, hi)
        assert tcap.cap == jcap.cap
        assert [tcap.update(n) for n in pops] == \
            [jcap.update(n) for n in pops]
    # a trickle shrinks the engine's cap to its floor
    out = []
    for pkg, loop_pkg in ((JE, JLOOP), (TE, TLOOP)):
        q = loop_pkg.InProcQueues()
        eng = _engine(pkg, "softMax", q, 1, min_batch=8)
        for _ in range(5):
            q.push_event("e")
            eng.run()
        out.append((eng.stats.batch_cap, eng.stats.cap_history))
    assert out[1] == out[0] and out[1][0] == 8


def test_cap_history_is_bounded_as_jax():
    stats = TE.EngineStats()
    for i in range(2500):
        stats.note_cap(i)
    jstats = JE.EngineStats()
    for i in range(2500):
        jstats.note_cap(i)
    assert (stats.cap_history, stats.history_dropped) == \
        (jstats.cap_history, jstats.history_dropped)


def test_admission_latch_split_and_validation_as_jax():
    depths = [50, 101, 60, 25, 100, None, 300, 120, 26, 25, 0]
    for high, low in ((100, 25), (64, None), (10, 10)):
        j = JE.AdmissionControl(high, low_water=low)
        t = TE.AdmissionControl(high, low_water=low)
        assert t.low_water == j.low_water
        assert [t.update(d) for d in depths] == [j.update(d) for d in depths]
    popped = [f"e{i}" for i in range(7)]
    for policy in TE.AdmissionControl.POLICIES:
        for admit in (0, 3, 9):
            assert TE.AdmissionControl(10, policy=policy).split(
                popped, admit) == JE.AdmissionControl(
                    10, policy=policy).split(popped, admit)
    for kwargs in ({"policy": "nonsense"}, {"low_water": 200},
                   {"low_water": 0}):
        with pytest.raises(ValueError):
            TE.AdmissionControl(100, **kwargs)


class _NoShedQueues:
    """An in-process adapter without ``shed_events`` (the over-pop path,
    shed events retired through acks)."""

    def __init__(self, inner):
        self._q = inner
        self.acked = []

    def ack_events(self, ids):
        self.acked += list(ids)

    def write_and_ack(self, entries):
        # the write, then every answered event's ack through this adapter
        self._q.write_actions_bulk(entries)
        self.ack_events([event_id for event_id, _ in entries])

    def __getattr__(self, name):
        if name == "shed_events":
            raise AttributeError(name)
        return getattr(self._q, name)


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest"])
def test_shedding_accounts_exactly_as_jax(policy, direct):
    """admitted + shed = produced, to the event, the latch recovering
    below the low mark; the same events served as the JAX engine's."""
    out = []
    for pkg, loop_pkg in ((JE, JLOOP), (TE, TLOOP)):
        q = _prefill(loop_pkg, 2000, 30)
        queues = q if direct else _NoShedQueues(q)
        adm = pkg.AdmissionControl(high_water=512, low_water=128,
                                   policy=policy, shed_chunk=256)
        eng = _engine(pkg, "softMax", queues, 3, admission=adm)
        first = _counters(eng.run())
        assert not adm.shedding
        for i in range(64):
            q.push_event(f"r{i:03d}")
        second = _counters(eng.run())
        acked = getattr(queues, "acked", None)
        out.append((first, second, list(q.actions), acked))
    assert out[1] == out[0]
    first, second, actions, _ = out[1]
    assert first["shed_total"] > 0
    assert first["events"] + first["shed_total"] == 2000
    assert second["shed_total"] == first["shed_total"]
    assert second["events"] + second["shed_total"] == 2064
    served = {event for event, _ in actions}
    assert ("e0000" in served) == (policy == "reject-new")


def test_shedding_over_the_ledger_as_jax():
    out = []
    for server_cls, client_cls, loop_pkg, pkg in (
            (JServer, JClient, JLOOP, JE), (TServer, TClient, TLOOP, TE)):
        with server_cls() as srv:
            c = client_cls(srv.host, srv.port)
            for i in range(1200):
                c.lpush("eventQueue", f"e{i:04d}")
            q = loop_pkg.RedisQueues(client=c, pending_queue="pendingQueue")
            adm = pkg.AdmissionControl(high_water=256, low_water=64,
                                       policy="reject-new", shed_chunk=128)
            stats = _engine(pkg, "softMax", q, 3, admission=adm).run()
            out.append((_counters(stats), c.llen("pendingQueue"),
                        c.llen("eventQueue"), c.lrange("actionQueue", 0, -1)))
            c.close()
    assert out[1] == out[0]
    counters, pending, left, written = out[1]
    assert counters["events"] + counters["shed_total"] == 1200
    assert pending == left == 0 and len(written) == counters["events"]


def test_event_timestamps_write_bare_ids_and_ack_the_raws():
    out = []
    for server_cls, client_cls, loop_pkg, pkg in (
            (JServer, JClient, JLOOP, JE), (TServer, TClient, TLOOP, TE)):
        with server_cls() as srv:
            c = client_cls(srv.host, srv.port)
            for i in range(150):
                c.lpush("eventQueue", f"e{i:03d}|{1700000000 + i * 0.5}")
            q = loop_pkg.RedisQueues(client=c, pending_queue="pendingQueue")
            stats = _engine(pkg, "randomGreedy", q, 1,
                            event_timestamps=True).run()
            out.append((_counters(stats), c.llen("pendingQueue"),
                        c.lrange("actionQueue", 0, -1)))
            c.close()
    assert out[1] == out[0]
    assert out[1][1] == 0
    assert all(b"|" not in raw for raw in out[1][2])


def test_engine_spans_and_gauges():
    from avenir_tpu_torch.obs import exporters as E
    from avenir_tpu_torch.obs import telemetry as T
    hub = E.hub()
    hub.reset()
    hub.enable()
    try:
        q = _prefill(TLOOP, 200, 20)
        adm = TE.AdmissionControl(high_water=10_000)
        _engine(TE, "softMax", q, 1, admission=adm).run()
        spans = T.tracer().snapshot()
        for name in ("engine.select", "engine.io",
                     "engine.decision_latency", "engine.reward_fold"):
            assert name in spans, name
        assert spans["engine.decision_latency"]["count"] == 200
        gauges = hub.report()["gauges"]
        for name in ("engine.overlap_fraction", "engine.queue_depth",
                     "engine.shedding", "engine.shed_total"):
            assert name in gauges, name
    finally:
        hub.reset()


def test_on_batch_sees_each_batch():
    seen = []
    q = _prefill(TLOOP, 150, 0)
    stats = _engine(TE, "softMax", q, 1, on_batch=seen.append).run()
    assert seen == [64, 64, 22] and stats.batches == 3


def _swap_at_poll(n, snapshot):
    polls = {"n": 0}

    def source():
        polls["n"] += 1
        return (1000 + n, snapshot()) if polls["n"] == n else None
    return source


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("learner_type", ["softMax", "upperConfidenceBoundOne",
                                          "intervalEstimator",
                                          "actionPursuit"])
def test_swap_at_a_boundary_is_stop_restore_resume(learner_type, seed):
    """A swap polled at batch 3 (batch 2 in flight) equals stopping at the
    boundary, restoring and resuming, and the JAX engine's live swap."""
    from avenir_tpu.models.bandits.learners import Learner as JLearner
    pairs = [(ACTIONS[i % 3], float(i)) for i in range(16)]
    jsnap = JLearner(learner_type, ACTIONS, dict(CONFIG), seed=seed + 50)
    jsnap.set_reward_batch(pairs)
    tsnap = Learner(learner_type, ACTIONS, dict(CONFIG), seed + 50,
                    device="cpu")
    tsnap.set_reward_batch(pairs)
    _assert_state_equal(tsnap.state, _jax_state(jsnap.state))

    qj = _prefill(JLOOP, 333, 0)
    jlive = _engine(JE, learner_type, qj, seed,
                    swap_source=_swap_at_poll(3, lambda: jsnap.state))
    jlive.run()
    q_live = _prefill(TLOOP, 333, 0)
    live = _engine(TE, learner_type, q_live, seed,
                   swap_source=_swap_at_poll(3, lambda: tsnap.state))
    stats = live.run()
    assert stats.swaps == 1 and stats.model_version == 1003
    assert list(q_live.actions) == list(qj.actions)
    _assert_state_equal(live.learner.state, _jax_state(jlive.learner.state))

    q_split = _prefill(TLOOP, 333, 0)
    split = _engine(TE, learner_type, q_split, seed)
    split.run(max_events=128)
    split.swap_state(tsnap.state, version=1003)
    split.run()
    assert list(q_split.actions) == list(q_live.actions)
    _assert_state_equal(split.learner.state,
                        _jax_state(jlive.learner.state))


def test_boundary_pending_rewards_fold_into_the_new_state():
    """Rewards queued at the swap's boundary fold into the new state; the
    replay models the stop with ``BoundaryStopQueues``."""
    from avenir_tpu_torch.lifecycle.swap import BoundaryStopQueues
    snap = Learner("softMax", ACTIONS, dict(CONFIG), 53, device="cpu")
    snap.set_reward_batch([(ACTIONS[i % 3], 1.0 + i) for i in range(12)])

    def boundary_rewards(q):
        fired = {"done": False}

        def on_batch(n):
            if not fired["done"]:
                fired["done"] = True
                for i in range(8):
                    q.push_reward(ACTIONS[i % 3], 5.0 + i)
        return on_batch

    q_live = _prefill(TLOOP, 333, 0)
    live = _engine(TE, "softMax", q_live, 3,
                   on_batch=boundary_rewards(q_live),
                   swap_source=_swap_at_poll(3, lambda: snap.state))
    live.run()
    q_split = _prefill(TLOOP, 333, 0)
    gated = BoundaryStopQueues(q_split)
    split = _engine(TE, "softMax", gated, 3,
                    on_batch=boundary_rewards(q_split))
    gated.set_budget(128)
    split.run()
    split.swap_state(snap.state)
    gated.set_budget(None)
    split.run()
    assert list(q_live.actions) == list(q_split.actions)
    assert live.stats.rewards == split.stats.rewards == 8
    for name, got in split.learner.state.to_numpy().items():
        assert np.array_equal(got, live.learner.state.to_numpy()[name])


def test_warm_serving_paths_evolves_the_state_as_jax():
    from avenir_tpu.models.bandits.learners import Learner as JLearner
    j = JLearner("exponentialWeight", ACTIONS, {"batch.size": 1}, seed=2)
    t = Learner("exponentialWeight", ACTIONS, {"batch.size": 1}, 2,
                device="cpu")
    JE.warm_serving_paths(j)
    TE.warm_serving_paths(t)
    _assert_state_equal(t.state, _jax_state(j.state))


# -- the queue adapters' bulk methods ----------------------------------------

def test_pop_events_bulk_equals_sequential_and_unacked_replays():
    with TServer() as srv:
        c = TClient(srv.host, srv.port)
        for i in range(10):
            c.lpush("eventQueue", f"e{i}")
        q = TLOOP.RedisQueues(client=c, pending_queue="pendingQueue")
        got = q.pop_events(6)
        assert got == [f"e{i}" for i in range(6)]
        assert c.llen("pendingQueue") == 6
        # a consumer that dies before acking: its bulk pop replays
        assert TLOOP.reclaim_pending(c, "pendingQueue", "eventQueue") == 6
        q2 = TLOOP.RedisQueues(client=c, pending_queue="pendingQueue")
        got = q2.pop_events(20)
        assert sorted(got) == [f"e{i}" for i in range(10)]
        q2.ack_events(got)
        assert c.llen("pendingQueue") == 0
        assert q2.pop_events(0) == [] and q2.pop_events(3) == []
        c.close()


def test_write_bulk_and_write_and_ack_equal_the_per_event_calls():
    entries = [(f"e{i}", [ACTIONS[i % 3], ACTIONS[(i + 1) % 3]])
               for i in range(7)]
    queues = {}
    with TServer() as srv:
        for mode in ("single", "bulk", "fused"):
            c = TClient(srv.host, srv.port)
            c.flushall()
            for i in range(7):
                c.lpush("eventQueue", f"e{i}")
            q = TLOOP.RedisQueues(client=c, pending_queue="pendingQueue")
            popped = q.pop_events(7)
            if mode == "single":
                for event_id, actions in entries:
                    q.write_actions(event_id, actions)
                    q.ack_event(event_id)
            elif mode == "bulk":
                q.write_actions_bulk(entries)
                q.ack_events(popped)
            else:
                q.write_and_ack(entries)
            queues[mode] = (c.lrange("actionQueue", 0, -1),
                            c.llen("pendingQueue"))
            c.close()
    assert queues["single"] == queues["bulk"] == queues["fused"]
    assert queues["fused"][1] == 0
    inproc = TLOOP.InProcQueues()
    inproc.write_actions_bulk(entries)
    assert [inproc.pop_action() for _ in entries] == \
        [(e, list(a)) for e, a in entries]


def test_reward_sweeps_and_shed_events_equal_jax():
    out = []
    for server_cls, client_cls, loop_pkg in ((JServer, JClient, JLOOP),
                                             (TServer, TClient, TLOOP)):
        with server_cls() as srv:
            c = client_cls(srv.host, srv.port)
            for j in range(30):
                c.lpush("rewardQueue", f"{ACTIONS[j % 3]},{float(j)}")
            for i in range(8):
                c.lpush("eventQueue", f"e{i}")
            q = loop_pkg.RedisQueues(client=c)
            swept = [q.drain_rewards(8), q.reward_backlog]
            p = c.pipeline()
            q.queue_reward_sweep(p, 10)
            swept += [q.apply_reward_sweep(*p.execute()), q.reward_backlog,
                      q.drain_rewards(), q.reward_backlog]
            shed = [q.shed_events(2), q.shed_events(2, newest=True),
                    q.shed_events(99), q.shed_events(1)]
            out.append((swept, shed))
            c.close()
    assert out[1] == out[0]
    q = TLOOP.InProcQueues()
    for i in range(6):
        q.push_event(f"e{i}")
    assert q.shed_events(2) == ["e0", "e1"]
    assert q.shed_events(2, newest=True) == ["e5", "e4"]


def test_note_popped_and_ack_command():
    with TServer() as srv:
        c = TClient(srv.host, srv.port)
        for i in range(3):
            c.lpush("eventQueue", f"e{i},x")
        q = TLOOP.RedisQueues(client=c, pending_queue="pendingQueue")
        raws = [c.rpoplpush("eventQueue", "pendingQueue") for _ in range(3)]
        assert [q.note_popped(r) for r in raws] == ["e0,x", "e1,x", "e2,x"]
        cmds = [q.ack_command(e) for e in ("e1", "e0,x", "e2")]
        assert cmds == [("pendingQueue", 1, b"e1,x"),
                        ("pendingQueue", 1, b"e0,x"),
                        ("pendingQueue", 1, b"e2,x")]
        for key, count, raw in cmds:
            c.lrem(key, count, raw)
        assert c.llen("pendingQueue") == 0 and not q._pending_raw
        assert TLOOP.RedisQueues(client=c).ack_command("e0") is None
        c.close()
