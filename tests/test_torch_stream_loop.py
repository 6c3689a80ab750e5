"""The port's online loop (``stream/loop.py``), its queue adapters, its
checkpoints (``utils/checkpoint.py``) and the copied pure-Python modules
around it (``obs/tracing.py``, ``stream/miniredis.py``, the
lead-generation simulator and the event sequences of ``datagen``)
against the JAX package's, on the CPU: the actions written are exactly
equal, the restored states bit-equal."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.obs import tracing as jtracing
from avenir_tpu.stream import loop as JLOOP

from avenir_tpu_torch import datagen as TG
from avenir_tpu_torch.models.bandits.learners import FIELDS
from avenir_tpu_torch.obs import tracing as ttracing
from avenir_tpu_torch.stream import loop as TLOOP
from avenir_tpu_torch.stream.miniredis import MiniRedisClient, MiniRedisServer
from avenir_tpu_torch.utils.checkpoint import (
    Checkpointer, restore_loop_state, save_loop_state)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ["intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
         "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
         "softMax", "actionPursuit", "rewardComparison", "exponentialWeight"]
CONFIG = {"random.selection.prob": 0.5, "prob.reduction.algorithm": "linear",
          "prob.reduction.constant": 150, "reward.scale": 100,
          "min.sample.size": "3", "min.reward.distr.sample": "2"}


def _state_equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n, _ in FIELDS)


def _drive(pkg_loop, sim_mod, learner_type, n, **kw):
    """The simulator's drive of ``n`` step() events; the actions popped."""
    sim = sim_mod.LeadGenSimulator(sel_count_threshold=4, seed=1)
    loop = pkg_loop.OnlineLearnerLoop(learner_type, sim.actions, CONFIG,
                                      pkg_loop.InProcQueues(), seed=0, **kw)
    popped = []
    pop = loop.queues.pop_action

    def record():
        entry = pop()
        if entry is not None:
            popped.append(entry)
        return entry
    loop.queues.pop_action = record
    sent = sim.drive(loop, n)
    return popped, sent, loop


@pytest.mark.parametrize("learner_type", TYPES)
def test_step_driven_by_the_simulator_equals_jax(learner_type):
    want, jsent, _ = _drive(JLOOP, JG, learner_type, 45)
    got, tsent, loop = _drive(TLOOP, TG, learner_type, 45, device="cpu")
    assert got == want and tsent == jsent
    assert loop.stats.events == 45


def _fill(queues, n, rewards, stamp=None):
    for i in range(n):
        queues.push_event(f"ev{i:04d}" if stamp is None else stamp(i))
    for action, reward in rewards:
        queues.push_reward(action, reward)


@pytest.mark.parametrize("learner_type", ["softMax", "upperConfidenceBoundTwo"])
def test_run_equals_jax_with_live_rewards(learner_type):
    """run() in 64-event batches, rewards queued between two runs; the
    actions written are the JAX loop's."""
    out = []
    for pkg, kw in ((JLOOP, {}), (TLOOP, {"device": "cpu"})):
        q = pkg.InProcQueues()
        loop = pkg.OnlineLearnerLoop(learner_type, ["a", "b", "c"], CONFIG,
                                     q, seed=4, **kw)
        _fill(q, 150, [("a", 30.0), ("c", 75.5)])
        loop.run(max_events=100)
        _fill(q, 0, [("b", 99.0), ("b", 12.25), ("a", 5.0)])
        stats = loop.run()
        out.append(([q.pop_action() for _ in range(150)],
                    (stats.events, stats.rewards, stats.actions_written)))
    assert out[0] == out[1]
    assert out[1][1] == (150, 5, 150)


@pytest.mark.parametrize("payload", [
    "ev1", "ev1|1700000000.5", "ev1|1700000000.5|t12-64", "user|42|page",
    "a|b|t1-2", "x|t3-4", "ev|inf"])
def test_event_stamps_split_as_jax(payload):
    assert TLOOP.split_event_stamp(payload) == \
        JLOOP.split_event_stamp(payload)
    assert TLOOP.split_event_timestamp(payload) == \
        JLOOP.split_event_timestamp(payload)


def test_event_timestamps_write_bare_ids_in_step_and_run():
    stamp = (lambda i: f"ev{i:04d}|{1700000000 + i}|t9-{i}" if i % 3 == 0
             else f"ev{i:04d}|{1700000000 + i}")
    out = []
    for pkg, kw in ((JLOOP, {}), (TLOOP, {"device": "cpu"})):
        q = pkg.InProcQueues()
        loop = pkg.OnlineLearnerLoop("randomGreedy", ["a", "b"], CONFIG, q,
                                     seed=2, event_timestamps=True, **kw)
        _fill(q, 70, [("a", 10.0)], stamp=stamp)
        for _ in range(5):
            loop.step()
        loop.run()
        out.append([q.pop_action() for _ in range(70)])
    assert out[0] == out[1]
    assert [e[0] for e in out[1]] == [f"ev{i:04d}" for i in range(70)]


class FakeRedis:
    """In-memory rpop/lpush/lindex with Redis list semantics (lpush at head,
    rpop at tail, negative lindex from the tail), as the JAX package's
    tests fake it."""

    def __init__(self):
        self.lists = {}

    def lpush(self, key, value):
        self.lists.setdefault(key, []).insert(
            0, value.encode() if isinstance(value, str) else value)

    def rpop(self, key):
        lst = self.lists.get(key)
        return lst.pop() if lst else None

    def lindex(self, key, index):
        lst = self.lists.get(key, [])
        try:
            return lst[index]
        except IndexError:
            return None


def test_redis_wire_over_the_fake_client():
    q, fake = TLOOP.RedisQueues(client=FakeRedis()), None
    fake = q._r
    fake.lpush("eventQueue", "e1")
    fake.lpush("eventQueue", "e2")
    assert q.pop_event() == "e1"            # rpop = oldest first
    q.write_actions("e1", ["page3", "page1"])
    assert fake.lists["actionQueue"][0] == b"e1,page3,page1"
    fake.lpush("rewardQueue", "a,10")
    fake.lpush("rewardQueue", "b,20")
    assert q.drain_rewards() == [("a", 10.0), ("b", 20.0)]
    assert q.drain_rewards() == []          # the cursor advanced
    fake.lpush("rewardQueue", "c,30")
    assert q.drain_rewards() == [("c", 30.0)]


def test_loop_over_the_fake_redis_equals_jax():
    out = []
    for pkg, kw in ((JLOOP, {}), (TLOOP, {"device": "cpu"})):
        fake = FakeRedis()
        q = pkg.RedisQueues(client=fake)
        for i in range(40):
            fake.lpush("eventQueue", f"session{i:04d}")
        fake.lpush("rewardQueue", "page2,60")
        fake.lpush("rewardQueue", "page3,90")
        with pkg.OnlineLearnerLoop("randomGreedy",
                                   ["page1", "page2", "page3"],
                                   {"random.selection.prob": "0.3"}, q,
                                   seed=5, **kw) as loop:
            stats = loop.run()
        out.append((list(fake.lists["actionQueue"]), stats.events,
                    stats.rewards))
    assert out[0] == out[1] and out[1][1:] == (40, 2)


@pytest.fixture
def broker():
    server = MiniRedisServer("localhost", 0).start()
    client = MiniRedisClient("localhost", server.port)
    yield server, client
    client.close()
    server.close()


def test_loop_over_miniredis_with_a_ledger_equals_in_process(broker):
    """The Redis wire over the port's MiniRedis, the pending ledger armed:
    the actions equal the in-process queues', and every event is acked."""
    _, client = broker
    q = TLOOP.RedisQueues(client=client, pending_queue="pendingQueue")
    client.lpush("eventQueue", *[f"ev{i:04d}" for i in range(100)])
    client.lpush("rewardQueue", "b,50.0", "a,7.5")
    loop = TLOOP.OnlineLearnerLoop("softMax", ["a", "b"], CONFIG, q, seed=3,
                                   device="cpu")
    loop.run()
    wire = [raw.decode() for raw in reversed(client.lrange("actionQueue",
                                                           0, -1))]
    assert client.llen("pendingQueue") == 0
    local = TLOOP.InProcQueues()
    _fill(local, 100, [("b", 50.0), ("a", 7.5)])
    TLOOP.OnlineLearnerLoop("softMax", ["a", "b"], CONFIG, local, seed=3,
                            device="cpu").run()
    assert wire == [",".join([e] + s) for e, s in
                    (local.pop_action() for _ in range(100))]


def test_reclaim_pending_replays_a_dead_consumers_events(broker):
    _, client = broker
    q = TLOOP.RedisQueues(client=client, pending_queue="pendingQueue")
    client.lpush("eventQueue", "e1", "e2", "e3")
    assert [q.pop_event(), q.pop_event()] == ["e1", "e2"]
    q.write_actions("e1", ["a"])            # e1 answered and acked
    q.ack_event("e1")
    # the consumer dies holding e2: a new one replays it
    assert TLOOP.reclaim_pending(client, "pendingQueue", "eventQueue") == 1
    assert client.llen("pendingQueue") == 0
    fresh = TLOOP.RedisQueues(client=client, pending_queue="pendingQueue")
    assert [fresh.pop_event() for _ in range(3)] == ["e3", "e2", None]
    assert client.lrange("actionQueue", 0, -1) == [b"e1,a"]


def test_recover_in_flight_requeues_orphaned_ledger_entries(broker):
    _, client = broker
    q = TLOOP.RedisQueues(client=client, pending_queue="pendingQueue")
    client.lpush("eventQueue", "e1", "e2")
    assert q.pop_event() == "e1"
    # a pop whose reply a dead connection swallowed: in the ledger, unseen
    client.rpoplpush("eventQueue", "pendingQueue")
    assert q.recover_in_flight() == 1
    assert client.lrange("eventQueue", 0, -1) == [b"e2"]
    q.ack_event("e1")
    assert client.llen("pendingQueue") == 0


# -- checkpoints ---------------------------------------------------------------

def test_checkpointer_round_trip_and_steps(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "n": torch.tensor(7, dtype=torch.int32),
            "c": np.asarray([1, 2], np.int64)}
    for step in (1, 5, 9):
        ckpt.save(step, tree)
    assert ckpt.latest_step() == 9 and ckpt.steps() == [5, 9]
    out = ckpt.restore(like=tree)
    assert torch.equal(out["w"], tree["w"]) and out["n"].dtype == torch.int32
    assert out["c"].dtype == np.int64
    bare = ckpt.restore(step=5)
    assert torch.equal(bare["w"], tree["w"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(like={"w": torch.zeros(3), "n": tree["n"],
                           "c": tree["c"]})
    ckpt.close()
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_torn_step_is_never_latest(tmp_path):
    """A step's data on disk without the commit marker (the state a kill
    between the data write and the commit leaves): latest and an
    argument-less restore keep the committed step."""
    import shutil
    ckdir = str(tmp_path / "ck")
    tree = {"w": torch.arange(6.0)}
    ckpt = Checkpointer(ckdir)
    ckpt.save(1, tree)
    ckpt.close()
    shutil.copytree(os.path.join(ckdir, "1"), os.path.join(ckdir, "2"))
    with open(os.path.join(ckdir, "2", "state.pt"), "w") as fh:
        fh.write("torn")
    again = Checkpointer(ckdir)
    assert again.latest_step() == 1
    assert torch.equal(again.restore(like=tree)["w"], tree["w"])


_KILLED_WRITER = r"""
import os, sys, time, torch
from avenir_tpu_torch.utils import checkpoint as C
ckdir = sys.argv[1]
ck = C.Checkpointer(ckdir)
ck.save(1, {"w": torch.arange(4.0)})
ck.wait_until_finished()
real = torch.save
def slow(obj, fh):
    fh.write(b"partial")
    fh.flush()
    open(os.path.join(ckdir, "WRITING"), "w").close()
    time.sleep(60)
C.torch.save = slow
ck.save(2, {"w": torch.arange(4.0) + 1})
ck.wait_until_finished()
"""


def test_sigkill_mid_save_never_truncates_latest(tmp_path):
    ckdir = str(tmp_path / "ck")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILLED_WRITER, ckdir], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        deadline = time.time() + 60
        while not os.path.exists(os.path.join(ckdir, "WRITING")):
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    ckpt = Checkpointer(ckdir)
    assert ckpt.latest_step() == 1 and ckpt.steps() == [1]
    assert torch.equal(ckpt.restore()["w"], torch.arange(4.0))


def test_async_saves_copy_the_state_and_commit_lazily(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    x = torch.zeros(3)
    for step in (1, 2, 3):
        ckpt.save(step, {"x": x})
        x.add_(1.0)                 # changed in place after save returns
    assert ckpt.latest_step() == 3
    assert torch.equal(ckpt.restore()["x"], torch.full((3,), 2.0))
    ckpt.close()
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 3


def test_loop_state_helpers(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    state = {"counts": torch.tensor([1.0, 2.0])}
    save_loop_state(ckpt, 5, state,
                    {"events": 5, "rewards": 2, "actions_written": 5})
    got, stats, step = restore_loop_state(ckpt, state)
    assert step == 5
    assert stats == {"events": 5, "rewards": 2, "actions_written": 5}
    assert torch.equal(got["counts"], state["counts"])


def _seed(n_events, rewards=()):
    q = TLOOP.InProcQueues()
    _fill(q, n_events, rewards)
    return q


def test_resume_restores_state_and_counters(tmp_path):
    ckdir = str(tmp_path / "loop_ck")
    loop = TLOOP.OnlineLearnerLoop("randomGreedy", ["a", "b"], CONFIG,
                                   _seed(6, [("a", 1.0), ("b", 0.1)]),
                                   seed=3, checkpoint_dir=ckdir,
                                   checkpoint_interval=2, device="cpu")
    loop.run()
    loop.close()
    loop2 = TLOOP.OnlineLearnerLoop("randomGreedy", ["a", "b"], CONFIG,
                                    _seed(2), seed=999,
                                    checkpoint_dir=ckdir,
                                    checkpoint_interval=2, device="cpu")
    assert loop2.stats.events == 6 and loop2.resumed_events == 6
    assert _state_equal(loop.learner.state, loop2.learner.state)
    loop2.run()
    assert loop2.stats.events == 8
    loop2.close()


def test_resume_skips_already_applied_rewards(tmp_path):
    ckdir = str(tmp_path / "loop_ck")
    rewards = [("a", 1.0), ("b", 0.25)]
    with TLOOP.OnlineLearnerLoop("randomGreedy", ["a", "b"], CONFIG,
                                 _seed(4, rewards), seed=3,
                                 checkpoint_dir=ckdir, checkpoint_interval=2,
                                 device="cpu") as loop:
        loop.run()
        assert loop.stats.rewards == 2
    with TLOOP.OnlineLearnerLoop("randomGreedy", ["a", "b"], CONFIG,
                                 _seed(2, rewards + [("a", 0.5)]), seed=3,
                                 checkpoint_dir=ckdir, checkpoint_interval=2,
                                 device="cpu") as loop2:
        loop2.run()
        assert loop2.stats.rewards == 3


def test_swap_state_installs_a_snapshot_as_a_restart_would():
    src = TLOOP.OnlineLearnerLoop("softMax", ["a", "b"], CONFIG,
                                  _seed(20, [("a", 3.0)]), seed=1,
                                  device="cpu")
    src.run()
    snapshot = src.learner.state.to_numpy()
    versions = iter([(4, snapshot), None])
    dst = TLOOP.OnlineLearnerLoop("softMax", ["a", "b"], CONFIG, _seed(5),
                                  seed=9, device="cpu",
                                  swap_source=lambda: next(versions, None))
    dst.step()
    assert dst.stats.swaps == 1 and dst.stats.model_version == 4
    ref = TLOOP.OnlineLearnerLoop("softMax", ["a", "b"], CONFIG, _seed(5),
                                  seed=9, device="cpu")
    ref.learner.state = type(src.learner.state).from_numpy(snapshot, "cpu")
    ref.step()
    assert _state_equal(dst.learner.state, ref.learner.state)
    bad = dict(snapshot, probs=np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="probs"):
        dst.swap_state(bad)


# -- the copied modules ----------------------------------------------------------

def test_tracing_exports_as_jax():
    stamps = [{"trace": "t1-64", "stamp": s, "ts": 100.0 + i * 0.25,
               "pid": 7 + (i > 1)}
              for i, s in enumerate(jtracing.TRACE_STAMPS)]
    assert ttracing.chrome_trace(stamps) == jtracing.chrome_trace(stamps)
    for value in ("0.5", "0.5|t3-9", "1e3"):
        assert ttracing.split_reward_trace(value) == \
            jtracing.split_reward_trace(value)


def test_event_seq_rows_and_simulator_equal_jax():
    assert TG.event_seq_rows(60, seed=4) == JG.event_seq_rows(60, seed=4)
    assert TG.EVENT_SEQ_EVENTS == JG.EVENT_SEQ_EVENTS
    jsim = JG.LeadGenSimulator(sel_count_threshold=2, seed=5)
    tsim = TG.LeadGenSimulator(sel_count_threshold=2, seed=5)
    seq = [a for _ in range(30) for a in jsim.actions]
    assert [tsim.observe_action(a) for a in seq] == \
        [jsim.observe_action(a) for a in seq]
    assert tsim.next_event_id() == jsim.next_event_id() == "session00000001"
    assert tsim.best_action == jsim.best_action == "page3"
