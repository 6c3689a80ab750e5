"""The port's broker fleet (``stream/fleet.py``), its fault injector
(``stream/faultnet.py``) and the verb's ``broker.shards`` against the JAX
package's: the consistent-hash routing maps and their minimal movement,
``ShardedQueues``' fan-out (round trip, caps, shed accounting, sentinels,
per-shard recovery, a shard's error propagated), ``migrate_group_queues``
at the tail and at the head, ``FaultNet``'s schedules, and the verb's
actions file and JSON line over two brokers (byte for byte but the
host-time ``overlap_fraction``), with a rerun on the same persistent
broker. Every broker is an in-process MiniRedis."""

import json

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.stream import faultnet as jfaultnet
from avenir_tpu.stream import fleet as jfleet

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.datagen import LeadGenSimulator
from avenir_tpu_torch.stream import faultnet as tfaultnet
from avenir_tpu_torch.stream.fleet import (
    BrokerFleet, ShardedQueues, consistent_route, format_endpoints,
    migrate_group_queues, parse_endpoints)
from avenir_tpu_torch.stream.loop import RedisQueues
from avenir_tpu_torch.stream.miniredis import MiniRedisServer

torch.set_num_threads(2)

GROUPS = [f"g{i}" for i in range(1000)]
ROUTING = {"g0": 0, "g1": 1, "g2": 1}


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", range(1, 9))
def test_consistent_route_equals_jax_with_minimal_movement(n_shards):
    """The map of 1,000 groups over 1-8 shards is the JAX package's; one
    shard more moves groups only onto it, about 1/(N+1) of them, and the
    spread stays within twice even."""
    got = consistent_route(GROUPS, range(n_shards))
    assert got == jfleet.consistent_route(GROUPS, range(n_shards))
    counts = np.bincount(list(got.values()), minlength=n_shards)
    assert counts.min() > 0 and counts.max() <= 2 * len(GROUPS) / n_shards
    grown = consistent_route(GROUPS, range(n_shards + 1))
    moved = [g for g in GROUPS if grown[g] != got[g]]
    assert moved and all(grown[g] == n_shards for g in moved)
    assert len(moved) <= 2 * len(GROUPS) / (n_shards + 1)
    # removing the last shard moves only its groups
    back = consistent_route(GROUPS, range(n_shards))
    assert all(back[g] == grown[g] for g in GROUPS if grown[g] != n_shards)


def test_endpoints_parse_and_format_as_jax():
    spec = "localhost:7000, 10.0.0.2:7001,"
    assert parse_endpoints(spec) == jfleet.parse_endpoints(spec) == [
        ("localhost", 7000), ("10.0.0.2", 7001)]
    assert format_endpoints(parse_endpoints(spec)) == [
        "localhost:7000", "10.0.0.2:7001"]
    for bad in ("nohost", ""):
        with pytest.raises(ValueError):
            parse_endpoints(bad)
    with pytest.raises(ValueError, match="empty fleet"):
        consistent_route(["g0"], [])


# -- the fan-out transport ----------------------------------------------------

@pytest.fixture()
def two_shards():
    s0 = MiniRedisServer().start()
    s1 = MiniRedisServer().start()
    fleet = BrokerFleet([f"{s0.host}:{s0.port}", f"{s1.host}:{s1.port}"])
    try:
        yield fleet
    finally:
        fleet.close()
        s0.close()
        s1.close()


def _fill(fleet, n=9):
    for i in range(n):
        g = f"g{i % 3}"
        fleet.client(ROUTING[g]).lpush(f"eventQueue:{g}", f"{g}:{i}")


def test_pop_write_ack_round_trip_and_cap(two_shards):
    fleet = two_shards
    q = ShardedQueues(fleet, ["g0", "g1", "g2"], ROUTING,
                      stop_sentinel="__STOP__")
    _fill(fleet)
    events = q.pop_events(64)
    assert sorted(events) == sorted(f"g{i % 3}:{i}" for i in range(9))
    # every pop sits in its group's ledger on its shard
    assert fleet.client(0).llen("pendingQueue:g0") == 3
    assert fleet.client(1).llen("pendingQueue:g1") == 3
    assert q.pending_left() == 9
    q.write_and_ack([(e, ["a1"]) for e in events])
    assert q.pending_left() == 0
    assert fleet.client(0).llen("actionQueue") == 3
    assert fleet.client(1).llen("actionQueue") == 6
    _fill(fleet, 30)
    assert len(q.pop_events(7)) == 7       # never over the caller's cap
    assert q.depth() == 23
    q.close()


def test_rewards_prefixed_bounded_with_backlog(two_shards):
    fleet = two_shards
    q = ShardedQueues(fleet, ["g0", "g1", "g2"], ROUTING)
    for i in range(12):
        g = f"g{i % 3}"
        fleet.client(ROUTING[g]).lpush(f"rewardQueue:{g}", f"a{i % 2},1.0")
    pairs = q.drain_rewards()
    assert len(pairs) == 12
    assert all(aid.split(":")[0] in ROUTING for aid, _ in pairs)
    assert q.drain_rewards() == [] and q.reward_backlog == 0
    for _ in range(9):
        fleet.client(0).lpush("rewardQueue:g0", "a0,1.0")
    got = q.drain_rewards(3)
    assert 0 < len(got) <= 3
    assert q.reward_backlog == 9 - len(got)
    q.close()


def test_shed_exact_accounting_and_sentinels(two_shards):
    fleet = two_shards
    q = ShardedQueues(fleet, ["g0", "g1", "g2"], ROUTING,
                      stop_sentinel="__STOP__")
    _fill(fleet, 12)
    fleet.client(1).lpush("eventQueue:g1", "__STOP__")
    shed = q.shed_events(100, newest=True)
    assert len(shed) == 12 and "__STOP__" not in shed
    assert q.depth() == 1                  # the sentinel went back
    assert q.pop_events(10) == []
    assert q.stopped_groups() == ["g1"] and not q.stopped
    # a real event popped after its group's sentinel in one sweep goes
    # back to the queue, its ledger copy retired
    q2 = ShardedQueues(fleet, ["g2"], {"g2": 1}, stop_sentinel="__STOP__")
    c = fleet.client(1)
    c.lpush("eventQueue:g2", "g2:e0", "__STOP__", "g2:late")
    assert q2.pop_events(3) == ["g2:e0"] and q2.stopped
    assert c.lrange("eventQueue:g2", 0, -1) == [b"g2:late"]
    q2.ack_events(["g2:e0"])
    assert c.llen("pendingQueue:g2") == 0
    q.close()
    q2.close()


def test_recover_in_flight_per_shard_and_on_reconnect(two_shards):
    fleet = two_shards
    q = ShardedQueues(fleet, ["g0", "g1", "g2"], ROUTING)
    _fill(fleet, 6)
    got = q.pop_events(6)
    # a pop whose reply died with shard 1: in the ledger, unknown here
    fleet.client(1).lpush("eventQueue:g1", "g1:lost")
    fleet.client(1).rpoplpush("eventQueue:g1", "pendingQueue:g1")
    assert q.recover_in_flight() == 1
    assert fleet.client(1).llen("eventQueue:g1") == 1
    assert q.pending_left() == 6
    q.ack_events(got)
    assert q.pending_left() == 0
    q.close()
    # a shard whose client reconnected mid-sweep reconciles its groups
    # after the sweep's own pops are noted
    real = fleet.client(1)
    real.delete("eventQueue:g1", "pendingQueue:g1")

    class Bumping:
        def __getattr__(self, name):
            return getattr(real, name)

        def pipeline(self):
            p = real.pipeline()
            run = p.execute

            def execute():
                out = run()
                real.reconnects += 1
                return out
            p.execute = execute
            return p
    fleet._clients[1] = Bumping()
    q = ShardedQueues(fleet, ["g0", "g1"], {"g0": 0, "g1": 1})
    real.lpush("eventQueue:g1", "g1:orphan")
    real.rpoplpush("eventQueue:g1", "pendingQueue:g1")
    real.lpush("eventQueue:g1", "g1:0", "g1:1")
    got = q.pop_events(4)
    assert "g1:orphan" not in got
    assert real.llen("eventQueue:g1") == 1
    assert sorted(g for g in got if g.startswith("g1")) == ["g1:0", "g1:1"]
    fleet._clients[1] = real
    q.close()


def test_a_shards_error_propagates(two_shards):
    """A sweep that raises on one shard raises from the fan-out after the
    other shard's sweep has settled; nothing swallows it."""
    fleet = two_shards
    real = fleet.client(1)

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        def pipeline(self):
            raise ConnectionError("shard 1 down")
    fleet._clients[1] = Failing()
    q = ShardedQueues(fleet, ["g0", "g1", "g2"], ROUTING)
    _fill(fleet, 6)
    with pytest.raises(ConnectionError, match="shard 1 down"):
        q.pop_events(6)
    with pytest.raises(ConnectionError, match="shard 1 down"):
        q.drain_rewards()
    fleet._clients[1] = real
    with pytest.raises(ValueError, match="does not own"):
        q.write_actions("gX:1", ["a0"])
    q.close()


@pytest.mark.parametrize("tail", [True, False])
def test_migrate_group_queues(two_shards, tail):
    """The event and reward queues copy over and the pending ledger
    replays onto the new event queue; with ``tail`` the moved entries
    splice below what the new shard already holds (a reward cursor keeps
    its consumed prefix), without it they land at the head as fresh
    pushes. The old side is cleared entry by entry."""
    fleet = two_shards
    c0, c1 = fleet.client(0), fleet.client(1)
    c0.lpush("eventQueue:g9", "e0", "e1", "e2")
    c0.rpoplpush("eventQueue:g9", "pendingQueue:g9")     # e0 in flight
    c0.lpush("rewardQueue:g9", "old0,1.0", "old1,1.0")
    c1.lpush("rewardQueue:g9", "fresh0,1.0")
    assert migrate_group_queues(fleet, "g9", 0, 1, tail=tail) == 5
    for key in ("eventQueue:g9", "pendingQueue:g9", "rewardQueue:g9"):
        assert c0.llen(key) == 0
    assert sorted(c1.lrange("eventQueue:g9", 0, -1)) == [b"e0", b"e1",
                                                          b"e2"]
    rewards = c1.lrange("rewardQueue:g9", 0, -1)
    if tail:
        assert rewards == [b"fresh0,1.0", b"old1,1.0", b"old0,1.0"]
        q = RedisQueues(reward_queue="rewardQueue:g9", client=c1)
        q._reward_cursor = -2               # old0 was consumed
        assert [a for a, _ in q.drain_rewards()] == ["old1", "fresh0"]
    else:
        assert rewards == [b"old1,1.0", b"old0,1.0", b"fresh0,1.0"]


# -- fault injection ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_faultnet_schedules_equal_jax(seed):
    kw = dict(drop_rate=0.05, drop_reply_rate=0.05, delay_rate=0.1,
              window_rate=0.02, window_ops=4)
    t = tfaultnet.FaultNet(seed, **kw)
    j = jfaultnet.FaultNet(seed, **kw)
    for ep in ("localhost:7000", "10.0.0.2:7001"):
        assert t.plan(ep, 500) == j.plan(ep, 500)
        assert [t.decide(ep, op) for op in (0, 99, 4096)] == \
            [j.decide(ep, op) for op in (0, 99, 4096)]
    assert t.env() == j.env()
    assert tfaultnet.FaultNet.from_config(json.loads(t.env())).plan(
        "h:1", 64) == t.plan("h:1", 64)


def test_faultnet_from_env_and_attach(monkeypatch, two_shards):
    monkeypatch.setattr(tfaultnet, "_GLOBAL", None)
    monkeypatch.delenv(tfaultnet.FAULTNET_ENV, raising=False)
    assert tfaultnet.from_env() is None
    net = tfaultnet.FaultNet(3, drop_rate=0.5)
    monkeypatch.setenv(tfaultnet.FAULTNET_ENV, net.env())
    armed = tfaultnet.from_env()
    assert armed.to_config() == net.to_config()
    assert tfaultnet.from_env() is armed          # one per process
    fleet = two_shards
    client = fleet.client(0)
    assert client._faults is None      # nothing armed from the environment
    tfaultnet.attach(fleet, armed)
    assert client._faults is armed and fleet.client(1)._faults is armed
    armed.block(client.endpoint)
    with pytest.raises(OSError, match="partitioned"):
        armed.on_op(client.endpoint, client)
    armed.unblock(client.endpoint)
    tfaultnet.attach(fleet, None)
    assert client._faults is None
    assert client.ping()


# -- the verb over broker.shards ----------------------------------------------

def _write_inputs(d, n_events):
    sim = LeadGenSimulator(sel_count_threshold=1, seed=3)
    rng = np.random.default_rng(0)
    with open(d / "events.txt", "w") as fh:
        fh.write("".join(f"session{i:08d}\n" for i in range(n_events)))
    with open(d / "rewards.txt", "w") as fh:
        for _ in range(n_events // 4):
            action, reward = sim.observe_action(
                sim.actions[int(rng.integers(0, 3))])
            fh.write(f"{action},{reward}\n")
    (d / "p.properties").write_text(
        f"action.list={','.join(sim.actions)}\n"
        f"reward.data.path={d / 'rewards.txt'}\nrandom.seed=7\n"
        "serving.engine=true\n")


def _job(fn, d, out, *extra):
    dev = ["--device", "cpu"] if fn is tmain else []
    assert fn(["ReinforcementLearnerTopology", str(d / "events.txt"),
               str(d / out), "--conf", str(d / "p.properties"),
               *[a for kv in extra for a in ("-D", kv)], *dev]) == 0
    return (d / out).read_bytes()


def _line(capsys):
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= line.pop("overlap_fraction") <= 1.0
    return line


@pytest.mark.parametrize("learner_type",
                         ["softMax", "upperConfidenceBoundTwo"])
def test_broker_shards_verb_byte_identical_to_jax(tmp_path, capsys,
                                                  learner_type):
    """Over two brokers the port's actions file and JSON line equal the
    JAX CLI's, the group's queues on its shard with the ledger retired;
    the file holds the in-process engine's answers."""
    _write_inputs(tmp_path, 300)
    kind = f"learner.type={learner_type}"
    with MiniRedisServer() as s0, MiniRedisServer() as s1:
        spec = f"broker.shards={s0.host}:{s0.port},{s1.host}:{s1.port}"
        j_file = _job(jmain, tmp_path, "j.txt", kind, spec)
        j_line = _line(capsys)
        t_file = _job(tmain, tmp_path, "t.txt", kind, spec)
        t_line = _line(capsys)
        assert t_file == j_file and t_line == j_line
        assert t_line["events"] == 300 and t_line["rewards"] == 75
        shard = t_line["broker_shard"]
        assert shard == consistent_route(["g0"], range(2))["g0"]
        client = BrokerFleet(spec.split("=", 1)[1]).client(shard)
        assert client.llen("pendingQueue:g0") == 0
        assert client.llen("actionQueue:g0") == 0
        client.close()
    inproc = _job(tmain, tmp_path, "local.txt", kind)
    capsys.readouterr()
    assert sorted(t_file.splitlines()) == sorted(inproc.splitlines())


def test_broker_shards_rerun_on_a_persistent_broker(tmp_path, capsys):
    """A second job on the same broker clears its group's residue first:
    the same rewards folded, the same file, as the JAX CLI's."""
    _write_inputs(tmp_path, 80)
    with MiniRedisServer() as srv:
        spec = f"broker.shards={srv.host}:{srv.port}"
        files, lines = [], []
        for fn, out in ((tmain, "t1.txt"), (tmain, "t2.txt"),
                        (jmain, "j.txt")):
            files.append(_job(fn, tmp_path, out, "learner.type=softMax",
                              spec, "broker.group=g7"))
            lines.append(_line(capsys))
    assert files[0] == files[1] == files[2]
    assert lines[0] == lines[1] == lines[2]
    assert lines[0]["rewards"] == 20 and lines[0]["broker_shard"] == 0
