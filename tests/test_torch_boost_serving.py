"""Boosted serving in the port against the JAX package: the serving bins
and every leaf of the serving tables of a JAX-grown model carried across
(``model_from_payload``), the margins of ``_serve_margins`` bit for bit
at depth caps 3 and 6, at round counts whose padded rounds axis is 4 to
128, at every power-of-two batch up to 256 (and 3 and 100) and at cap 3
every batch of 1-17, ``BoostServingLearner``'s action stream, the budget errors,
``boost_refit_train_fn``'s snapshots restoring in the other package's
registry both ways, and the engine over MiniRedis with a drift monitor
and a retrain daemon: a swap lands mid-drain, every event is answered
and the pending ledger is empty."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.lifecycle.registry import SnapshotRegistry as JRegistry
from avenir_tpu.lifecycle.registry import state_schema_hash as jhash
from avenir_tpu.lifecycle.retrain import boost_refit_train_fn as jrefit
from avenir_tpu.models import boost as JB
from avenir_tpu.models import tree as JT
from avenir_tpu.stream.engine import BoostServingLearner as JLearner

from avenir_tpu_torch.lifecycle.registry import SnapshotRegistry
from avenir_tpu_torch.lifecycle.registry import state_schema_hash
from avenir_tpu_torch.lifecycle.retrain import boost_refit_train_fn
from avenir_tpu_torch.models import boost as TB
from avenir_tpu_torch.models import tree as TT
from avenir_tpu_torch.stream.engine import BoostServingLearner

from _torch_parity import featurizers

torch.set_num_threads(2)

ROUNDS, DEPTH, NODE_BUDGET = 8, 3, 64
BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 3, 100]
# round counts whose padded rounds axis kt is 4, 8, 16 (10), 32 (30), 64
# (40) and 128 (70): XLA sums each kt's trees in another order, and at
# 16 and 32 the order changes between batches of 1, of 2-8 and of 9 on
WIDE_ROUNDS = [3, ROUNDS, 10, 30, 40, 70]


def _configs(rounds=ROUNDS):
    kw = dict(n_rounds=rounds, learning_rate=0.3, base_score=0.1)
    tree = dict(max_depth=DEPTH, device_node_budget=NODE_BUDGET)
    return (JB.BoostConfig(tree=JT.TreeConfig(**tree), **kw),
            TB.BoostConfig(tree=TT.TreeConfig(**tree), **kw))


def _budgets(cfg):
    return {"rounds_budget": cfg.n_rounds,
            "node_budget": (cfg.tree.max_depth + 1)
            * cfg.tree.device_node_budget}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(jax train, torch train, jax test, torch test), and for each round
    count of ``WIDE_ROUNDS`` (jax model, the same model in the port, the
    JAX tables, the port's), the rounds budget the round count."""
    rows = JG.retarget_rows(1500, seed=21)
    jfz, tfz = featurizers(JG._RETARGET_SCHEMA_JSON, rows[:1200])
    jt, tt = jfz.transform(rows[:1200]), tfz.transform(rows[:1200])
    jx, tx = jfz.transform(rows[1200:]), tfz.transform(rows[1200:])
    out = {"tables": (jt, tt, jx, tx)}
    path = str(tmp_path_factory.mktemp("boost") / "m.json")
    for rounds in WIDE_ROUNDS:
        jcfg, _ = _configs(rounds)
        jm = JB.grow_boosted(jt, jcfg)
        JB.save_boosted(jm, path)
        with open(path) as fh:
            tm = TB.model_from_payload(json.load(fh))
        out[rounds] = (jm, tm, JB.serving_tables(jm, jt, **_budgets(jcfg)),
                       TB.serving_tables(tm, tt, **_budgets(jcfg)))
    return out


@pytest.mark.parametrize("rounds", [ROUNDS, 3])
def test_bins_and_every_table_leaf_equal(served, rounds):
    jt, tt, jx, tx = served["tables"]
    _, _, jtab, ttab = served[rounds]
    assert np.array_equal(JB.serving_bins(jx), TB.serving_bins(tx))
    assert TB.serving_bins(tx).dtype == np.int32
    assert sorted(ttab) == sorted(jtab)
    for key, leaf in jtab.items():
        got = ttab[key].numpy()
        assert got.dtype == np.asarray(leaf).dtype, key
        assert got.shape == np.asarray(leaf).shape, key
        assert got.tobytes() == np.asarray(leaf).tobytes(), key
    assert state_schema_hash(ttab) == jhash(jtab)


@pytest.mark.parametrize("cap", [3, 6])
@pytest.mark.parametrize("rounds", WIDE_ROUNDS)
def test_serve_margins_bit_equal(served, rounds, cap):
    _, _, jx, _ = served["tables"]
    jm, _, jtab, ttab = served[rounds]
    bins = JB.serving_bins(jx)
    # every batch of 1-17 at cap 3; the engine's power-of-two buckets at 6
    ragged = list(range(1, 18)) if cap == 3 else []
    for m in sorted(set(BUCKETS + ragged)):
        idx = (np.arange(m) * 7) % bins.shape[0]
        jmar, jcls = JB._serve_margins(jtab, jnp.asarray(bins[idx]),
                                       depth=cap)
        tmar, tcls = TB._serve_margins(ttab, torch.as_tensor(bins[idx]),
                                       depth=cap)
        assert tmar.dtype == torch.float32 and tcls.dtype == torch.int32
        assert tmar.numpy().tobytes() == np.asarray(jmar).tobytes(), m
        assert np.array_equal(tcls.numpy(), np.asarray(jcls)), m
    # the host walk's classes, over the whole test table
    _, tm, _, _ = served[rounds]
    all_bins = torch.as_tensor(bins)
    assert np.array_equal(
        TB._serve_margins(ttab, all_bins, depth=cap)[1].numpy(),
        jm.predict(jx))


def test_serving_budget_errors_carry_the_jax_messages(served):
    jt, tt, _, _ = served["tables"]
    jm, tm, _, _ = served[ROUNDS]
    for kw, msg in (({"rounds_budget": 4}, "serving rounds budget holds 4"),
                    ({"node_budget": 2}, "serving node budget holds 2")):
        with pytest.raises(ValueError) as jerr:
            JB.serving_tables(jm, jt, **kw)
        with pytest.raises(ValueError, match=msg) as terr:
            TB.serving_tables(tm, tt, **kw)
        assert str(terr.value) == str(jerr.value)


def test_learner_action_stream_equals_jax(served):
    _, _, jx, tx = served["tables"]
    jm, tm, jtab, ttab = served[ROUNDS]
    jl = JLearner(jtab, JB.serving_bins(jx), jm.class_values, depth=DEPTH)
    tl = BoostServingLearner(ttab, TB.serving_bins(tx), tm.class_values,
                             depth=DEPTH)
    # warming scores the ring's first rows and moves the cursor, as JAX's
    tl.warm(16)
    jl.warm(16)
    assert tl._cursor == jl._cursor == 31
    for n in (1, 5, 64, 7, 300, 33, 256):
        handle = tl.next_action_batch_async(n)
        assert handle[0].shape == (tl._bucket(n),)
        assert tl.resolve_action_batch(handle) == \
            jl.resolve_action_batch(jl.next_action_batch_async(n))
    tl.set_reward_batch([("yes", 1.0), ("no", 0.5)])
    assert (tl.reward_count, tl.reward_sum) == (2, 1.5)


def test_refit_snapshots_restore_across_packages(served, tmp_path):
    """Each package's ``boost_refit_train_fn`` publishes
    ``boost-serving-tables``; the other package's registry restores it
    into its own live tables, equal to its own wave's, with one schema
    hash."""
    jt, tt, _, _ = served["tables"]
    jcfg, tcfg = _configs()
    jreg = JRegistry(str(tmp_path / "j"))
    treg = SnapshotRegistry(str(tmp_path / "t"))
    jwave, twave = jrefit(lambda: jt, jcfg)(), boost_refit_train_fn(
        lambda: tt, tcfg)()
    for wave, reg in ((jwave, jreg), (twave, treg)):
        assert wave["kind"] == "boost-serving-tables"
        reg.publish(wave["pytree"], kind=wave["kind"],
                    train_rows=wave["train_rows"], extra=wave["extra"])
    assert jwave["extra"] == twave["extra"]
    assert jwave["train_rows"] == twave["train_rows"] == 1200
    jsnap = SnapshotRegistry(str(tmp_path / "j")).latest()
    tsnap = JRegistry(str(tmp_path / "t")).latest()
    assert jsnap.schema_hash == tsnap.schema_hash == \
        state_schema_hash(twave["pytree"])
    assert jsnap.manifest["kind"] == tsnap.manifest["kind"]
    into_port = jsnap.restore(like=twave["pytree"])
    into_jax = tsnap.restore(like=jwave["pytree"])
    for key, leaf in twave["pytree"].items():
        assert into_port[key].dtype == leaf.dtype
        assert torch.equal(into_port[key], leaf), key
        assert np.asarray(into_jax[key]).tobytes() == \
            np.asarray(jwave["pytree"][key]).tobytes(), key


def test_engine_with_drift_and_daemon_swaps_and_answers_all(served,
                                                           tmp_path):
    """``scripts/boost_smoke.py``'s served leg at a small size: a wave
    published before the drain swaps in mid-drain, a reward regime shift
    alarms the Page-Hinkley monitor and its wave publishes, every event
    is answered once and the ledger is empty."""
    from avenir_tpu_torch.lifecycle.drift import DriftMonitor, PageHinkley
    from avenir_tpu_torch.lifecycle.retrain import RetrainDaemon
    from avenir_tpu_torch.stream.engine import ServingEngine
    from avenir_tpu_torch.stream.loop import RedisQueues
    from avenir_tpu_torch.stream.miniredis import (
        MiniRedisClient, MiniRedisServer)
    _, tt, _, tx = served["tables"]
    _, tm, _, ttab = served[ROUNDS]
    _, tcfg = _configs()
    n_events = 600
    registry = SnapshotRegistry(str(tmp_path / "registry"))
    daemon = RetrainDaemon(registry, boost_refit_train_fn(lambda: tt, tcfg))
    assert daemon.run_once() is not None, daemon.last_error
    monitor = DriftMonitor(
        {"reward": PageHinkley(delta=0.005, threshold=5.0, min_samples=30)},
        on_drift=daemon.request, cooldown_s=0.0)
    daemon.start()
    try:
        learner = BoostServingLearner(ttab, TB.serving_bins(tx),
                                      tm.class_values, depth=DEPTH)
        learner.warm(64)
        with MiniRedisServer() as srv:
            client = MiniRedisClient(srv.host, srv.port)
            for i in range(0, n_events, 200):
                client.lpush("eventQueue",
                             *[f"e{j:05d}" for j in range(i, i + 200)])
            rng = np.random.default_rng(3)
            client.lpush("rewardQueue", *[
                f"{tm.class_values[i % 2]},"
                f"{(1.0 if i < 150 else 0.0) + 0.05 * rng.standard_normal()}"
                for i in range(300)])
            queues = RedisQueues(client=client, pending_queue="pendingQueue")
            watcher = registry.subscribe(from_version=0)
            box = {}

            def swap_source():
                snap = watcher.poll()
                if snap is None:
                    return None
                return snap.version, snap.restore(
                    like=box["engine"].learner.state)
            engine = ServingEngine("boost", tm.class_values, {}, queues,
                                   learner=learner, swap_source=swap_source,
                                   drift_monitor=monitor, device="cpu")
            box["engine"] = engine
            stats = engine.run()
            answered = client.lrange("actionQueue", 0, -1)
            pending = client.llen("pendingQueue")
            client.close()
        assert stats.events == n_events and len(answered) == n_events
        assert len({a.split(b",")[0] for a in answered}) == n_events
        assert pending == 0
        assert stats.swaps >= 1 and stats.model_version >= 1
        assert monitor.alarms >= 1
        assert daemon.wait_for_waves(2, timeout=60)
    finally:
        daemon.stop()
    assert daemon.errors == 0 and daemon.last_error is None
    assert [registry.get(v).manifest["kind"] for v in registry.versions()] \
        == ["boost-serving-tables"] * len(registry.versions())
