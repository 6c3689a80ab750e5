"""The port's lifecycle package (``lifecycle/``) against the JAX package's,
on the CPU: the registry's files interchangeable both ways, the schema
hash of every learner state and of nested trees equal to JAX's, the
registry's crash and concurrency rules, ``install_state``'s checks, the
drift detectors on the same streams, and a retrain wave's published state
bit-equal."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from avenir_tpu.lifecycle import drift as JD
from avenir_tpu.lifecycle import registry as JR
from avenir_tpu.lifecycle import retrain as JRT
from avenir_tpu.models.bandits.learners import Learner as JLearner

from avenir_tpu_torch.lifecycle import drift as TD
from avenir_tpu_torch.lifecycle import registry as TR
from avenir_tpu_torch.lifecycle import retrain as TRT
from avenir_tpu_torch.lifecycle.swap import LifecycleClient, install_state
from avenir_tpu_torch.models.bandits.learners import FIELDS, Learner
from avenir_tpu_torch.stream import loop as TLOOP

torch.set_num_threads(2)

ACTIONS = ["a", "b", "c"]
TYPES = ["intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
         "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
         "softMax", "actionPursuit", "rewardComparison", "exponentialWeight"]
PAIRS = [(ACTIONS[i % 3], 5.0 + 3 * i) for i in range(40)]


def _jax_leaves(state):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _files(reg):
    """Each version's manifest but ``created_at``, its payload's leaves
    (name, dtype, values) and ``LATEST``."""
    out = {}
    for name in sorted(os.listdir(reg)):
        path = os.path.join(reg, name)
        if name == "LATEST":
            out[name] = open(path).read()
            continue
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        manifest.pop("created_at")
        with np.load(os.path.join(path, "payload.npz")) as zf:
            leaves = [(k, zf[k].dtype.str, zf[k].tolist())
                      for k in sorted(zf.files)]
        out[name] = (manifest, leaves)
    return out


@pytest.mark.parametrize("learner_type", TYPES)
def test_registry_files_interchangeable_both_ways(tmp_path, learner_type):
    """The same state published by each package gives the same files but
    ``created_at``; each package restores the other's into its learner,
    bit for bit."""
    j = JLearner(learner_type, ACTIONS, {}, seed=4)
    j.set_reward_batch(PAIRS)
    t = Learner(learner_type, ACTIONS, {}, 4, device="cpu")
    t.set_reward_batch(PAIRS)
    for reg, pub, state in ((tmp_path / "j", JR, j.state),
                            (tmp_path / "t", TR, t.state)):
        r = pub.SnapshotRegistry(str(reg), max_to_keep=2)
        for v in range(3):
            r.publish(state, kind="learner-state", train_rows=v,
                      extra={"learner_type": learner_type})
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert sorted(os.listdir(tmp_path / "t")) == [
        "LATEST", "v0000002", "v0000003"]

    fresh = Learner(learner_type, ACTIONS, {}, 99, device="cpu")
    restored = TR.SnapshotRegistry(str(tmp_path / "j")).latest().restore(
        like=fresh.state)
    for (name, _), want in zip(FIELDS, _jax_leaves(j.state)):
        got = getattr(restored, name)
        assert got.dtype == getattr(fresh.state, name).dtype
        assert np.array_equal(got.numpy().astype(want.dtype), want), name
    jfresh = JLearner(learner_type, ACTIONS, {}, seed=99)
    jrestored = JR.SnapshotRegistry(str(tmp_path / "t")).latest().restore(
        like=jfresh.state)
    for got, want in zip(_jax_leaves(jrestored), _jax_leaves(j.state)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("learner_type", TYPES)
def test_schema_hash_of_each_learner_equals_jax(learner_type):
    for n_actions, conf in ((3, {}), (5, {"bin.width": "20"})):
        acts = [f"x{i}" for i in range(n_actions)]
        assert TR.state_schema_hash(
            Learner(learner_type, acts, conf, 0, device="cpu").state) == \
            JR.state_schema_hash(JLearner(learner_type, acts, conf).state)


def test_schema_hash_reads_no_values():
    """The hash takes shapes and dtypes from the tensors' metadata: tensors
    on the meta device, which hold no values to read, hash as the CPU
    state and tree do."""
    state = Learner("softMax", ACTIONS, {}, 0, device="cpu").state
    meta = type(state)(**{name: getattr(state, name).to("meta")
                          for name, _ in FIELDS})
    with pytest.raises(NotImplementedError):
        meta.key.cpu()
    assert TR.state_schema_hash(meta) == TR.state_schema_hash(state)
    tree = _nested(torch.as_tensor)
    assert TR.state_schema_hash(_nested(
        lambda a: torch.as_tensor(a).to("meta"))) == \
        TR.state_schema_hash(tree)


def _nested(array):
    """One tree of each node kind, its leaves made by ``array``."""
    return {"w": [array(np.arange(6, dtype=np.float32).reshape(2, 3)),
                  (array(np.int32(3)),)],
            "b": {"z": None, "y": (array(np.zeros(4, np.int64)), 7),
                  "x": []},
            "a": (1.5, [array(np.ones((1, 2), np.float64))])}


def test_schema_hash_and_treedef_of_nested_trees_equal_jax(tmp_path):
    import jax
    tree = _nested(np.asarray)
    ttree = _nested(torch.as_tensor)
    leaves, treedef = TR.tree_flatten(ttree)
    assert treedef == str(jax.tree_util.tree_structure(tree))
    for got, want in zip(leaves, jax.tree_util.tree_leaves(tree)):
        assert np.asarray(want).dtype == got.dtype
        assert np.array_equal(got, np.asarray(want))
    assert TR.state_schema_hash(ttree) == JR.state_schema_hash(tree)
    for other in ({}, [], (), None, 3, {"k": ({"q": []},)},
                  {"d": Learner("softMax", ACTIONS, {}, 0,
                                device="cpu").state}):
        jother = other
        if isinstance(other, dict) and "d" in other:
            jother = {"d": JLearner("softMax", ACTIONS, {}).state}
        assert TR.tree_flatten(other)[1] == \
            str(jax.tree_util.tree_structure(jother))
    # a nested tree published by the port restores in JAX and back
    TR.SnapshotRegistry(str(tmp_path)).publish(ttree)
    back = JR.SnapshotRegistry(str(tmp_path)).latest().restore(like=tree)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    again = TR.SnapshotRegistry(str(tmp_path)).latest().restore(like=ttree)
    assert TR.state_schema_hash(again) == TR.state_schema_hash(ttree)
    assert torch.equal(again["w"][0], ttree["w"][0])


def test_monotonic_versions_parent_chain_and_latest_where(tmp_path):
    reg = TR.SnapshotRegistry(str(tmp_path))
    assert reg.latest() is None and reg.versions() == []
    for g in ("g0", "g1", "g0"):
        reg.publish({"w": np.zeros(2)}, kind="learner-handoff",
                    extra={"group": g})
    reg.publish(file_path=__file__, kind="model")
    assert reg.versions() == [1, 2, 3, 4]
    assert [reg.get(v).manifest["parent_version"] for v in (1, 2, 3, 4)] \
        == [None, 1, 2, 3]
    assert reg.latest_where(kind="learner-handoff", group="g0").version == 3
    assert reg.latest_where(kind="learner-handoff", group="g1").version == 2
    assert reg.latest_where(kind="nothing") is None
    head = reg.latest()
    assert not head.has_payload and os.path.exists(head.artifact_path())
    with pytest.raises(FileNotFoundError):
        reg.get(1).artifact_path()
    with pytest.raises(ValueError, match="exactly one"):
        reg.publish()
    with pytest.raises(ValueError, match="leaves"):
        reg.get(1).restore(like={"w": np.zeros(2), "v": np.zeros(1)})
    assert reg.prune(2) == [1, 2] and reg.versions() == [3, 4]


def test_torn_latest_and_partial_dirs_fall_back_as_jax(tmp_path):
    for pub, sub in ((TR, "t"), (JR, "j")):
        reg = pub.SnapshotRegistry(str(tmp_path / sub))
        reg.publish({"w": np.zeros(2)})
        reg.publish({"w": np.ones(2)})
        with open(os.path.join(reg.directory, "LATEST"), "w") as fh:
            fh.write('{"vers')
        os.makedirs(os.path.join(reg.directory, "v0000009"))
    for sub in ("t", "j"):
        assert TR.SnapshotRegistry(str(tmp_path / sub)).latest_version() \
            == JR.SnapshotRegistry(str(tmp_path / sub)).latest_version() \
            == 2


def test_orphan_temp_dirs_are_invisible_and_swept(tmp_path):
    reg = TR.SnapshotRegistry(str(tmp_path))
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    orphan = tmp_path / f".tmp-{dead.pid}-abc"
    live = tmp_path / f".tmp-{os.getpid()}-def"
    stale = tmp_path / f".tmp-{os.getpid()}-old"
    for d in (orphan, live, stale):
        d.mkdir()
        (d / "manifest.json").write_text("{}")
    old = time.time() - 2 * 3600
    os.utime(stale, (old, old))
    assert reg.versions() == [] and reg.latest() is None
    reg.publish({"w": np.zeros(1)})
    names = set(os.listdir(tmp_path))
    assert live.name in names
    assert orphan.name not in names and stale.name not in names


def test_watcher_surfaces_each_head_once_and_skips_to_the_newest(tmp_path):
    reg = TR.SnapshotRegistry(str(tmp_path))
    reg.publish({"w": np.zeros(1)})
    watcher = reg.subscribe()
    assert watcher.poll() is None
    reg.publish({"w": np.ones(1)})
    reg.publish({"w": np.full(1, 2.0)})
    snap = watcher.poll()
    assert snap.version == 3 and watcher.poll() is None
    assert reg.subscribe(from_version=0).poll().version == 3


def test_install_state_checks_before_it_changes_anything():
    learner = Learner("softMax", ACTIONS, {}, 1, device="cpu")
    before = learner.state.to_numpy()
    snapshot = Learner("softMax", ACTIONS, {}, 2, device="cpu")
    snapshot.set_reward_batch(PAIRS)
    bad_shape = dict(snapshot.state.to_numpy(),
                     hist=np.zeros((3, 4), np.float32))
    for bad, message in ((bad_shape, "field hist shape"),
                         ({"key": np.zeros(2)}, "structure"),
                         (Learner("softMax", ["a", "b"], {}, 0,
                                  device="cpu").state, "shape"),
                         ([snapshot.state], "structure")):
        with pytest.raises(ValueError, match=message):
            install_state(learner, bad)
        for name, value in learner.state.to_numpy().items():
            assert np.array_equal(value, before[name])
    install_state(learner, snapshot.state)
    assert learner.state.reward_sum is not snapshot.state.reward_sum
    for name, value in learner.state.to_numpy().items():
        assert np.array_equal(value, snapshot.state.to_numpy()[name])
    # a tree state: leaf by leaf, with JAX's leaf message
    holder = type("Holder", (), {})()
    holder.state = {"w": torch.zeros(2), "n": [torch.zeros(3)]}
    with pytest.raises(ValueError, match="leaf 0 shape"):
        install_state(holder, {"w": torch.ones(2), "n": [torch.ones(4)]})
    install_state(holder, {"w": np.ones(2), "n": [np.full(3, 2.0)]})
    assert holder.state["n"][0].tolist() == [2.0, 2.0, 2.0]
    # a learner with a hook of its own gets the snapshot
    got = []
    hooked = type("Hooked", (), {"install_state": got.append})()
    install_state(hooked, "anything")
    assert got == ["anything"]


def _stream(seed, n=600, shift_at=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, n)
    x[shift_at:] += 2.5
    return x.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_detectors_flag_where_jax_flags(seed):
    stream = _stream(seed)
    pairs = [
        (TD.PageHinkley(threshold=20.0), JD.PageHinkley(threshold=20.0)),
        (TD.PageHinkley(direction="down", threshold=10.0, min_samples=5),
         JD.PageHinkley(direction="down", threshold=10.0, min_samples=5)),
        (TD.WindowedMeanDetector(window=64, threshold=0.8),
         JD.WindowedMeanDetector(window=64, threshold=0.8)),
        (TD.ThresholdDetector(1.5), JD.ThresholdDetector(1.5)),
        (TD.ThresholdDetector(-1.0, direction="down"),
         JD.ThresholdDetector(-1.0, direction="down"))]
    for t, j in pairs:
        flags = [t.update(x) for x in stream]
        assert flags == [j.update(x) for x in stream]
    detector = TD.PageHinkley(threshold=20.0)
    assert any(detector.update(x) for x in stream)
    with pytest.raises(ValueError):
        TD.PageHinkley(direction="sideways")
    with pytest.raises(ValueError):
        TD.ThresholdDetector(1.0, direction="both")


def test_drift_monitor_requests_on_the_first_alarm_at_any_uptime(
        monkeypatch):
    """The port's documented deviation: the first alarm requests a retrain
    even 1 s after boot; later ones wait out the cooldown."""
    clock = {"now": 1.0}
    monkeypatch.setattr(TD.time, "monotonic", lambda: clock["now"])
    requests = []
    mon = TD.DriftMonitor({"reward": TD.ThresholdDetector(10.0)},
                          on_drift=lambda: requests.append(clock["now"]),
                          cooldown_s=5.0)
    for now, x in ((1.0, 11.0), (1.5, 0.0), (2.0, 12.0), (6.5, 0.0),
                   (7.0, 13.0)):
        clock["now"] = now
        mon.observe("reward", x)
    assert requests == [1.0, 7.0]
    assert mon.alarms == 3 and mon.alarms_by_signal == {"reward": 3}
    assert mon.observe("unknown", 99.0) is False
    assert mon.observe_rewards([0.0, 20.0]) is True


def test_retrain_wave_publishes_the_state_jax_publishes(tmp_path):
    for learner_type in ("exponentialWeight", "intervalEstimator"):
        for pub, rt, sub, kw in ((JR, JRT, "j", {}),
                                 (TR, TRT, "t", {"device": "cpu"})):
            reg = pub.SnapshotRegistry(str(tmp_path / learner_type / sub))
            daemon = rt.RetrainDaemon(reg, rt.bandit_refit_train_fn(
                learner_type, ACTIONS, {"reward.scale": 100},
                lambda: PAIRS, seed=3, **kw))
            snap = daemon.run_once()
            assert snap.version == 1 and daemon.waves == 1
            assert snap.manifest["train_rows"] == len(PAIRS)
        assert _files(tmp_path / learner_type / "t") == \
            _files(tmp_path / learner_type / "j")


def test_retrain_daemon_background_waves_and_failures(tmp_path):
    reg = TR.SnapshotRegistry(str(tmp_path))
    calls = []

    def train():
        calls.append(1)
        return {"pytree": {"w": np.full(2, float(len(calls)))},
                "train_rows": len(calls)}
    with TRT.RetrainDaemon(reg, train) as daemon:
        daemon.request()
        assert daemon.wait_for_waves(1, timeout=30)
        daemon.request()
        assert daemon.wait_for_waves(2, timeout=30)
    assert reg.versions() == [1, 2] and daemon.last_version == 2

    def broken():
        raise RuntimeError("no data")
    bad = TRT.RetrainDaemon(reg, broken)
    assert bad.run_once() is None
    assert bad.errors == 1 and isinstance(bad.last_error, RuntimeError)
    assert reg.versions() == [1, 2]
    assert not bad.wait_for_waves(1, timeout=0.05)


def test_lifecycle_client_swaps_matching_targets_and_rejects_the_rest(
        tmp_path):
    reg = TR.SnapshotRegistry(str(tmp_path))
    loops = {g: TLOOP.OnlineLearnerLoop("softMax", ACTIONS, {},
                                        TLOOP.InProcQueues(), seed=i,
                                        device="cpu")
             for i, g in enumerate(("g0", "g1"))}
    client = LifecycleClient(str(tmp_path))
    for g, loop in loops.items():
        client.register(g, loop)
    assert client.poll_and_swap() is None
    snap = Learner("softMax", ACTIONS, {}, 7, device="cpu")
    snap.set_reward_batch(PAIRS)
    reg.publish(snap.state, kind="learner-state")
    assert client.poll_and_swap() == 1
    assert all(loop.stats.model_version == 1 for loop in loops.values())
    reg.publish(snap.state, kind="learner-state", extra={"group": "g1"})
    assert client.poll_and_swap() == 2
    assert loops["g0"].stats.model_version == 1
    assert loops["g1"].stats.model_version == 2
    reg.publish(Learner("softMax", ["a", "b"], {}, 0, device="cpu").state)
    reg.publish(file_path=__file__)
    assert client.poll_and_swap() is None and client.rejected == 2
    reg.publish(snap.state)
    assert client.poll_and_swap() == 5 and client.swaps == 3
