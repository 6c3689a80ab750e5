"""The port's ``GroupedLearner`` and ``GroupedServingEngine`` against the
JAX package's: for each of the ten learners at 1, 4 and 16 contexts, the
actions of ``next_all`` and the state's bits after ``reward_all`` and
``reward_masked`` over several steps (the unmasked contexts unchanged bit
for bit), and the grouped engine's action queue over in-process queues
and over ``ShardedQueues`` on two in-process brokers."""

import itertools

import numpy as np
import pytest
import torch

from avenir_tpu.stream.engine import GroupedServingEngine as JEngine
from avenir_tpu.stream.fleet import BrokerFleet as JFleet
from avenir_tpu.stream.fleet import ShardedQueues as JSharded
from avenir_tpu.stream.loop import GroupedLearner as JGrouped
from avenir_tpu.stream.loop import InProcQueues as JQueues

from avenir_tpu_torch.models.bandits.learners import FIELDS
from avenir_tpu_torch.stream.engine import GroupedServingEngine
from avenir_tpu_torch.stream.fleet import BrokerFleet, ShardedQueues
from avenir_tpu_torch.stream.loop import GroupedLearner, InProcQueues
from avenir_tpu_torch.stream.miniredis import MiniRedisServer

torch.set_num_threads(2)

TYPES = ["intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
         "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
         "softMax", "actionPursuit", "rewardComparison", "exponentialWeight"]
ACTIONS = ["a", "b", "c"]
CONF = {"random.selection.prob": 0.5, "prob.reduction.algorithm": "linear",
        "prob.reduction.constant": 150, "reward.scale": 100,
        "min.sample.size": 3, "min.reward.distr.sample": 2}
STEPS = 6


def _fields(states, jax_side):
    out = {}
    for name, _ in FIELDS:
        leaf = getattr(states, name)
        arr = (np.asarray(leaf) if jax_side
               else leaf.detach().cpu().numpy()).copy()
        out[name] = arr.astype(np.int64) if name == "key" else arr
    return out


def _assert_bits(j, t, what):
    for name in j:
        assert j[name].dtype == t[name].dtype, (what, name)
        assert j[name].tobytes() == t[name].tobytes(), (what, name)


@pytest.mark.parametrize("n_groups", [1, 4, 16])
@pytest.mark.parametrize("learner_type", TYPES)
def test_grouped_steps_bit_equal_to_jax(learner_type, n_groups):
    rng = np.random.default_rng(n_groups)
    jg = JGrouped(learner_type, n_groups, ACTIONS, CONF, seed=5)
    tg = GroupedLearner(learner_type, n_groups, ACTIONS, CONF, seed=5,
                        device="cpu")
    _assert_bits(_fields(jg.states, True), _fields(tg.states, False), "init")
    for step in range(STEPS):
        assert tg.next_all() == jg.next_all(), step
        acts = [ACTIONS[i] for i in rng.integers(0, 3, n_groups)]
        rew = rng.integers(0, 100, n_groups).astype(float).tolist()
        jg.reward_all(acts, rew)
        tg.reward_all(acts, rew)
        idx = rng.integers(0, 3, n_groups)
        r2 = rng.integers(0, 100, n_groups).astype(np.float32)
        mask = rng.random(n_groups) < 0.5
        before = _fields(tg.states, False)
        jg.reward_masked(idx, r2, mask)
        tg.reward_masked(idx, r2, mask)
        after = _fields(tg.states, False)
        for name in after:
            assert after[name][~mask].tobytes() == \
                before[name][~mask].tobytes(), (step, name)
        _assert_bits(_fields(jg.states, True), after, step)


def test_steps_write_the_state_in_place():
    tg = GroupedLearner("softMax", 4, ACTIONS, CONF, seed=1, device="cpu")
    ptrs = [getattr(tg.states, name).data_ptr() for name, _ in FIELDS]
    handle = tg.next_all_async()
    assert handle.shape == (4,)
    tg.reward_all(["a", "b", "c", "a"], [1.0, 2.0, 3.0, 4.0])
    tg.reward_masked([0, 1, 2, 0], [1.0, 2.0, 3.0, 4.0],
                     [True, False, True, False])
    assert [getattr(tg.states, name).data_ptr()
            for name, _ in FIELDS] == ptrs
    assert tg._action_index == {"a": 0, "b": 1, "c": 2}
    with pytest.raises(ValueError, match="not in list"):
        tg.reward_all(["a", "zzz"], [1.0, 2.0])
    with pytest.raises(ValueError, match="invalid learner type"):
        GroupedLearner("nope", 2, ACTIONS, CONF, device="cpu")


def _fill(q, groups, waves, rewards, push_event, push_reward):
    for w in range(waves):
        for g in groups:
            push_event(f"{g}:ev{w}")
    for gi, (g, action) in enumerate(rewards):
        push_reward(f"{g}:{action}", float(5 + gi))


@pytest.mark.parametrize("learner_type", ["softMax", "upperConfidenceBoundOne",
                                          "sampsonSampler"])
def test_grouped_engine_action_queue_equals_jax(learner_type):
    """Balanced traffic, an unbalanced tail (contexts with no event in a
    wave still step) and rewards for some contexts: the same actions in
    the same order as the JAX engine's, and the sequential ``next_all``
    of a learner given the same masked fold."""
    groups = [f"g{i}" for i in range(4)]
    rewards = [("g1", "b"), ("g2", "c"), ("g1", "a")]
    out, stats = [], []
    for engine_cls, queues_cls, extra in (
            (JEngine, JQueues, {}), (GroupedServingEngine, InProcQueues,
                                     {"device": "cpu"})):
        q = queues_cls()
        _fill(q, groups, 3, rewards, q.push_event, q.push_reward)
        for tail in ("g0:x0", "g3:x1", "g0:x2"):
            q.push_event(tail)
        eng = engine_cls(learner_type, groups, ACTIONS, CONF, q, seed=5,
                         **extra)
        stats.append(eng.run())
        got = []
        while (entry := q.pop_action()) is not None:
            got.append((entry[0], entry[1]))
        out.append(got)
    assert out[1] == out[0]
    assert stats[1].events == stats[0].events == 15
    assert stats[1].rewards == stats[0].rewards == 3
    assert stats[1].batches == stats[0].batches
    # the first three waves are sequential next_all after the fold
    ref = GroupedLearner(learner_type, 4, ACTIONS, CONF, seed=5,
                         device="cpu")
    ref.reward_masked([0, 1, 2, 0], [0.0, 5.0, 6.0, 0.0],
                      [False, True, True, False])
    ref.reward_masked([0, 0, 0, 0], [0.0, 7.0, 0.0, 0.0],
                      [False, True, False, False])
    expect = {f"g{gi}:ev{w}": action for w in range(3)
              for gi, action in enumerate(ref.next_all())}
    assert {e: a[0] for e, a in out[1] if e in expect} == expect


def test_grouped_engine_unknown_group_or_action_raises():
    q = InProcQueues()
    q.push_event("nope:e1")
    eng = GroupedServingEngine("softMax", ["g0"], ACTIONS, CONF, q, seed=1,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown group 'nope' in "
                                         "'nope:e1'"):
        eng.run()
    q2 = InProcQueues()
    q2.push_reward("g0:zzz", 1.0)
    eng2 = GroupedServingEngine("softMax", ["g0"], ACTIONS, CONF, q2,
                                seed=1, device="cpu")
    with pytest.raises(ValueError, match="not in list"):
        eng2.run()


def test_grouped_engine_over_sharded_queues_equals_jax():
    """16 groups on two in-process brokers (``consistent_route``'s map):
    every event answered once, the ledgers retired, and each shard's
    action queue the JAX engine's over the same fan-out."""
    from avenir_tpu_torch.stream.fleet import consistent_route
    groups = [f"g{i}" for i in range(16)]
    routing = consistent_route(groups, range(2))
    answers = []
    for side in ("jax", "port"):
        with MiniRedisServer() as s0, MiniRedisServer() as s1:
            spec = [f"{s0.host}:{s0.port}", f"{s1.host}:{s1.port}"]
            fleet = (JFleet if side == "jax" else BrokerFleet)(spec)
            for w in range(5):
                for g in groups:
                    fleet.client(routing[g]).lpush(f"eventQueue:{g}",
                                                   f"{g}:e{w}")
            for i, g in enumerate(groups[::3]):
                fleet.client(routing[g]).lpush(f"rewardQueue:{g}",
                                               f"{ACTIONS[i % 3]},{10.0 * i}")
            q = (JSharded if side == "jax" else ShardedQueues)(
                fleet, groups, routing)
            if side == "jax":
                eng = JEngine("exponentialWeight", groups, ACTIONS, CONF, q,
                              seed=9)
            else:
                eng = GroupedServingEngine("exponentialWeight", groups,
                                           ACTIONS, CONF, q, seed=9,
                                           device="cpu")
            stats = eng.run()
            assert stats.events == 80 and stats.rewards == 6
            assert q.pending_left() == 0
            answers.append([fleet.client(s).lrange("actionQueue", 0, -1)
                            for s in (0, 1)])
            q.close()
            fleet.close()
    assert answers[1] == answers[0]
    assert sum(len(a) for a in answers[1]) == 80


# -- the helpers' forms under vmap on non-finite and subnormal inputs ---------

_SPECIAL = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1e-45,
                     -1e-45, 1e-39, -1e-40, 1.17549435e-38, 3.4e38, -3.4e38,
                     1.0, -1.0, 1.5, -3.0, 88.8, -87.8, 89.0, -90.0],
                    dtype=np.float32)


def _same_bits(a, b):
    """Bit-equal, a NaN equal to any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(((a.view(np.int32) == b.view(np.int32))
                 | (np.isnan(a) & np.isnan(b))).all())


def _fma_triples():
    """Every triple of the special values, and products that land on an
    f32 midpoint with an addend that breaks the tie either way or not at
    all."""
    a, b, c = (np.array(t, np.float32) for t in zip(*itertools.product(
        _SPECIAL[:13], _SPECIAL[:13], _SPECIAL[:13])))
    one = np.float32(1.0 + 2.0 ** -12)          # one·one is a midpoint
    ties = [(s * one, one, t) for s in (1.0, -1.0)
            for t in (0.0, 2.0 ** -60, -2.0 ** -60, 2.0 ** -70, -2.0 ** -70)]
    ta, tb, tc = (np.array(t, np.float32) for t in zip(*ties))
    return (np.concatenate([a, ta]), np.concatenate([b, tb]),
            np.concatenate([c, tc]))


@pytest.mark.parametrize("name", ["fma", "xla_log", "xla_exp",
                                  "xla_sigmoid"])
def test_mapped_helpers_equal_the_views_on_special_values(name):
    """Under ``torch.func.vmap`` the helpers build their bits without a
    dtype view; they equal the plain calls, which view bits, on ±inf,
    NaN, ±0, subnormals, the clamps' edges and fma's ties, and the
    elementwise ones give JAX's compiled values there (log on its domain
    and on NaN and +inf)."""
    import jax
    import jax.numpy as jnp
    from avenir_tpu_torch.ops import infotheory as it
    fn = getattr(it, name)
    if name == "fma":
        args = [torch.from_numpy(v) for v in _fma_triples()]
    else:
        args = [torch.from_numpy(_SPECIAL)]
    plain = fn(*args)
    mapped = torch.func.vmap(fn)(*(a.reshape(-1, 1) for a in args))
    assert _same_bits(plain.numpy(), mapped.reshape(-1).numpy())
    if name == "fma":
        # the tie cases against JAX's contracted a * b + c
        want = jax.jit(lambda a, b, c: a * b + c)(
            *(a.numpy()[-10:] for a in args))
        assert _same_bits(plain.numpy()[-10:], want)
        return
    x = _SPECIAL
    keep = np.ones(x.shape, bool)
    if name == "xla_log":     # its domain: positive normal, NaN, +inf
        keep = np.isnan(x) | (x >= np.float32(1.17549435e-38))
    ref = {"xla_log": jnp.log, "xla_exp": jnp.exp,
           "xla_sigmoid": jax.nn.sigmoid}[name]
    want = np.asarray(jax.jit(ref)(x))
    assert _same_bits(plain.numpy()[keep], want[keep])


def test_exponential_weight_folds_after_its_weights_overflow():
    """EXP3 with rewards that overflow its weights to inf, then more
    rewards on the same arms (NaN reaches ``xla_exp``): the plain
    learner's and the grouped learner's state equal JAX's, a NaN equal
    to any NaN, and the grouped actions JAX's."""
    from avenir_tpu.models.bandits import learners as JL
    from avenir_tpu_torch.models.bandits import learners as TL
    rng = np.random.default_rng(3)
    jl = JL.create("exponentialWeight", ACTIONS, CONF, seed=4)
    tl = TL.create("exponentialWeight", ACTIONS, CONF, seed=4, device="cpu")
    jg = JGrouped("exponentialWeight", 4, ACTIONS, CONF, seed=4)
    tg = GroupedLearner("exponentialWeight", 4, ACTIONS, CONF, seed=4,
                        device="cpu")
    overflowed = False
    for step in range(6):
        pairs = [(ACTIONS[int(rng.integers(0, 3))], 1e4 * (1 + step))
                 for _ in range(8)]
        jl.set_reward_batch(pairs)
        tl.set_reward_batch(pairs)
        acts = [ACTIONS[i] for i in rng.integers(0, 3, 4)]
        rew = [1e4 * (1 + step)] * 4
        jg.reward_all(acts, rew)
        tg.reward_all(acts, rew)
        assert tg.next_all() == jg.next_all(), step
        jw = np.asarray(jl.state.weights)
        assert _same_bits(tl.state.weights.numpy(), jw), step
        for name, _ in FIELDS:
            if name != "key":
                assert _same_bits(
                    getattr(tg.states, name).numpy().astype(np.float32),
                    np.asarray(getattr(jg.states, name)).astype(
                        np.float32)), (step, name)
        overflowed |= not np.isfinite(jw).all()
    assert overflowed and np.isnan(tg.states.weights.numpy()).any()
