"""The port's ten streaming learners (``models/bandits/learners.py``)
against the JAX package's, on the CPU: the scalar action sequences, the
fused and masked batch paths at every chunk decomposition, the reward
folds, min-trial forcing, and the state carried across with
``interop.learner_state_from_numpy`` (the batch selections at every
chunk decomposition are in ``test_torch_learner_batches.py``). Action ids
are exactly equal and the state is bit-equal after each horizon. One JAX
``Learner`` a type is shared by the module, so JAX compiles each step
once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.models.bandits import learners as JL

from avenir_tpu_torch.interop import learner_state_from_numpy
from avenir_tpu_torch.models.bandits import learners as TL
from avenir_tpu_torch.ops import infotheory as it

torch.set_num_threads(2)

TYPES = list(JL.ALGORITHMS)
ACTIONS = ["page1", "page2", "page3"]
# small sample and distribution thresholds, so the samplers and the
# interval estimator leave their warm-up within the horizons; logLinear
# softMax decays its temperature into XLA's flushed subnormals
CONFIG = {"random.selection.prob": "0.4", "min.sample.size": "3",
          "min.reward.distr.sample": "2",
          "temp.reduction.algorithm": "logLinear"}
SEED = 5


@pytest.fixture(scope="module")
def jax_learners():
    return {t: JL.create(t, ACTIONS, CONFIG, seed=SEED) for t in TYPES}


def _rewards(rng, n):
    """f32 rewards with fractional parts (the sums' rounding shows)."""
    return [float(np.float32(rng.integers(0, 100) + rng.random()))
            for _ in range(n)]


def _fields(state):
    return {name: np.asarray(getattr(state, name)) for name, _ in TL.FIELDS}


def _assert_state_equal(jstate, tstate):
    """Every field bit-equal (floats by their bits)."""
    got = tstate.to_numpy()
    for name, want in _fields(jstate).items():
        have = got[name]
        if want.dtype.kind == "f":
            assert np.array_equal(have.astype(np.float32).view(np.int32),
                                  want.view(np.int32)), (name, have, want)
        else:
            assert np.array_equal(have.astype(np.int64),
                                  want.astype(np.int64)), (name, have, want)


def _fresh(jl, learner_type, seed=SEED, config=CONFIG):
    """The shared JAX learner reset to a fresh state, and a port learner
    beside it."""
    jl.state = jl.algo.init(jax.random.PRNGKey(seed), len(ACTIONS), jl.cfg)
    return TL.create(learner_type, ACTIONS, config, seed=seed, device="cpu")


def _scalar_steps(jl, tl, rng, n):
    """n scalar next_action / set_reward rounds on both; the actions."""
    got, want = [], []
    for reward in _rewards(rng, n):
        a, b = jl.next_action(), tl.next_action()
        want.append(a)
        got.append(b)
        jl.set_reward(a, reward)
        tl.set_reward(a, reward)
    return got, want


@pytest.mark.parametrize("learner_type", TYPES)
def test_scalar_sequence_equals_jax(jax_learners, learner_type):
    jl = jax_learners[learner_type]
    tl = _fresh(jl, learner_type)
    got, want = _scalar_steps(jl, tl, np.random.default_rng(1), 45)
    assert got == want
    _assert_state_equal(jl.state, tl.state)
    assert tl.get_stat() == jl.get_stat()


@pytest.mark.parametrize("n", [10, 64, 300])
@pytest.mark.parametrize("learner_type", TYPES)
def test_set_reward_batch_equals_jax(jax_learners, learner_type, n):
    """Fused reward folds (a power-of-two chunk, a 256 chunk with a masked
    remainder) and the masked path alone; then a batch of selections
    reads the folded state."""
    jl = jax_learners[learner_type]
    tl = _fresh(jl, learner_type)
    rng = np.random.default_rng(100 + n)
    _scalar_steps(jl, tl, rng, 5)
    pairs = [(ACTIONS[int(rng.integers(0, 3))], r)
             for r in _rewards(rng, n)]
    jl.set_reward_batch(pairs)
    tl.set_reward_batch(pairs)
    _assert_state_equal(jl.state, tl.state)
    assert tl.next_action_batch(65) == jl.next_action_batch(65)


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_exponential_weight_fused_folds_equal_jax_at_the_tutorial_scale(
        jax_learners, chunk):
    """EXP3's fused reward fold at every chunk size ``_fused_split`` can
    give it, on the tutorial's shape: ``LeadGenSimulator`` rewards for
    the drawn actions at the default ``reward.scale`` (100), folded
    ``chunk`` at a time after each ``chunk`` fused selections (64 rewards
    or 4 folds, whichever is more: phase 14's 1,024 at 256), with
    nothing copied back between folds. The weights are bit-equal after
    every fold and the drawn actions equal throughout."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    jl = jax_learners["exponentialWeight"]
    tl = _fresh(jl, "exponentialWeight")
    sim = LeadGenSimulator(sel_count_threshold=1, seed=chunk)
    for _ in range(max(4, 64 // chunk)):
        acts = jl.next_action_batch(chunk)
        assert tl.next_action_batch(chunk) == acts
        pairs = [sim.observe_action(a) for a in acts]
        jl.set_reward_batch(pairs)
        tl.set_reward_batch(pairs)
        _assert_state_equal(jl.state, tl.state)
    assert np.isfinite(tl.state.weights.numpy()).all()


def test_min_trial_forcing_takes_the_scalar_steps():
    """With min.trial the batch path is scalar steps (no fused chunk),
    equal to the JAX package's masked scan and to n next_action calls."""
    config = dict(CONFIG, **{"min.trial": "5",
                             "temp.reduction.algorithm": "linear"})
    jl = JL.create("softMax", ACTIONS, config, seed=7)
    tl = TL.create("softMax", ACTIONS, config, seed=7, device="cpu")
    seq = TL.create("softMax", ACTIONS, config, seed=7, device="cpu")
    got = tl.next_action_batch(70)
    assert got == jl.next_action_batch(70)
    assert got == [seq.next_action() for _ in range(70)]
    assert sorted(got[:15]) == sorted(ACTIONS * 5)   # the forced rounds
    _assert_state_equal(jl.state, tl.state)


def test_learner_state_from_numpy_round_trips():
    jl = JL.create("intervalEstimator", ACTIONS, CONFIG, seed=11)
    for reward in _rewards(np.random.default_rng(0), 9):
        jl.set_reward(jl.next_action(), reward)
    state = learner_state_from_numpy(_fields(jl.state), device="cpu")
    assert state.key.dtype == torch.int64
    assert state.hist.shape == tuple(jl.state.hist.shape)
    _assert_state_equal(jl.state, state)
    again = TL.LearnerState.from_numpy(state.to_numpy(), device="cpu")
    _assert_state_equal(jl.state, again)


def test_factory_names_and_errors():
    assert set(TL.ALGORITHMS) == set(JL.ALGORITHMS)
    with pytest.raises(ValueError, match="invalid learner type"):
        TL.create("nope", ACTIONS, {}, device="cpu")
    tl = TL.create("randomGreedy", ACTIONS, {}, device="cpu")
    with pytest.raises(ValueError, match="is not in list"):
        tl.set_reward_batch([("page1", 1.0), ("zzz", 2.0)])
    assert int(tl.state.reward_count.sum()) == 0   # nothing folded
    cfg = TL.LearnerConfig.from_dict({"batch.size": "3", "max.reward": "9"})
    assert cfg == TL.LearnerConfig(batch_size=3, max_reward=9)
    assert len(TL.create("softMax", ACTIONS, {"batch.size": 3},
                         device="cpu").next_actions()) == 3


@pytest.mark.parametrize("n", [1, 3, 16, 17, 33, 100, 256, 300])
def test_xla_scans_and_products_equal_compiled_jax(n):
    """The cumulative sums and products and the long product the fused
    paths take, against ``jax.jit``'s (XLA's CPU code) bit for bit, with
    subnormal products flushed as XLA flushes them."""
    rng = np.random.default_rng(n)
    x = (rng.random(n) * 2 + 0.25).astype(np.float32)
    small = (rng.random(n) * 0.5).astype(np.float32)
    for fn, ours in ((jnp.cumsum, it.xla_cumsum), (jnp.cumprod,
                                                   it.xla_cumprod),
                     (jnp.prod, it.xla_prod)):
        for v in (x, small):
            want = np.asarray(jax.jit(fn)(v))
            got = ours(torch.from_numpy(v)).numpy()
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
    m = (rng.random((5, n)) * 3).astype(np.float32)
    assert np.array_equal(
        it.xla_cumsum(torch.from_numpy(m), 1).numpy(),
        np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=1))(m)))
