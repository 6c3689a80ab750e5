"""``Learner.next_action_batch`` of the port's ten streaming learners
against the JAX package's at every chunk decomposition of
``_fused_split`` (fused 256 chunks, a power-of-two remainder, the scalar
remainder), from a mid-run state carried across with
``interop.learner_state_from_numpy``: action ids exactly equal, the state
bit-equal. One JAX ``Learner`` a type is shared by the module."""

import numpy as np
import pytest
import torch

from test_torch_learners import (  # noqa: F401 (the module's fixture)
    ACTIONS, CONFIG, TYPES, _assert_state_equal, _fields, _fresh, _rewards,
    jax_learners)

from avenir_tpu_torch.interop import learner_state_from_numpy
from avenir_tpu_torch.models.bandits import learners as TL

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 256, 300, 513])
@pytest.mark.parametrize("learner_type", TYPES)
def test_next_action_batch_equals_jax(jax_learners, learner_type, n):
    """From a mid-run state carried across from the JAX package: the fused
    chunks (256, a power-of-two remainder) and the scalar remainder, as
    ``_fused_split`` decomposes n."""
    jl = jax_learners[learner_type]
    _fresh(jl, learner_type)
    rng = np.random.default_rng(n)
    for reward in _rewards(rng, 12):
        jl.set_reward(jl.next_action(), reward)
    tl = TL.create(learner_type, ACTIONS, CONFIG, device="cpu")
    tl.state = learner_state_from_numpy(_fields(jl.state), device="cpu")
    assert tl.next_action_batch(n) == jl.next_action_batch(n)
    _assert_state_equal(jl.state, tl.state)
