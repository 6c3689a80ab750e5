"""The ten streaming multi-armed-bandit learners, in torch on the card.

Counterpart of ``avenir_tpu/models/bandits/learners.py``: the reference's
``ReinforcementLearner`` hierarchy as functions over a state of tensors,

    state = ALGO.init(key, n_actions, cfg)
    state, action = ALGO.next_action(state, cfg)
    state = ALGO.set_reward(state, action, reward, cfg=cfg)

and ``Learner``, the host wrapper with the reference's API (string action
ids, ``next_action``, ``next_actions``, ``next_action_batch``,
``set_reward``, ``set_reward_batch``, ``get_stat``).

The JAX package compiles each step with ``jax.jit``; this port runs the
same steps as torch ops where the state lives (the card by default), and
rounds every f32 operation as XLA's compiled CPU code does, so the same
seed, actions and rewards give the same action stream and the same state
bits on the CPU and on the card:

- random draws are JAX's threefry bits (``utils/jrandom.py``);
- ``log`` and ``exp`` are XLA's (``ops.infotheory.xla_log``,
  ``xla_exp``), ``sqrt`` goes through float64, cumulative sums and
  products and long products follow XLA's order (``xla_cumsum``,
  ``xla_cumprod``, ``xla_prod``), and short sums add in order;
- XLA's compiled code divides by a constant as a product with its f32
  reciprocal (``_div_const``), flushes subnormal results to zero
  (``ftz``), and in a step compiled alone fuses a product into the add
  that consumes it (``fma``); inside the JAX package's masked scans (a
  ``lax.cond`` a step) it does not, and the reward updates take
  ``masked=True`` there. A division by a tensor divides by a tensor
  on the device, never by a host scalar, which CUDA turns into a product
  with its reciprocal.

Faithfulness notes (as in the JAX package): factory names match
ReinforcementLearnerFactory.java:35-63; min-trial forcing
(ReinforcementLearner.selectActionBasedOnMinTrial :142-152) is honored
where the reference honors it; the reference's inverted ε-greedy branch
is corrected (explore with probability curProb); SoftMax's temperature
decay compounds as written in the reference; IntervalEstimator's upper
bound is the bin value at the (50 + limit/2) percentile of the reward
histogram.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.infotheory import (
    fma, ftz, xla_cumprod, xla_cumsum, xla_exp, xla_log, xla_prod)
from avenir_tpu_torch.utils import jrandom
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

BIG = 1e30


@dataclass(frozen=True)
class LearnerConfig:
    """Config keys straight from the reference (ConfigUtility reads)."""

    batch_size: int = 1                    # batch.size
    min_trial: int = -1                    # min.trial
    reward_scale: int = 100                # reward.scale
    # randomGreedy
    random_selection_prob: float = 0.5     # random.selection.prob
    prob_reduction_algorithm: str = "linear"  # prob.reduction.algorithm
    prob_reduction_constant: float = 1.0   # prob.reduction.constant
    min_prob: float = -1.0                 # min.prob
    # softMax
    temp_constant: float = 100.0           # temp.constant
    min_temp_constant: float = -1.0        # min.temp.constant
    temp_reduction_algorithm: str = "linear"  # temp.reduction.algorithm
    # ucb2
    ucb2_alpha: float = 0.1                # ucb2.alpha
    # actionPursuit
    pursuit_learning_rate: float = 0.05    # pursuit.learning.rate
    # rewardComparison
    preference_change_rate: float = 0.01   # preference.change.rate
    reference_reward_change_rate: float = 0.01  # reference.reward.change.rate
    initial_reference_reward: float = 100.0     # intial.reference.reward (sic)
    # exponentialWeight
    distr_constant: float = 0.1            # distr.constant (EXP3 gamma)
    # sampsonSampler
    min_sample_size: int = 5               # min.sample.size
    max_reward: int = 100                  # max.reward
    reward_buffer_size: int = 256          # per-arm ring-buffer capacity
    # intervalEstimator
    bin_width: int = 10                    # bin.width
    confidence_limit: int = 90             # confidence.limit
    min_confidence_limit: int = 50         # min.confidence.limit
    confidence_limit_reduction_step: int = 5    # confidence.limit.reduction.step
    confidence_limit_reduction_round_interval: int = 50  # ...round.interval
    min_distr_sample: int = 10             # min.reward.distr.sample

    @staticmethod
    def from_dict(conf: Dict[str, Any]) -> "LearnerConfig":
        mapping = {
            "batch.size": "batch_size", "min.trial": "min_trial",
            "reward.scale": "reward_scale",
            "random.selection.prob": "random_selection_prob",
            "prob.reduction.algorithm": "prob_reduction_algorithm",
            "prob.reduction.constant": "prob_reduction_constant",
            "min.prob": "min_prob", "temp.constant": "temp_constant",
            "min.temp.constant": "min_temp_constant",
            "temp.reduction.algorithm": "temp_reduction_algorithm",
            "ucb2.alpha": "ucb2_alpha",
            "pursuit.learning.rate": "pursuit_learning_rate",
            "preference.change.rate": "preference_change_rate",
            "reference.reward.change.rate": "reference_reward_change_rate",
            "intial.reference.reward": "initial_reference_reward",
            "distr.constant": "distr_constant",
            "min.sample.size": "min_sample_size", "max.reward": "max_reward",
            "bin.width": "bin_width", "confidence.limit": "confidence_limit",
            "min.confidence.limit": "min_confidence_limit",
            "confidence.limit.reduction.step":
                "confidence_limit_reduction_step",
            "confidence.limit.reduction.round.interval":
                "confidence_limit_reduction_round_interval",
            "min.reward.distr.sample": "min_distr_sample",
        }
        kwargs = {}
        for key, attr in mapping.items():
            if key in conf:
                default = getattr(LearnerConfig, attr)
                cast = type(default)
                kwargs[attr] = cast(conf[key])
        return LearnerConfig(**kwargs)


#: the state's fields in the JAX ``LearnerState``'s order, with dtypes
FIELDS: Tuple[Tuple[str, torch.dtype], ...] = (
    ("key", torch.int64), ("total_trials", torch.int32),
    ("trial_counts", torch.int32), ("reward_sum", torch.float32),
    ("reward_count", torch.float32), ("probs", torch.float32),
    ("weights", torch.float32), ("scalar_a", torch.float32),
    ("scalar_b", torch.float32), ("scalar_c", torch.float32),
    ("current_action", torch.int32), ("epochs", torch.int32),
    ("buffer", torch.float32), ("buffer_len", torch.int32),
    ("hist", torch.float32))


@dataclass
class LearnerState:
    """Superset state; each algorithm uses the fields it needs. Per-action
    tensors are [A]; ``buffer`` is [A, R], ``hist`` [A, B]; ``key`` is the
    [2] int64 threefry key (``utils/jrandom.py``). Every update returns a
    new state of new tensors: nothing is written in place, so a state a
    checkpoint holds never changes under it."""

    key: torch.Tensor
    total_trials: torch.Tensor
    trial_counts: torch.Tensor
    reward_sum: torch.Tensor
    reward_count: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor
    scalar_a: torch.Tensor
    scalar_b: torch.Tensor
    scalar_c: torch.Tensor
    current_action: torch.Tensor
    epochs: torch.Tensor
    buffer: torch.Tensor
    buffer_len: torch.Tensor
    hist: torch.Tensor

    def replace(self, **changes) -> "LearnerState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.trial_counts.device

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The fields as host numpy arrays (the key as uint32, as JAX
        holds it)."""
        out = {name: getattr(self, name).detach().cpu().numpy()
               for name, _ in FIELDS}
        out["key"] = out["key"].astype(np.uint32)
        return out

    @classmethod
    def from_numpy(cls, fields: Dict[str, Any],
                   device: DeviceLike = "cuda") -> "LearnerState":
        """A state from numpy arrays named as ``FIELDS`` (a JAX
        ``LearnerState``'s leaves, or ``to_numpy``'s output)."""
        dev = resolve_device(device)
        return cls(**{name: torch.as_tensor(
            np.array(fields[name], dtype=np.int64 if name == "key"
                     else None)).to(dev, dtype)
            for name, dtype in FIELDS})


def _f32(x: float) -> float:
    """A Python number as the f32 value JAX's weak typing makes of it."""
    return float(np.float32(x))


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, _f32(value), dtype=torch.float32)


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles it: a product with
    the f32 reciprocal of f32 ``c``."""
    return x * _f32(np.float32(1.0) / np.float32(c))


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """f32 ``c / t`` correctly rounded on every device (torch computes a
    scalar over a tensor as a reciprocal times the scalar)."""
    return _full(t, c) / t


def _blank_state(key: torch.Tensor, n_actions: int, cfg: LearnerConfig,
                 n_bins: int = 1) -> LearnerState:
    dev = key.device
    r = cfg.reward_buffer_size

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return LearnerState(
        key=key,
        total_trials=zeros((), torch.int32),
        trial_counts=zeros(n_actions, torch.int32),
        reward_sum=zeros(n_actions, torch.float32),
        reward_count=zeros(n_actions, torch.float32),
        probs=torch.full((n_actions,), _f32(1.0 / n_actions),
                         dtype=torch.float32, device=dev),
        weights=torch.ones(n_actions, dtype=torch.float32, device=dev),
        scalar_a=zeros((), torch.float32),
        scalar_b=zeros((), torch.float32),
        scalar_c=zeros((), torch.float32),
        current_action=torch.full((), -1, dtype=torch.int32, device=dev),
        epochs=zeros(n_actions, torch.int32),
        buffer=zeros((n_actions, r), torch.float32),
        buffer_len=zeros(n_actions, torch.int32),
        hist=zeros((n_actions, n_bins), torch.float32))


def _arange(state: LearnerState) -> torch.Tensor:
    return torch.arange(state.trial_counts.shape[0], device=state.device)


def _at(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``x[action]`` for a 0-d index tensor, with no host sync."""
    return x.index_select(0, action.reshape(1).long())[0]


def _where_at(x: torch.Tensor, action: torch.Tensor,
              value: torch.Tensor) -> torch.Tensor:
    """``x.at[action].set(value)`` as a new tensor."""
    hit = torch.arange(x.shape[0], device=x.device) == action
    return torch.where(hit, value.to(x.dtype), x)


def _avg_reward(state: LearnerState) -> torch.Tensor:
    return state.reward_sum / torch.clamp(state.reward_count, min=1.0)


def _seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """f32 sum along a short axis, in order from +0 (XLA's order for a
    reduction of up to 32 elements)."""
    x = x.movedim(dim, -1)
    acc = x.new_zeros(x.shape[:-1])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _min_trial_forced(state: LearnerState, cfg: LearnerConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """selectActionBasedOnMinTrial (ReinforcementLearner.java:142-152):
    (forced?, least-tried arm). When forced, the reference short-circuits:
    no algorithm state is touched."""
    least = torch.argmin(state.trial_counts)
    if cfg.min_trial <= 0:
        return torch.zeros((), dtype=torch.bool, device=state.device), least
    return _at(state.trial_counts, least) <= cfg.min_trial, least


def _min_trial_override(state: LearnerState, cfg: LearnerConfig,
                        chosen: torch.Tensor) -> torch.Tensor:
    forced, least = _min_trial_forced(state, cfg)
    return torch.where(forced, least, chosen)


def _select(state: LearnerState, action: torch.Tensor) -> LearnerState:
    hit = (_arange(state) == action).to(torch.int32)
    return state.replace(total_trials=state.total_trials + 1,
                         trial_counts=state.trial_counts + hit)


def _base_reward(state: LearnerState, action, reward,
                 cfg: Optional[LearnerConfig] = None,
                 masked: bool = False) -> LearnerState:
    hit = _arange(state) == action
    return state.replace(
        reward_sum=torch.where(hit, state.reward_sum + reward,
                               state.reward_sum),
        reward_count=torch.where(hit, state.reward_count + 1.0,
                                 state.reward_count))


def _scaled_reward(state: LearnerState, action, reward,
                   cfg: LearnerConfig, contract: bool = True
                   ) -> LearnerState:
    """_base_reward of ``reward / reward.scale``: the product with the
    scale's reciprocal fused into the running sum's add, as XLA compiles
    it alone and in the masked scan; with ``contract`` False the product
    is rounded apart, as XLA compiles the update mapped over two or more
    contexts (a scatter whose update is computed outside it)."""
    inv = _f32(np.float32(1.0) / np.float32(cfg.reward_scale))
    hit = _arange(state) == action
    total = (fma(reward, inv, state.reward_sum) if contract
             else state.reward_sum + reward * inv)
    return state.replace(
        reward_sum=torch.where(hit, total, state.reward_sum),
        reward_count=torch.where(hit, state.reward_count + 1.0,
                                 state.reward_count))


def _t_plus_one(state: LearnerState) -> torch.Tensor:
    return (state.total_trials + 1).float()


# --------------------------------------------------------------------------
# algorithms
# --------------------------------------------------------------------------

def _greedy_prob(t: torch.Tensor, cfg: LearnerConfig) -> torch.Tensor:
    """The decayed exploration probability at trial(s) ``t``
    (RandomGreedyLearner.java)."""
    p0 = cfg.random_selection_prob
    if cfg.prob_reduction_algorithm == "none":
        cur = _full(t, p0)
    elif cfg.prob_reduction_algorithm == "linear":
        cur = _rdiv(p0 * cfg.prob_reduction_constant, t)
    elif cfg.prob_reduction_algorithm == "logLinear":
        cur = (_f32(p0 * cfg.prob_reduction_constant) * xla_log(t)) / t
    else:
        raise ValueError("invalid probability reduction algorithm")
    cur = torch.clamp(cur, max=_f32(p0))
    if cfg.min_prob > 0:
        cur = torch.clamp(cur, min=_f32(cfg.min_prob))
    return cur


class randomGreedy:
    """ε-greedy with linear/logLinear ε decay and a min.prob floor
    (RandomGreedyLearner.java; ε branch corrected)."""

    @staticmethod
    def init(key, n_actions: int, cfg: LearnerConfig) -> LearnerState:
        return _blank_state(key, n_actions, cfg)

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        cur = _greedy_prob(_t_plus_one(state), cfg)
        key, k1, k2 = jrandom.split(state.key, 3)
        explore = jrandom.uniform(k1, ()) < cur
        random_arm = jrandom.randint(k2, (), 0, state.probs.shape[0]).long()
        # the reference floors the average to int before comparing (:92)
        best = torch.argmax(torch.floor(_avg_reward(state)))
        action = torch.where(explore, random_arm, best)
        action = _min_trial_override(state, cfg, action)
        return _select(state.replace(key=key), action), action

    set_reward = staticmethod(_base_reward)


def _ucb1_bonus(t: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    root = torch.sqrt(((2.0 * xla_log(t)) / torch.clamp(n, min=1.0))
                      .double()).float()
    return torch.where(n > 0, root, _full(n, BIG))


class upperConfidenceBoundOne:
    """UCB1: avg + sqrt(2 ln T / n); untried arms first
    (UpperConfidenceBoundOneLearner.java)."""

    @staticmethod
    def init(key, n_actions, cfg):
        return _blank_state(key, n_actions, cfg)

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        n = state.trial_counts.float()
        bonus = _ucb1_bonus(_t_plus_one(state), n)
        action = torch.argmax(_avg_reward(state) + bonus)
        action = _min_trial_override(state, cfg, action)
        return _select(state, action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False, contract: bool = True):
        return _scaled_reward(state, action, reward, cfg, contract)


def _pow_f32(base: float, exponent: torch.Tensor) -> torch.Tensor:
    """f32 ``base ** exponent``, correctly rounded through float64."""
    return torch.pow(torch.full_like(exponent, _f32(base),
                                     dtype=torch.float64),
                     exponent.double()).float()


def _ucb2_new_epoch(avg, counts, total, epochs, cur, alpha: float):
    """A new UCB2 epoch (UpperConfidenceBoundTwoLearner.java): close the
    previous epoch, pick the arm by avg + sqrt((1+α) ln(eT/τ) / 2τ), and
    size its epoch τ(r+1) - τ(r), at least 1. Returns (epochs, action,
    size)."""
    arange = torch.arange(epochs.shape[0], device=epochs.device)
    epochs = torch.where((cur >= 0) & (arange == torch.clamp(cur, min=0)),
                         epochs + 1, epochs)
    t = (total + 1).float()
    ep = epochs.float()
    tao = torch.where(epochs == 0, torch.ones_like(ep),
                      _pow_f32(1.0 + alpha, ep))
    a = (_f32(1 + alpha) * xla_log((_f32(math.e) * t) / tao)) / (2.0 * tao)
    n = counts.float()
    score = torch.where(n > 0, avg + torch.sqrt(a.double()).float(),
                        _full(n, BIG))
    action = torch.argmax(score)
    ep_a = _at(ep, action)
    size = torch.round(_pow_f32(1 + alpha, ep_a + 1)
                       - _pow_f32(1 + alpha, ep_a))
    return epochs, action, torch.clamp(size, min=1.0)


class upperConfidenceBoundTwo:
    """UCB2 epochs: τ(r) = (1+α)^r, bonus sqrt((1+α) ln(eT/τ) / 2τ); the
    chosen arm plays for an epoch (UpperConfidenceBoundTwoLearner.java)."""

    @staticmethod
    def init(key, n_actions, cfg):
        return _blank_state(key, n_actions, cfg)

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        forced, least = _min_trial_forced(state, cfg)
        cont = (state.current_action >= 0) & (state.scalar_c < state.scalar_b)
        epochs, new_action, size = _ucb2_new_epoch(
            _avg_reward(state), state.trial_counts, state.total_trials,
            state.epochs, state.current_action, cfg.ucb2_alpha)
        # the reference short-circuits a forced step: no epoch bookkeeping
        # (:60-62); inside an epoch the arm plays on
        keep = forced | cont
        epoch_action = torch.where(cont, state.current_action.long(),
                                   new_action)
        action = torch.where(forced, least, epoch_action)
        state = state.replace(
            epochs=torch.where(keep, state.epochs, epochs),
            current_action=torch.where(keep, state.current_action,
                                       new_action.to(torch.int32)),
            scalar_b=torch.where(keep, state.scalar_b, size),
            scalar_c=torch.where(
                forced, state.scalar_c,
                torch.where(cont, state.scalar_c + 1.0,
                            torch.ones_like(state.scalar_c))))
        return _select(state, action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False, contract: bool = True):
        return _scaled_reward(state, action, reward, cfg, contract)


def _softmax_decay(scalar_a: torch.Tensor, rnd: torch.Tensor,
                   cfg: LearnerConfig) -> torch.Tensor:
    if cfg.temp_reduction_algorithm == "linear":
        new = torch.where(rnd > 1, ftz(scalar_a / rnd), scalar_a)
    elif cfg.temp_reduction_algorithm == "logLinear":
        new = torch.where(rnd > 1, ftz(ftz(scalar_a * xla_log(rnd)) / rnd),
                          scalar_a)
    else:
        new = scalar_a
    if cfg.min_temp_constant > 0:
        new = torch.clamp(new, min=_f32(cfg.min_temp_constant))
    return new


class softMax:
    """Boltzmann over average rewards with the reference's compounding
    temperature decay and floor (SoftMaxLearner.java)."""

    @staticmethod
    def init(key, n_actions, cfg):
        state = _blank_state(key, n_actions, cfg)
        return state.replace(scalar_a=_full(state.scalar_a,
                                            cfg.temp_constant))

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        temp = torch.clamp(state.scalar_a, min=_f32(1e-6))
        logits = _avg_reward(state) / temp
        key, k1 = jrandom.split(state.key)
        sampled = jrandom.categorical(k1, logits)
        forced, least = _min_trial_forced(state, cfg)
        action = torch.where(forced, least, sampled)
        # the temperature's reduction, as written in the reference; a
        # min-trial-forced step skips it like the reference's short-circuit
        rnd = (state.total_trials + 1 - max(cfg.min_trial, 0)).float()
        new_temp = _softmax_decay(state.scalar_a, rnd, cfg)
        new_temp = torch.where(forced, state.scalar_a, new_temp)
        state = state.replace(key=key, scalar_a=new_temp)
        return _select(state, action), action

    set_reward = staticmethod(_base_reward)


class actionPursuit:
    """Pursuit: winner prob += lr (1-p), losers -= lr p
    (ActionPursuitLearner.java:55-80)."""

    @staticmethod
    def init(key, n_actions, cfg):
        return _blank_state(key, n_actions, cfg)

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        key, k1 = jrandom.split(state.key)
        action = jrandom.choice(k1, state.probs.shape[0], state.probs)
        return _select(state.replace(key=key), action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False):
        state = _base_reward(state, action, reward)
        lr = _f32(cfg.pursuit_learning_rate)
        best = torch.argmax(_avg_reward(state))
        is_best = _arange(state) == best
        p = state.probs
        probs = torch.where(is_best, p + (1.0 - p) * lr, p - p * lr)
        return state.replace(probs=probs / _seq_sum(probs))


class rewardComparison:
    """Preference learning against an adaptive reference reward; softmax
    over preferences (RewardComparisonLearner.java)."""

    @staticmethod
    def init(key, n_actions, cfg):
        state = _blank_state(key, n_actions, cfg)
        return state.replace(
            weights=torch.zeros_like(state.weights),        # actionPrefs
            scalar_a=_full(state.scalar_a, cfg.initial_reference_reward))

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        key, k1 = jrandom.split(state.key)
        action = jrandom.categorical(k1, state.weights)
        return _select(state.replace(key=key), action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False):
        state = _base_reward(state, action, reward)
        diff = _at(_avg_reward(state), action) - state.scalar_a
        w = _at(state.weights, action)
        c_pref = _f32(cfg.preference_change_rate)
        c_ref = _f32(cfg.reference_reward_change_rate)
        if not masked:
            pref = fma(c_pref, diff, w)
            ref = fma(c_ref, diff, state.scalar_a)
        else:
            pref = w + c_pref * diff
            ref = state.scalar_a + c_ref * diff
        return state.replace(weights=_where_at(state.weights, action, pref),
                             scalar_a=ref)


def _exp3_rate(cfg: LearnerConfig, k_arms: int) -> float:
    """γ / K as XLA folds ``γ * x / K``: the f32 product of γ and the
    reciprocal of K, one factor of x."""
    return _f32(np.float32(cfg.distr_constant)
                * (np.float32(1.0) / np.float32(k_arms)))


def _exp3_probs(state: LearnerState, cfg: LearnerConfig) -> torch.Tensor:
    gamma = cfg.distr_constant
    k_arms = state.probs.shape[0]
    return (_f32(1.0 - gamma) * state.weights) / _seq_sum(state.weights) \
        + _f32(gamma / k_arms)


class exponentialWeight:
    """EXP3 (ExponentialWeightLearner.java): p = (1-γ) w/Σw + γ/K;
    w *= exp(γ (r/p)/K)."""

    @staticmethod
    def init(key, n_actions, cfg):
        return _blank_state(key, n_actions, cfg)

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        probs = _exp3_probs(state, cfg)
        key, k1 = jrandom.split(state.key)
        action = jrandom.choice(k1, probs.shape[0], probs)
        state = state.replace(key=key, probs=probs)
        return _select(state, action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False):
        state = _base_reward(state, action, reward)
        k_arms = state.probs.shape[0]
        scaled = _div_const(reward, cfg.reward_scale)
        ratio = scaled / torch.clamp(_at(state.probs, action),
                                     min=_f32(1e-9))
        w = _at(state.weights, action) * xla_exp(
            ratio * _exp3_rate(cfg, k_arms))
        return state.replace(weights=_where_at(state.weights, action, w))


class sampsonSampler:
    """Thompson sampling by resampling observed rewards from a per-arm ring
    buffer (SampsonSamplerLearner.java); under min.sample.size an arm
    draws uniform in [0, max.reward)."""

    enforce_mean_floor = False

    @classmethod
    def init(cls, key, n_actions, cfg):
        return _blank_state(key, n_actions, cfg)

    @classmethod
    def _scores(cls, state: LearnerState, cfg: LearnerConfig, k1, k2,
                r: Optional[int]) -> torch.Tensor:
        """[A] scores (``r`` None) or [A, r]: a reward resampled from each
        arm's ring-buffer window, or a uniform under min.sample.size."""
        n_actions, cap = state.buffer.shape
        hi = torch.clamp(torch.clamp(state.buffer_len, max=cap), min=1)
        shape = (n_actions,) if r is None else (n_actions, r)
        idx = jrandom.randint(k1, shape, 0,
                              hi if r is None else hi[:, None])
        if r is None:
            sampled = state.buffer.gather(1, idx.long()[:, None])[:, 0]
        else:
            sampled = state.buffer.gather(1, idx.long())
        if cls.enforce_mean_floor:
            avg = _avg_reward(state)
            sampled = torch.maximum(sampled,
                                    avg if r is None else avg[:, None])
        uniform = jrandom.uniform(k2, shape).to(state.device) \
            * _f32(cfg.max_reward)
        ok = state.buffer_len > cfg.min_sample_size
        return torch.where(ok if r is None else ok[:, None], sampled,
                           uniform)

    @classmethod
    def next_action(cls, state: LearnerState, cfg: LearnerConfig):
        key, k1, k2 = jrandom.split(state.key, 3)
        action = torch.argmax(cls._scores(state, cfg, k1, k2, None))
        return _select(state.replace(key=key), action), action

    @classmethod
    def set_reward(cls, state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False):
        state = _base_reward(state, action, reward)
        n_actions, cap = state.buffer.shape
        slot = torch.remainder(_at(state.buffer_len, action), cap)
        hit = ((_arange(state) == action)[:, None]
               & (torch.arange(cap, device=state.device) == slot)[None, :])
        reward = torch.as_tensor(reward, dtype=torch.float32,
                                 device=state.device)
        return state.replace(
            buffer=torch.where(hit, reward, state.buffer),
            buffer_len=state.buffer_len
            + (_arange(state) == action).to(torch.int32))


class optimisticSampsonSampler(sampsonSampler):
    """Thompson with rewards floored at the arm's mean
    (OptimisticSampsonSamplerLearner.java:30-54)."""

    enforce_mean_floor = True


def _interval_schedule(limit, last, t, cfg: LearnerConfig):
    """One step of the confidence limit's decay: (limit, last round)."""
    red = torch.floor(_div_const(
        t - last, cfg.confidence_limit_reduction_round_interval))
    new_limit = torch.where(
        red > 0,
        torch.clamp(fma(-red, _f32(cfg.confidence_limit_reduction_step),
                        limit), min=_f32(cfg.min_confidence_limit)),
        limit)
    return new_limit, torch.where(red > 0, t, last)


def _interval_upper(state: LearnerState, counts: torch.Tensor,
                    limits: torch.Tensor, cfg: LearnerConfig
                    ) -> torch.Tensor:
    """Each arm's upper confidence bound at each of ``limits`` ([r]):
    the bin value at the (50 + limit/2) percentile of its reward
    histogram -> [A, r] (int64)."""
    target = _div_const(fma(limits, 0.5, 50.0), 100.0)           # [r]
    cum = xla_cumsum(state.hist, 1) / torch.clamp(counts[:, None], min=1.0)
    first_bin = torch.argmax(
        (cum[:, :, None] >= target[None, None, :]).to(torch.int8), dim=1)
    return (first_bin + 1) * cfg.bin_width


class intervalEstimator:
    """Histogram upper-confidence-bound with a shrinking confidence limit
    (IntervalEstimatorLearner.java:80-154): random until every arm has
    min.reward.distr.sample samples, then the arm whose histogram upper
    bound at the current limit is highest; the limit decays by step every
    interval rounds down to the minimum."""

    @staticmethod
    def init(key, n_actions, cfg):
        n_bins = max(cfg.max_reward // max(cfg.bin_width, 1) + 1, 1)
        state = _blank_state(key, n_actions, cfg, n_bins=n_bins)
        return state.replace(
            scalar_b=_full(state.scalar_b, cfg.confidence_limit),
            scalar_c=torch.ones_like(state.scalar_c))   # lastRoundNum

    @staticmethod
    def next_action(state: LearnerState, cfg: LearnerConfig):
        key, k1 = jrandom.split(state.key)
        n_actions = state.hist.shape[0]
        counts = _seq_sum(state.hist, 1)
        low_sample = (counts < cfg.min_distr_sample).any()
        new_limit, new_last = _interval_schedule(
            state.scalar_b, state.scalar_c, _t_plus_one(state), cfg)
        upper = _interval_upper(state, counts, new_limit.reshape(1),
                                cfg)[:, 0]
        ie_action = torch.argmax(torch.where(counts > 0, upper,
                                             torch.full_like(upper, -1)))
        random_action = jrandom.randint(k1, (), 0, n_actions).long()
        action = torch.where(low_sample, random_action.to(state.device),
                             ie_action)
        state = state.replace(
            key=key,
            scalar_b=torch.where(low_sample, state.scalar_b, new_limit),
            scalar_c=torch.where(low_sample, state.scalar_c, new_last))
        return _select(state, action), action

    @staticmethod
    def set_reward(state, action, reward,
                   cfg: LearnerConfig = LearnerConfig(),
                   masked: bool = False):
        state = _base_reward(state, action, reward)
        n_bins = state.hist.shape[1]
        reward = torch.as_tensor(reward, dtype=torch.float32,
                                 device=state.device)
        bin_id = torch.clamp(torch.floor(
            reward / _full(reward, cfg.bin_width)).to(torch.int32),
            0, n_bins - 1)
        hit = ((_arange(state) == action)[:, None]
               & (torch.arange(n_bins, device=state.device)
                  == bin_id)[None, :])
        return state.replace(hist=state.hist + hit.to(torch.float32))


# --------------------------------------------------------------------------
# micro-batch stepping: the bolt's reward-drain pattern
# (ReinforcementLearnerBolt.java:96-99 drains queued rewards, then
# nextActions() emits a batch, ReinforcementLearner.java:86-91). The JAX
# package runs R selections or R reward folds in one compiled dispatch;
# the fast paths below are its ``select_many`` / ``reward_many``, op for
# op, so a chunk's draws and state equal the JAX package's chunk.
# --------------------------------------------------------------------------

def _sample_cdf(key: torch.Tensor, probs_ar: torch.Tensor, r: int
                ) -> torch.Tensor:
    """[A] or [A, r] probability columns -> [r] draws by inverse CDF: one
    uniform per draw against the column's cumulative sums."""
    if probs_ar.dim() == 1:
        probs_ar = probs_ar[:, None]
    cum = xla_cumsum(probs_ar, 0)                        # [A, r or 1]
    u = jrandom.uniform(key, (1, r)).to(cum.device) * cum[-1:, :]
    return torch.clamp((cum < u).sum(dim=0), max=probs_ar.shape[0] - 1)


def _one_hot_ar(actions: torch.Tensor, n: int) -> torch.Tensor:
    """[R] action ids -> [n, R] f32 one-hot."""
    return (actions[None, :] == torch.arange(
        n, device=actions.device)[:, None]).to(torch.float32)


#: the lanes of XLA's tiled CPU matrix-vector product (256-bit vectors)
_GEMV_LANES = 8


def _row_dot(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[A, R] @ [R] as XLA's tiled CPU matrix-vector product sums a row
    (read off its LLVM IR): the products of each 8 columns into 8 lanes
    from +0, the lanes halved pairwise, and the columns past the last
    whole 8 summed in order from +0 and added after."""
    prod = oh * x[None, :]
    r = prod.shape[1]
    main = r - r % _GEMV_LANES
    acc = torch.zeros_like(prod[:, :_GEMV_LANES])
    for j in range(0, main, _GEMV_LANES):
        acc = acc + prod[:, j:j + _GEMV_LANES]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0] + _seq_sum(prod[:, main:], 1)


def _fused_dot(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[A, R] @ [R] as XLA's CPU code sums a row where the one-hot is
    fused into the product (a loop fusion, not the tiled GEMV; read off
    its machine code): up to 32 columns in order from +0; from 64, one
    8-lane vector over the 8-column blocks B, in the order the vectorizer
    (4 interleaved accumulators, block 4i + k in accumulator k) leaves
    after the backend chains them: B0, B4, ..., then for k = 1, 2, 3
    B(4 + k), Bk, B(8 + k), B(12 + k), ...; the lanes halved pairwise."""
    prod = oh * x[None, :]
    r = prod.shape[1]
    if r <= 32:
        return _seq_sum(prod, 1)
    blocks = r // _GEMV_LANES
    order = list(range(4, blocks, 4))
    for k in (1, 2, 3):
        order += [4 + k, k] + list(range(8 + k, blocks, 4))
    acc = prod[:, :_GEMV_LANES] + 0.0
    for b in order:
        acc = acc + prod[:, b * _GEMV_LANES:(b + 1) * _GEMV_LANES]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0]


def _reward_many_additive(state: LearnerState, actions, rewards,
                          scale: float = 1.0) -> LearnerState:
    """Aggregated _base_reward: a per-arm segment sum of the chunk's
    rewards added to the running sums."""
    n = state.reward_sum.shape[0]
    oh = _one_hot_ar(actions, n)                         # [A, R]
    x = rewards if scale == 1.0 else _div_const(rewards, scale)
    return state.replace(reward_sum=state.reward_sum + _row_dot(oh, x),
                         reward_count=state.reward_count + _seq_sum(oh, 1))


def _counts_after(state: LearnerState, actions) -> LearnerState:
    n = state.trial_counts.shape[0]
    cnt = _one_hot_ar(actions, n).sum(dim=1).to(torch.int32)
    return state.replace(total_trials=state.total_trials + actions.shape[0],
                         trial_counts=state.trial_counts + cnt)


def _softmax_cols(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(logits, axis=0)`` for [A, R] columns."""
    e = xla_exp(logits - logits.max(dim=0, keepdim=True).values)
    return e / _seq_sum(e, 0)[None, :]


def _softmax_select_many(state: LearnerState, cfg: LearnerConfig, r: int):
    """R Boltzmann draws with the temperature schedule advanced in closed
    form: draw i uses temp_i, temp_{i+1} = decay(temp_i, rnd_i) as the
    scalar step (min-trial forcing is off on this path; average rewards
    cannot change mid-batch because rewards arrive between batches)."""
    dev = state.device
    t0 = state.total_trials.float()
    rnd = t0 + 1.0 + torch.arange(r, dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    if cfg.temp_reduction_algorithm == "linear":
        factor = torch.where(rnd > 1, rnd, torch.ones_like(rnd))
        temps = ftz(state.scalar_a
                    / torch.cat([one, xla_cumprod(factor)[:-1]]))
        final = ftz(state.scalar_a / xla_prod(factor))
    elif cfg.temp_reduction_algorithm == "logLinear":
        g = torch.where(rnd > 1, xla_log(torch.clamp(rnd, min=2.0)) / rnd,
                        torch.ones_like(rnd))
        temps = ftz(state.scalar_a * torch.cat([one, xla_cumprod(g)[:-1]]))
        final = ftz(state.scalar_a * xla_prod(g))
    else:
        temps = state.scalar_a.expand(r)
        final = state.scalar_a
    if cfg.min_temp_constant > 0:
        # the decay never increases, so clamping the closed form equals
        # clamping every step, but for draw 0, which the scalar step takes
        # from scalar_a unclamped
        floor = _f32(cfg.min_temp_constant)
        temps = torch.cat([temps[:1], torch.clamp(temps[1:], min=floor)])
        final = torch.clamp(final, min=floor)
    temps = torch.clamp(temps, min=_f32(1e-6))
    logits = _avg_reward(state)[:, None] / temps[None, :]       # [A, R]
    key, k1 = jrandom.split(state.key)
    actions = _sample_cdf(k1, _softmax_cols(logits), r)
    state = state.replace(key=key, scalar_a=final)
    return _counts_after(state, actions), actions


def _random_greedy_select_many(state: LearnerState, cfg: LearnerConfig,
                               r: int):
    t = _t_plus_one(state) + torch.arange(r, dtype=torch.float32,
                                          device=state.device)
    cur = _greedy_prob(t, cfg)
    key, k1, k2 = jrandom.split(state.key, 3)
    explore = jrandom.uniform(k1, (r,)).to(state.device) < cur
    random_arms = jrandom.randint(k2, (r,), 0, state.probs.shape[0]).long()
    best = torch.argmax(torch.floor(_avg_reward(state)))
    actions = torch.where(explore, random_arms.to(state.device), best)
    return _counts_after(state.replace(key=key), actions), actions


def _pursuit_select_many(state: LearnerState, cfg: LearnerConfig, r: int):
    key, k1 = jrandom.split(state.key)
    actions = _sample_cdf(k1, state.probs, r)
    return _counts_after(state.replace(key=key), actions), actions


def _reward_comparison_select_many(state: LearnerState, cfg: LearnerConfig,
                                   r: int):
    key, k1 = jrandom.split(state.key)
    actions = _sample_cdf(k1, _softmax_cols(state.weights[:, None])[:, 0],
                          r)
    return _counts_after(state.replace(key=key), actions), actions


def _exp_weight_select_many(state: LearnerState, cfg: LearnerConfig, r: int):
    probs = _exp3_probs(state, cfg)
    key, k1 = jrandom.split(state.key)
    actions = _sample_cdf(k1, probs, r)
    state = state.replace(key=key, probs=probs)
    return _counts_after(state, actions), actions


def _exp_weight_reward_many(state: LearnerState, actions, rewards,
                            cfg: LearnerConfig):
    """EXP3 weight updates are multiplicative with p frozen at the stored
    selection distribution, so the exponents add: one segment sum."""
    state = _reward_many_additive(state, actions, rewards)
    k_arms = state.probs.shape[0]
    scaled = _div_const(rewards, cfg.reward_scale)
    p = torch.clamp(state.probs.index_select(0, actions.long()),
                    min=_f32(1e-9))
    exponent = _fused_dot(_one_hot_ar(actions, k_arms), scaled / p)
    return state.replace(weights=state.weights * xla_exp(
        exponent * _exp3_rate(cfg, k_arms)))


def _ucb1_select_many(state: LearnerState, cfg: LearnerConfig, r: int):
    """UCB1 is deterministic given frozen average rewards: r scalar steps
    over (trial counts, total) alone."""
    avg = _avg_reward(state)
    counts, total = state.trial_counts, state.total_trials
    arange = _arange(state)
    actions = []
    for _ in range(r):
        bonus = _ucb1_bonus((total + 1).float(), counts.float())
        a = torch.argmax(avg + bonus)
        counts = counts + (arange == a).to(torch.int32)
        total = total + 1
        actions.append(a)
    return (state.replace(trial_counts=counts, total_trials=total),
            torch.stack(actions))


def _ucb2_select_many(state: LearnerState, cfg: LearnerConfig, r: int):
    """UCB2's epoch bookkeeping, r scalar steps over the count and epoch
    fields (average rewards frozen within the batch)."""
    avg = _avg_reward(state)
    counts, total = state.trial_counts, state.total_trials
    epochs, cur = state.epochs, state.current_action
    size_b, cnt_c = state.scalar_b, state.scalar_c
    arange = _arange(state)
    actions = []
    for _ in range(r):
        cont = (cur >= 0) & (cnt_c < size_b)
        new_epochs, new_action, size = _ucb2_new_epoch(
            avg, counts, total, epochs, cur, cfg.ucb2_alpha)
        action = torch.where(cont, cur.long(), new_action)
        epochs = torch.where(cont, epochs, new_epochs)
        cur = torch.where(cont, cur, new_action.to(torch.int32))
        size_b = torch.where(cont, size_b, size)
        cnt_c = torch.where(cont, cnt_c + 1.0, torch.ones_like(cnt_c))
        counts = counts + (arange == action).to(torch.int32)
        total = total + 1
        actions.append(action)
    return state.replace(trial_counts=counts, total_trials=total,
                         epochs=epochs, current_action=cur,
                         scalar_b=size_b, scalar_c=cnt_c), \
        torch.stack(actions)


def _interval_estimator_select_many(state: LearnerState, cfg: LearnerConfig,
                                    r: int):
    """The histogram (and so the low-sample flag and each arm's CDF) is
    frozen within a batch; the confidence-limit schedule steps r times,
    then every draw's percentile lookup reads the frozen CDF at once."""
    n_actions = state.hist.shape[0]
    counts = _seq_sum(state.hist, 1)
    low_sample = (counts < cfg.min_distr_sample).any()
    limit, last = state.scalar_b, state.scalar_c
    limits = []
    t = state.total_trials.float()
    for i in range(r):
        t = t + 1.0
        limit, last = _interval_schedule(limit, last, t, cfg)
        limits.append(limit)
    upper = _interval_upper(state, counts, torch.stack(limits), cfg)
    det_actions = torch.argmax(torch.where(
        counts[:, None] > 0, upper, torch.full_like(upper, -1)), dim=0)
    key, k1 = jrandom.split(state.key)
    rand_actions = jrandom.randint(k1, (r,), 0, n_actions).long()
    actions = torch.where(low_sample, rand_actions.to(state.device),
                          det_actions)
    state = state.replace(
        key=key,
        scalar_b=torch.where(low_sample, state.scalar_b, limit),
        scalar_c=torch.where(low_sample, state.scalar_c, last))
    return _counts_after(state, actions), actions


def _interval_estimator_reward_many(state: LearnerState, actions, rewards,
                                    cfg: LearnerConfig):
    """Histogram adds commute: one (action, bin) count added at once."""
    state = _reward_many_additive(state, actions, rewards)
    n_actions, n_bins = state.hist.shape
    bin_id = torch.clamp(torch.floor(
        rewards / _full(rewards, cfg.bin_width)).to(torch.int64),
        0, n_bins - 1)
    flat = actions.long() * n_bins + bin_id
    counts = _one_hot_ar(flat, n_actions * n_bins).sum(dim=1)
    return state.replace(hist=state.hist + counts.reshape(n_actions,
                                                          n_bins))


def _sampson_select_many(cls, state: LearnerState, cfg: LearnerConfig,
                         r: int):
    """Thompson draws are independent given the frozen ring buffers: one
    [A, r] resample and an argmax over arms."""
    key, k1, k2 = jrandom.split(state.key, 3)
    actions = torch.argmax(cls._scores(state, cfg, k1, k2, r), dim=0)
    return _counts_after(state.replace(key=key), actions), actions


def _additive(scale_from_cfg: bool):
    def reward_many(state, actions, rewards, cfg):
        return _reward_many_additive(
            state, actions, rewards,
            scale=cfg.reward_scale if scale_from_cfg else 1.0)
    return staticmethod(reward_many)


softMax.select_many = staticmethod(_softmax_select_many)
softMax.reward_many = _additive(False)
randomGreedy.select_many = staticmethod(_random_greedy_select_many)
randomGreedy.reward_many = _additive(False)
upperConfidenceBoundOne.select_many = staticmethod(_ucb1_select_many)
upperConfidenceBoundOne.reward_many = _additive(True)
upperConfidenceBoundTwo.select_many = staticmethod(_ucb2_select_many)
upperConfidenceBoundTwo.reward_many = _additive(True)
actionPursuit.select_many = staticmethod(_pursuit_select_many)
rewardComparison.select_many = staticmethod(_reward_comparison_select_many)
exponentialWeight.select_many = staticmethod(_exp_weight_select_many)
exponentialWeight.reward_many = staticmethod(_exp_weight_reward_many)
intervalEstimator.select_many = staticmethod(_interval_estimator_select_many)
intervalEstimator.reward_many = staticmethod(_interval_estimator_reward_many)
sampsonSampler.select_many = classmethod(_sampson_select_many)


def next_actions_fused(algo, state: LearnerState, cfg: LearnerConfig,
                       r: int):
    """R selections -> (state, actions [r] int64): the algorithm's
    ``select_many`` where it has one and min-trial forcing is off, else r
    scalar steps."""
    fast = getattr(algo, "select_many", None)
    if fast is not None and cfg.min_trial <= 0:
        return fast(state, cfg, r)
    actions = []
    for _ in range(r):
        state, a = algo.next_action(state, cfg)
        actions.append(a)
    return state, torch.stack(actions)


def set_rewards_fused(algo, state: LearnerState, actions, rewards,
                      cfg: LearnerConfig):
    """Apply [r] (action, reward) pairs: aggregated where the update
    commutes, one by one otherwise."""
    fast = getattr(algo, "reward_many", None)
    if fast is not None:
        return fast(state, actions, rewards, cfg)
    for i in range(actions.shape[0]):
        state = algo.set_reward(state, actions[i], rewards[i], cfg=cfg,
                                masked=True)
    return state


def build_action_index(actions) -> Dict[str, int]:
    """Action id -> index, built once per learner."""
    return {a: i for i, a in enumerate(actions)}


def resolve_action_id(index: Dict[str, int], action_id: str) -> int:
    """O(1) id->index lookup with list.index's ValueError contract."""
    idx = index.get(action_id)
    if idx is None:
        raise ValueError(f"{action_id!r} is not in list")
    return idx


ALGORITHMS = {
    "intervalEstimator": intervalEstimator,
    "sampsonSampler": sampsonSampler,
    "optimisticSampsonSampler": optimisticSampsonSampler,
    "randomGreedy": randomGreedy,
    "upperConfidenceBoundOne": upperConfidenceBoundOne,
    "upperConfidenceBoundTwo": upperConfidenceBoundTwo,
    "softMax": softMax,
    "actionPursuit": actionPursuit,
    "rewardComparison": rewardComparison,
    "exponentialWeight": exponentialWeight,
}


class Learner:
    """Host wrapper with the reference's API (string action ids,
    nextActions batch, setReward) around the state on ``device`` — the
    drop-in for ReinforcementLearnerFactory.create."""

    #: the JAX package's masked-scan bucket and fused-chunk caps; the port
    #: keeps its chunk decomposition (``_fused_split``), on which the
    #: action stream of a stochastic learner depends (one key split a
    #: chunk)
    _SCAN_BUCKET_MAX = 64
    _FUSED_CHUNK_MAX = 256

    def __init__(self, learner_type: str, actions, config: Dict[str, Any],
                 seed: int = 0, device: DeviceLike = "cuda"):
        if learner_type not in ALGORITHMS:
            raise ValueError(f"invalid learner type:{learner_type}")
        self.learner_type = learner_type
        self.algo = ALGORITHMS[learner_type]
        self.actions = list(actions)
        self._action_index = build_action_index(self.actions)
        self.cfg = (config if isinstance(config, LearnerConfig)
                    else LearnerConfig.from_dict(config))
        self.device = resolve_device(device)
        self.state = self.algo.init(jrandom.prng_key(seed, self.device),
                                    len(self.actions), self.cfg)

    @staticmethod
    def _fused_split(n: int, cap: int):
        """(full-cap fused chunk count, fused remainder, masked remainder):
        full cap-size chunks go fused, a power-of-two remainder too, any
        other remainder takes the scalar steps (the JAX package's
        decomposition)."""
        full, rem = divmod(n, cap)
        if rem and (rem & (rem - 1)) == 0:
            return full, rem, 0
        return full, 0, rem

    def next_action(self) -> str:
        self.state, action = self.algo.next_action(self.state, self.cfg)
        return self.actions[int(action)]

    def next_actions(self) -> List[str]:
        """The nextActions() batch contract (ReinforcementLearner.java:
        86-91): ``batch.size`` scalar draws, deliberately not the fused
        batch (the serving loop's ``step`` depends on this path's
        realization stream, as in the JAX package)."""
        return [self.next_action() for _ in range(self.cfg.batch_size)]

    def next_action_batch_async(self, n: int) -> List[Tuple[torch.Tensor,
                                                            int]]:
        """Queue n decisions and return their actions as tensors where the
        state lives, with no host read anywhere on this path: on the card
        it never waits for the card. The serving engine
        (``stream/engine.py``) queues batch n+1's decisions through this,
        then writes batch n's actions while the card computes;
        :meth:`resolve_action_batch` reads them. The state evolves as in
        :meth:`next_action_batch`, which is this and an immediate
        resolve: fused chunks (``next_actions_fused``) where the
        algorithm has a fast path and min-trial forcing is off, the rest
        as scalar steps. Returns ``[(actions, take), ...]``, one entry a
        fused chunk and one for the scalar steps; the first ``take``
        actions of each are the decisions."""
        handles = []
        if (getattr(self.algo, "select_many", None) is not None
                and self.cfg.min_trial <= 0):
            full, fused_rem, n = self._fused_split(n, self._FUSED_CHUNK_MAX)
            for r in [self._FUSED_CHUNK_MAX] * full + (
                    [fused_rem] if fused_rem else []):
                self.state, actions = next_actions_fused(
                    self.algo, self.state, self.cfg, r)
                handles.append((actions.long(), r))
        steps = []
        for _ in range(n):
            self.state, action = self.algo.next_action(self.state, self.cfg)
            steps.append(action.reshape(1).long())
        if steps:
            handles.append((torch.cat(steps), n))
        return handles

    def resolve_action_batch(self, handles) -> List[str]:
        """The blocking half of the pair: one host read of every chunk's
        actions, mapped to action ids."""
        if not handles:
            return []
        ids = torch.cat([actions[:take] for actions, take in handles])
        return [self.actions[a] for a in ids.tolist()]

    def next_action_batch(self, n: int) -> List[str]:
        """n decisions, one host read for the whole batch."""
        return self.resolve_action_batch(self.next_action_batch_async(n))

    def set_reward_batch(self, pairs) -> None:
        """Fold (action_id, reward) pairs: in fused chunks where the
        algorithm's update commutes, one by one otherwise. All pairs are
        resolved before any state changes, so a bad action id raises with
        the state untouched."""
        resolved = [(self._resolve_action(a), float(r)) for a, r in pairs]
        if not resolved:
            return
        idx = torch.tensor([c[0] for c in resolved], dtype=torch.int64,
                           device=self.device)
        rew = torch.tensor([c[1] for c in resolved], dtype=torch.float32,
                           device=self.device)
        pos = 0
        if getattr(self.algo, "reward_many", None) is not None:
            full, fused_rem, _ = self._fused_split(len(resolved),
                                                   self._FUSED_CHUNK_MAX)
            for r in [self._FUSED_CHUNK_MAX] * full + (
                    [fused_rem] if fused_rem else []):
                self.state = set_rewards_fused(
                    self.algo, self.state, idx[pos:pos + r],
                    rew[pos:pos + r], self.cfg)
                pos += r
        for i in range(pos, len(resolved)):
            self.state = self.algo.set_reward(self.state, idx[i], rew[i],
                                              cfg=self.cfg, masked=True)

    def _resolve_action(self, action_id: str) -> int:
        return resolve_action_id(self._action_index, action_id)

    def set_reward(self, action_id: str, reward: float) -> None:
        idx = self._resolve_action(action_id)
        self.state = self.algo.set_reward(
            self.state, torch.tensor(idx, device=self.device),
            torch.tensor(float(reward), dtype=torch.float32,
                         device=self.device), cfg=self.cfg)

    def get_stat(self) -> str:
        counts = ",".join(str(c) for c in self.state.trial_counts.tolist())
        return f"trialCounts:{counts}"


def create(learner_type: str, actions, config: Dict[str, Any],
           seed: int = 0, device: DeviceLike = "cuda") -> Learner:
    """ReinforcementLearnerFactory.create equivalent (same type names)."""
    return Learner(learner_type, actions, config, seed, device=device)
