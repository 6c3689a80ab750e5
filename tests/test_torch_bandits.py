"""The port's batch bandits against the JAX package's: every selector under
each of its configurations, ``select_all_groups`` with per-group batch
sizes, and the price-optimization tutorial's loop. The module is numpy
in both packages, so every comparison is exact: the same seed and round
give the same selections."""

import numpy as np
import pytest

from avenir_tpu.datagen.generators import price_opt_arms as jarms
from avenir_tpu.models import bandits as JB

from avenir_tpu_torch.datagen import price_opt_arms as tarms
from avenir_tpu_torch.models import bandits as TB


def _groups(pkg, n_groups=12, seed=3):
    """Groups of 3-9 arms with untried arms (count 0), reward ties and
    all-zero groups."""
    rng = np.random.default_rng(seed)
    out = {}
    for g in range(n_groups):
        k = int(rng.integers(3, 10))
        counts = rng.integers(0, 6, k)
        if g % 4 == 0:
            counts[:] = 0
        rewards = np.where(counts > 0, rng.integers(1, 4, k) * 10, 0)
        out[f"G{g:02d}"] = pkg.GroupItems(
            items=[f"i{j}" for j in range(k)], counts=counts.copy(),
            rewards=rewards.copy())
    return out


CONFIGS = [
    ("GreedyRandomBandit", dict(prob_reduction_algorithm="linear")),
    ("GreedyRandomBandit", dict(prob_reduction_algorithm="logLinear",
                                random_selection_prob=0.9)),
    ("GreedyRandomBandit", dict(prob_reduction_algorithm="AuerGreedy",
                                auer_greedy_constant=2)),
    ("AuerDeterministic", {}),
    ("SoftMaxBandit", dict(temp_constant=0.1)),
    ("SoftMaxBandit", dict(temp_constant=2.0)),
    ("RandomFirstGreedyBandit", dict(exploration_count_factor=2)),
    ("RandomFirstGreedyBandit", dict(exploration_count_strategy="pac",
                                     reward_diff=0.5, prob_diff=0.2)),
]


@pytest.mark.parametrize("round_num,batch_size", [(1, 1), (2, 3), (7, 2),
                                                  (40, 4)])
@pytest.mark.parametrize("algorithm,kwargs", CONFIGS)
def test_selectors_equal_jax(algorithm, kwargs, round_num, batch_size):
    jg, tg = _groups(JB), _groups(TB)
    jcfg = JB.BanditConfig(round_num=round_num, batch_size=batch_size,
                           **kwargs)
    tcfg = TB.BanditConfig(round_num=round_num, batch_size=batch_size,
                           **kwargs)
    for gid in sorted(jg):
        jrng = np.random.default_rng(round_num)
        trng = np.random.default_rng(round_num)
        want = JB.SELECTORS[algorithm](jg[gid], jcfg, jrng)
        got = TB.SELECTORS[algorithm](tg[gid], tcfg, trng)
        assert got == want, gid
        # the draws consumed alike
        assert trng.random() == jrng.random()


@pytest.mark.parametrize("algorithm", sorted(JB.SELECTORS))
def test_select_all_groups_equals_jax(algorithm):
    sizes = {"G01": 3, "G02": 0, "G05": 5, "G07": 2, "unknown": 4}
    for round_num in (1, 3):
        want = JB.select_all_groups(
            algorithm, _groups(JB), JB.BanditConfig(round_num=round_num,
                                                    batch_size=2),
            sizes, seed=11)
        got = TB.select_all_groups(
            algorithm, _groups(TB), TB.BanditConfig(round_num=round_num,
                                                    batch_size=2),
            sizes, seed=11)
        assert got == want and len(got) > 10


def test_price_opt_arms_equal_jax():
    want, got = jarms(n_groups=30, seed=11), tarms(n_groups=30, seed=11)
    assert list(got) == list(want)
    for gid, (arms, reward) in want.items():
        assert got[gid][0] == arms
        assert np.array_equal(got[gid][1], reward)


def _price_loop(pkg, arms_fn, rounds=40):
    """``tests/test_bandits.py``'s price-optimization loop: select, observe
    the planted concave revenue, fold the running average, next round."""
    groups_spec = arms_fn(n_groups=20, seed=11)
    rng = np.random.default_rng(5)
    state = {g: pkg.GroupItems(items=arms, counts=np.zeros(len(arms), int),
                               rewards=np.zeros(len(arms), int))
             for g, (arms, _) in groups_spec.items()}
    picks = []
    for round_num in range(1, rounds):
        cfg = pkg.BanditConfig(round_num=round_num, batch_size=1,
                               prob_reduction_algorithm="linear",
                               random_selection_prob=0.8,
                               prob_reduction_constant=8.0)
        selections = pkg.select_all_groups("GreedyRandomBandit", state, cfg,
                                           seed=7)
        picks.append(selections)
        for gid, item in selections:
            arms, expect = groups_spec[gid]
            j = arms.index(item)
            reward = max(int(rng.normal(expect[j], 2)), 1)
            g = state[gid]
            total = g.rewards[j] * g.counts[j] + reward
            g.counts[j] += 1
            g.rewards[j] = total // g.counts[j]
    return picks, state, groups_spec


def test_price_optimization_loop_equals_jax():
    want, jstate, spec = _price_loop(JB, jarms)
    got, tstate, _ = _price_loop(TB, tarms)
    assert got == want
    for gid in jstate:
        assert np.array_equal(tstate[gid].counts, jstate[gid].counts)
        assert np.array_equal(tstate[gid].rewards, jstate[gid].rewards)
    hits = sum(int(np.argmax(tstate[g].rewards) == np.argmax(expect))
               for g, (_, expect) in spec.items())
    assert hits >= 14, hits


def test_group_items_from_rows():
    rows = [["G", "a", "3", "40"], ["G", "b", "0", "0"]]
    want = JB.GroupItems.from_rows(rows)
    got = TB.GroupItems.from_rows(rows)
    assert got.items == want.items
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.rewards, want.rewards)
