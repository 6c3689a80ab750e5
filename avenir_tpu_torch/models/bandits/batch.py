"""Batch (MR-style) multi-armed bandits over grouped reward files.

Counterpart of ``avenir_tpu/models/bandits/batch.py``, copied: the module
is numpy only and runs no device work, so its selectors, its RNG draws
and their order are the JAX package's, and the same seed and round give
the same selections. The reference's per-round MR bandits consume a
sorted CSV of ``group,item,count,reward`` and emit ``group,item``
selections for the next round (resource/price_optimize_tutorial.txt
:42-62):

- GreedyRandomBandit.java: ε-greedy with linear/logLinear decay (:207-212)
  and the AuerGreedy mode prob = c·K/(d²·count) (:260)
- AuerDeterministic.java: UCB1 value = reward/maxReward + √(2 ln n / count)
  (:211), untried items first (:192-196)
- SoftMaxBandit.java: Boltzmann sampling over exp((reward/maxReward)/τ)
  (:183-199)
- RandomFirstGreedyBandit.java: PAC explore-first with budget
  4/d² + ln(2K/δ) (:143) or factor·K, then exploit by reward rank

Groups are independent and run one after another in sorted order, from
one ``default_rng(seed + round)``. Exploitation ties fall to Python's
stable ``max`` and ``sort``: the first item of the group wins.

DEVIATION (documented, as in the JAX package): the reference's ε-greedy
branch is inverted; this build explores with probability curProb.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class GroupItems:
    """One group's running aggregate: parallel arrays over items."""

    items: List[str]
    counts: np.ndarray     # trials so far
    rewards: np.ndarray    # aggregate (average) reward, reference int

    @staticmethod
    def from_rows(rows: Sequence[Sequence[str]], count_ord: int = 2,
                  reward_ord: int = 3) -> "GroupItems":
        return GroupItems(
            items=[r[1] for r in rows],
            counts=np.asarray([int(r[count_ord]) for r in rows]),
            rewards=np.asarray([int(r[reward_ord]) for r in rows]))


@dataclass(frozen=True)
class BanditConfig:
    """Reference property keys for the batch bandits."""

    round_num: int = 1                     # current.round.num
    batch_size: int = 1                    # per-group (group.item.count.path)
    random_selection_prob: float = 0.5     # random.selection.prob
    prob_reduction_constant: float = 1.0   # prob.reduction.constant
    prob_reduction_algorithm: str = "linear"  # linear|logLinear|AuerGreedy
    auer_greedy_constant: int = 5          # auer.greedy.constant
    temp_constant: float = 0.1             # temp.constant (softmax τ)
    exploration_count_factor: int = 2      # exploration.count.factor
    exploration_count_strategy: str = "simple"  # simple|pac
    reward_diff: float = 0.1               # reward.diff (PAC d)
    prob_diff: float = 0.1                 # prob.diff (PAC δ)


def _untried_first(group: GroupItems, batch_size: int) -> List[int]:
    """collectItemsNotTried (GroupedItems.java:94-113): untried items are
    taken first, up to the batch size."""
    untried = [i for i, c in enumerate(group.counts) if c == 0]
    return untried[:batch_size]


def greedy_random_select(group: GroupItems, cfg: BanditConfig,
                         rng: np.random.Generator) -> List[str]:
    """GreedyRandomBandit: ε-greedy (linear/logLinear) or AuerGreedy."""
    if cfg.prob_reduction_algorithm == "AuerGreedy":
        return _auer_greedy_select(group, cfg, rng)
    chosen: List[int] = []
    count = (cfg.round_num - 1) * cfg.batch_size
    for _ in range(cfg.batch_size):
        count += 1
        if cfg.prob_reduction_algorithm == "logLinear":
            cur = (cfg.random_selection_prob * cfg.prob_reduction_constant *
                   np.log(max(count, 1)) / count)
        else:
            cur = cfg.random_selection_prob * cfg.prob_reduction_constant / count
        cur = min(cur, cfg.random_selection_prob)
        avail = [i for i in range(len(group.items)) if i not in chosen]
        if not avail:
            break
        tried = [i for i in avail if group.counts[i] > 0]
        if rng.random() < cur or not tried:
            pick = int(rng.choice(avail))
        else:
            pick = max(tried, key=lambda i: group.rewards[i])
        chosen.append(pick)
    return [group.items[i] for i in chosen]


def _auer_greedy_select(group: GroupItems, cfg: BanditConfig,
                        rng: np.random.Generator) -> List[str]:
    """AuerGreedy mode (GreedyRandomBandit.java:230-272):
    prob = c·K / (d²·count) with d the relative gap between the two best."""
    chosen = _untried_first(group, cfg.batch_size)
    count = (cfg.round_num - 1) * cfg.batch_size + len(chosen)
    avail = [i for i in range(len(group.items)) if i not in chosen]
    if len(chosen) < cfg.batch_size and avail:
        order = np.argsort(-group.rewards)
        max_reward = max(group.rewards[order[0]], 1)
        next_max = group.rewards[order[1]] if len(order) > 1 else 0
        d = max((max_reward - next_max) / max_reward, 1e-6)
        k = len(group.items)
        while len(chosen) < cfg.batch_size and avail:
            count += 1
            # Auer's epsilon_t: explore with prob c*K/(d^2*count), exploit
            # otherwise (decaying exploration, same correction as ε-greedy)
            prob = min(cfg.auer_greedy_constant * k / (d * d * count), 1.0)
            if rng.random() < prob:
                pick = int(rng.choice(avail))
            else:
                pick = max(avail, key=lambda i: group.rewards[i])
            chosen.append(pick)
            avail.remove(pick)
    return [group.items[i] for i in chosen]


def auer_deterministic_select(group: GroupItems, cfg: BanditConfig,
                              rng: np.random.Generator) -> List[str]:
    """AuerDeterministic (UCB1): untried first, then
    value = reward/maxReward + √(2 ln count / itemCount) (:211)."""
    chosen = _untried_first(group, cfg.batch_size)
    count = (cfg.round_num - 1) * cfg.batch_size + len(chosen)
    avail = [i for i in range(len(group.items)) if i not in chosen]
    while len(chosen) < cfg.batch_size and avail:
        max_reward = max(int(np.max(group.rewards[avail])), 1)
        values = [group.rewards[i] / max_reward +
                  np.sqrt(2.0 * np.log(max(count, 2)) /
                          max(group.counts[i], 1))
                  for i in avail]
        pick = avail[int(np.argmax(values))]
        chosen.append(pick)
        avail.remove(pick)
        count += 1
    return [group.items[i] for i in chosen]


def softmax_select(group: GroupItems, cfg: BanditConfig,
                   rng: np.random.Generator) -> List[str]:
    """SoftMaxBandit: Boltzmann over exp((reward/maxReward)/τ), sampling
    without replacement (:183-199)."""
    chosen = _untried_first(group, cfg.batch_size)
    max_reward = max(int(np.max(group.rewards)), 1)
    distr = np.exp((group.rewards / max_reward) / cfg.temp_constant)
    avail = [i for i in range(len(group.items)) if i not in chosen]
    while len(chosen) < cfg.batch_size and avail:
        p = distr[avail] / distr[avail].sum()
        pick = int(rng.choice(avail, p=p))
        chosen.append(pick)
        avail.remove(pick)
    return [group.items[i] for i in chosen]


def random_first_greedy_select(group: GroupItems, cfg: BanditConfig,
                               rng: np.random.Generator) -> List[str]:
    """RandomFirstGreedyBandit: pure exploration (round-robin over untried /
    least-tried arms) until the exploration budget is exhausted, then greedy
    exploitation by reward rank. Budget: factor·K (simple) or the PAC bound
    4/d² + ln(2K/δ) (:143)."""
    k = len(group.items)
    if cfg.exploration_count_strategy == "simple":
        expl_count = cfg.exploration_count_factor * k
    else:
        expl_count = int(4.0 / (cfg.reward_diff ** 2) +
                         np.log(2.0 * k / cfg.prob_diff))
    consumed = (cfg.round_num - 1) * cfg.batch_size
    if consumed < expl_count:
        # exploration: round-robin — least-tried arms first
        order = np.argsort(group.counts, kind="stable")
        chosen = list(order[:cfg.batch_size])
    else:
        # exploitation: top-batch by reward among tried arms
        tried = [i for i in range(k) if group.counts[i] > 0]
        tried.sort(key=lambda i: -group.rewards[i])
        chosen = tried[:cfg.batch_size]
    return [group.items[i] for i in chosen]


SELECTORS = {
    "GreedyRandomBandit": greedy_random_select,
    "AuerDeterministic": auer_deterministic_select,
    "SoftMaxBandit": softmax_select,
    "RandomFirstGreedyBandit": random_first_greedy_select,
}


def select_all_groups(algorithm: str,
                      groups: Dict[str, GroupItems],
                      cfg: BanditConfig,
                      batch_sizes: Optional[Dict[str, int]] = None,
                      seed: int = 0) -> List[Tuple[str, str]]:
    """Run one round of selection for every group; returns (group, item)
    pairs — the MR job's output lines."""
    selector = SELECTORS[algorithm]
    rng = np.random.default_rng(seed + cfg.round_num)
    out: List[Tuple[str, str]] = []
    for gid in sorted(groups.keys()):
        gcfg = cfg
        if batch_sizes and gid in batch_sizes:
            gcfg = replace(cfg, batch_size=batch_sizes[gid])
        for item in selector(groups[gid], gcfg, rng):
            out.append((gid, item))
    return out
