"""Seeded workload generators with planted signal: the churn (Naive Bayes,
Cramér correlation), elearn (KNN), hospital-readmission (mutual
information) and abandoned-cart retarget (decision tree and forest)
tutorials, the Markov-chain and HMM sequences (the email-marketing and
customer-loyalty tutorials), the price-optimization bandit's arms, the
email-marketing tutorial's purchase stream (the Projection stage's input),
the bursty event sequences and the online tutorial's lead-generation
environment (``LeadGenSimulator``).

A copy of the churn, elearn, hospital-readmission, retarget, price
optimization, Markov sequence, tagged HMM, purchase-stream
(``buy_xaction_rows``), event-sequence and lead-generation sections of
``avenir_tpu/datagen/generators.py``: the same numpy calls in the same
order, so the same seed gives the same rows. The port imports nothing of
the JAX package, and ``chip_smoke.py`` writes its CSVs from here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from avenir_tpu_torch.utils.schema import FeatureSchema


# --------------------------------------------------------------------------
# churn (Naive Bayes tutorial: resource/churn.json + usage.rb-style data)
# --------------------------------------------------------------------------

_CHURN_SCHEMA_JSON = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "minUsed", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["low", "med", "high", "overage"], "feature": True},
        {"name": "dataUsed", "ordinal": 2, "dataType": "categorical",
         "cardinality": ["low", "med", "high"], "feature": True},
        {"name": "CSCalls", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["low", "med", "high"], "feature": True},
        {"name": "payment", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["poor", "average", "good"], "feature": True},
        {"name": "acctAge", "ordinal": 5, "dataType": "categorical",
         "cardinality": ["1", "2", "3", "4", "5"], "feature": True},
        {"name": "status", "ordinal": 6, "dataType": "categorical",
         "cardinality": ["open", "closed"]},
    ]
}


def churn_schema() -> FeatureSchema:
    return FeatureSchema.from_json(_CHURN_SCHEMA_JSON)


def churn_rows(n: int, seed: int = 42, churn_rate: float = 0.3
               ) -> List[List[str]]:
    """Planted signal: churners skew to high CSCalls, poor payment, low
    acctAge — the structure usage.rb plants for the churn tutorial."""
    rng = np.random.default_rng(seed)
    closed = rng.random(n) < churn_rate

    def pick(options, p_open, p_closed):
        out = np.empty(n, dtype=object)
        idx_open = rng.choice(len(options), size=n, p=p_open)
        idx_closed = rng.choice(len(options), size=n, p=p_closed)
        chosen = np.where(closed, idx_closed, idx_open)
        for i, opt in enumerate(options):
            out[chosen == i] = opt
        return out

    min_used = pick(["low", "med", "high", "overage"],
                    [0.2, 0.4, 0.3, 0.1], [0.45, 0.3, 0.15, 0.1])
    data_used = pick(["low", "med", "high"],
                     [0.25, 0.45, 0.3], [0.5, 0.3, 0.2])
    cs_calls = pick(["low", "med", "high"],
                    [0.6, 0.3, 0.1], [0.15, 0.3, 0.55])
    payment = pick(["poor", "average", "good"],
                   [0.1, 0.35, 0.55], [0.5, 0.35, 0.15])
    acct_age = pick(["1", "2", "3", "4", "5"],
                    [0.1, 0.15, 0.2, 0.25, 0.3], [0.4, 0.25, 0.15, 0.12, 0.08])

    rows = []
    for i in range(n):
        rows.append([
            f"C{i:07d}", str(min_used[i]), str(data_used[i]),
            str(cs_calls[i]), str(payment[i]), str(acct_age[i]),
            "closed" if closed[i] else "open",
        ])
    return rows


# --------------------------------------------------------------------------
# elearn (KNN tutorial: resource/elearnActivity.json + elearn.py)
# --------------------------------------------------------------------------

_ELEARN_FIELDS = [
    ("contentTime", 0, 600), ("discussTime", 0, 200), ("organizerTime", 0, 100),
    ("emailCount", 0, 28), ("testScore", 0, 100), ("assignmentScore", 0, 100),
    ("chatMsgCount", 0, 280), ("searchTime", 0, 180), ("bookMarkCount", 0, 26),
]


def elearn_schema_json() -> Dict:
    fields = [{"name": "studentID", "ordinal": 0, "id": True,
               "dataType": "string"}]
    for i, (name, lo, hi) in enumerate(_ELEARN_FIELDS):
        fields.append({"name": name, "ordinal": i + 1, "dataType": "int",
                       "min": lo, "max": hi})
    fields.append({"name": "status", "ordinal": len(_ELEARN_FIELDS) + 1,
                   "dataType": "categorical", "classAttribute": True,
                   "cardinality": ["pass", "fail"]})
    return {
        "distAlgorithm": "euclidean",
        "numericDiffThreshold": 0.2,
        "entity": {"name": "studentActivity", "fields": fields},
    }


def elearn_schema() -> FeatureSchema:
    return FeatureSchema.from_json(elearn_schema_json())


def elearn_rows(n: int, seed: int = 7, fail_rate: float = 0.25
                ) -> List[List[str]]:
    """Per-feature Gaussians whose means shift down for failing students —
    resource/elearn.py's planted structure (mean activity drives outcome)."""
    rng = np.random.default_rng(seed)
    fail = rng.random(n) < fail_rate
    rows = []
    for i in range(n):
        scale = 0.45 if fail[i] else 0.75
        row = [f"S{i:07d}"]
        for name, lo, hi in _ELEARN_FIELDS:
            mean = lo + scale * (hi - lo)
            std = 0.18 * (hi - lo)
            v = int(np.clip(rng.normal(mean, std), lo, hi))
            row.append(str(v))
        row.append("fail" if fail[i] else "pass")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# hospital readmission (MI tutorial: resource/hosp_readmit.rb,
# tutorial_hospital_readmit.txt — 20,000 records)
# --------------------------------------------------------------------------

_HOSP_SCHEMA_JSON = {
    "fields": [
        {"name": "patID", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "age", "ordinal": 1, "dataType": "int",
         "min": 10, "max": 90, "bucketWidth": 10, "feature": True},
        {"name": "weight", "ordinal": 2, "dataType": "int",
         "min": 130, "max": 250, "bucketWidth": 20, "feature": True},
        {"name": "height", "ordinal": 3, "dataType": "int",
         "min": 50, "max": 75, "bucketWidth": 5, "feature": True},
        {"name": "employment", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["employed", "unemployed", "retired"],
         "feature": True},
        {"name": "familyStatus", "ordinal": 5, "dataType": "categorical",
         "cardinality": ["alone", "with partner"], "feature": True},
        {"name": "diet", "ordinal": 6, "dataType": "categorical",
         "cardinality": ["poor", "average", "good"], "feature": True},
        {"name": "exercise", "ordinal": 7, "dataType": "categorical",
         "cardinality": ["low", "average", "high"], "feature": True},
        {"name": "followUp", "ordinal": 8, "dataType": "categorical",
         "cardinality": ["low", "average", "high"], "feature": True},
        {"name": "smoking", "ordinal": 9, "dataType": "categorical",
         "cardinality": ["non smoker", "smoker"], "feature": True},
        {"name": "alcohol", "ordinal": 10, "dataType": "categorical",
         "cardinality": ["low", "average", "high"], "feature": True},
        {"name": "readmitted", "ordinal": 11, "dataType": "categorical",
         "classAttribute": True, "cardinality": ["Y", "N"]},
    ]
}


def hosp_readmit_schema() -> FeatureSchema:
    return FeatureSchema.from_json(_HOSP_SCHEMA_JSON)


def hosp_readmit_rows(n: int, seed: int = 13) -> List[List[str]]:
    """Readmission probability is a base rate plus planted bumps for old age,
    obesity, unemployment/retirement, poor diet and low follow-up — the
    additive-risk structure hosp_readmit.rb plants, so mutual-information
    selection ranks age/diet/followUp above the noise fields."""
    rng = np.random.default_rng(seed)

    def cat(options, weights):
        w = np.asarray(weights, float)
        return options[int(rng.choice(len(options), p=w / w.sum()))]

    rows = []
    for i in range(n):
        prob = 0.20
        age = int(rng.choice(
            [15, 25, 35, 45, 55, 65, 75, 85],
            p=np.array([2, 3, 6, 10, 14, 19, 25, 21]) / 100))
        age += int(rng.integers(-4, 5))
        if age > 80:
            prob += 0.10
        elif age > 70:
            prob += 0.05
        elif age > 60:
            prob += 0.03
        weight = int(rng.integers(130, 251))
        height = int(rng.integers(50, 76))
        if weight > 200 and height < 70:
            prob += 0.05
        elif weight > 180 and height < 60:
            prob += 0.03
        emp = cat(["employed", "unemployed", "retired"], [10, 1, 3])
        if age > 68 and rng.integers(0, 10) < 8:
            emp = "retired"
        if emp == "unemployed":
            prob += 0.06
        elif emp == "retired":
            prob += 0.04
        family = cat(["alone", "with partner"], [10, 15])
        if family == "alone":
            prob += 0.04
        diet = cat(["average", "poor", "good"], [10, 4, 2])
        if diet == "poor":
            prob += 0.06
        exercise = cat(["average", "low", "high"], [10, 12, 4])
        if exercise == "low":
            prob += 0.04
        follow_up = cat(["average", "low", "high"], [10, 14, 3])
        if follow_up == "low":
            prob += 0.08
        smoking = cat(["non smoker", "smoker"], [10, 3])
        if smoking == "smoker":
            prob += 0.05
        alcohol = cat(["average", "low", "high"], [10, 16, 4])
        if alcohol == "high":
            prob += 0.04
        readmitted = "Y" if rng.random() < prob else "N"
        rows.append([f"H{i:010d}", str(age), str(weight), str(height), emp,
                     family, diet, exercise, follow_up, smoking, alcohol,
                     readmitted])
    return rows


# --------------------------------------------------------------------------
# retarget (decision-tree tutorial: resource/retarget.py)
# --------------------------------------------------------------------------

_RETARGET_SCHEMA_JSON = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "cartValue", "ordinal": 1, "dataType": "int",
         "min": 0, "max": 500, "bucketWidth": 50, "maxSplit": 4,
         "feature": True},
        {"name": "visitCount", "ordinal": 2, "dataType": "int",
         "min": 0, "max": 40, "bucketWidth": 10, "maxSplit": 4,
         "feature": True},
        {"name": "loyalty", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["bronze", "silver", "gold"], "maxSplit": 3,
         "feature": True},
        {"name": "converted", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["yes", "no"]},
    ]
}


def retarget_schema() -> FeatureSchema:
    return FeatureSchema.from_json(_RETARGET_SCHEMA_JSON)


def retarget_rows(n: int, seed: int = 5) -> List[List[str]]:
    """Conversion is planted on cartValue > 250 and loyalty == gold, so a
    depth-2 tree recovers the rule."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        cart = int(rng.integers(0, 501))
        visits = int(rng.integers(0, 41))
        loyalty = ["bronze", "silver", "gold"][int(rng.integers(0, 3))]
        p = 0.15
        if cart > 250:
            p += 0.45
        if loyalty == "gold":
            p += 0.25
        converted = "yes" if rng.random() < p else "no"
        rows.append([f"R{i:06d}", str(cart), str(visits), loyalty, converted])
    return rows


# --------------------------------------------------------------------------
# price optimization (bandit tutorial: resource/price_opt.py)
# --------------------------------------------------------------------------

def price_opt_arms(n_groups: int = 100, n_arms_lo: int = 6,
                   n_arms_hi: int = 12, seed: int = 11
                   ) -> Dict[str, Tuple[List[str], np.ndarray]]:
    """Per-product candidate prices with a concave expected-revenue curve and
    a known peak (resource/price_opt.py:7-27). Returns
    {group: (arm_names, expected_reward[arm])}."""
    rng = np.random.default_rng(seed)
    groups = {}
    for g in range(n_groups):
        n_arms = int(rng.integers(n_arms_lo, n_arms_hi + 1))
        base = rng.uniform(20, 80)
        prices = np.round(base * (1 + 0.08 * np.arange(n_arms)), 2)
        peak = rng.integers(0, n_arms)
        # concave revenue curve peaking at `peak`
        reward = 100 - 8.0 * (np.arange(n_arms) - peak) ** 2
        reward = np.maximum(reward, 5.0) + rng.uniform(0, 1, n_arms)
        groups[f"P{g:04d}"] = ([str(p) for p in prices], reward)
    return groups


# --------------------------------------------------------------------------
# Markov state sequences (resource/xaction_state.rb / event_seq.rb)
# --------------------------------------------------------------------------

def markov_sequences(n: int, states: List[str], trans: np.ndarray,
                     min_len: int = 5, max_len: int = 30, seed: int = 3
                     ) -> List[Tuple[str, List[str]]]:
    """Sample (id, state sequence) rows from a known transition matrix, so
    tests can recover the planted matrix."""
    rng = np.random.default_rng(seed)
    n_states = len(states)
    rows = []
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        seq = [int(rng.integers(0, n_states))]
        for _ in range(length - 1):
            seq.append(int(rng.choice(n_states, p=trans[seq[-1]])))
        rows.append((f"X{i:06d}", [states[s] for s in seq]))
    return rows


# --------------------------------------------------------------------------
# tagged HMM sequences (the customer-loyalty tutorial)
# --------------------------------------------------------------------------

#: the customer-loyalty tutorial's model
#: (resource/customer_loyalty_trajectory_tutorial.txt:18-30): loyalty
#: low / neutral / high, observations (purchase gap S/M/L) x (amount
#: L/S/M), the constants ``tests/test_markov_hmm.py`` holds
LOYALTY_STATES = ["L", "N", "H"]
LOYALTY_OBSERVATIONS = ["SL", "SS", "SM", "ML", "MS", "MM", "LL", "LS", "LM"]
LOYALTY_TRANS = np.asarray([[.30, .45, .25], [.35, .40, .25],
                            [.25, .35, .40]])
LOYALTY_EMIT = np.asarray([
    [.08, .05, .01, .15, .12, .07, .21, .17, .14],
    [.10, .09, .08, .17, .15, .12, .11, .10, .08],
    [.13, .18, .21, .08, .12, .14, .03, .04, .07]])
LOYALTY_INITIAL = np.asarray([.38, .36, .26])


def hmm_tagged_rows(n: int, states: List[str], observations: List[str],
                    trans: np.ndarray, emit: np.ndarray,
                    initial: np.ndarray, min_len: int = 8,
                    max_len: int = 40, seed: int = 19,
                    sub_field_delim: str = ":") -> List[List[str]]:
    """Fully tagged ``obs:state`` sequences sampled from a known HMM, so
    ``hmm.train_fully_tagged`` recovers the planted matrices (the fixture the
    reference's customer-loyalty tutorial builds by hand,
    customer_loyalty_trajectory_tutorial.txt:18-30)."""
    rng = np.random.default_rng(seed)
    n_states = len(states)
    rows = []
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        s = int(rng.choice(n_states, p=initial))
        row = [f"T{i:08d}"]
        for _ in range(length):
            o = int(rng.choice(len(observations), p=emit[s]))
            row.append(f"{observations[o]}{sub_field_delim}{states[s]}")
            s = int(rng.choice(n_states, p=trans[s]))
        rows.append(row)
    return rows


def buy_xaction_rows(cust_count: int, days_count: int,
                     visitor_fraction: float = 0.05, seed: int = 23
                     ) -> List[List[str]]:
    """(custID, xactionID, dayNumber, amount) purchase rows with
    buy_xaction.rb's planted recency/amount structure (:32-48): amount
    depends on the gap since the customer's previous purchase (<30 / <60 /
    60+ days) and on whether the previous amount was small — so the derived
    two-letter states (``markov.transaction_states``) have a strongly
    non-uniform transition matrix the model can recover. Days are emitted as
    absolute day numbers rather than date strings (the tutorial's dates only
    ever feed day-difference arithmetic, xaction_state.rb:22-25)."""
    rng = np.random.default_rng(seed)
    cust_ids = [f"C{rng.integers(0, 10**10):010d}" for _ in range(cust_count)]
    last: Dict[str, Tuple[int, int]] = {}
    rows: List[List[str]] = []
    xid = 10 ** 9
    for day in range(days_count):
        n_today = int(visitor_fraction * cust_count
                      * (85 + rng.integers(0, 30)) / 100)
        for _ in range(n_today):
            cid = cust_ids[int(rng.integers(0, cust_count))]
            if cid in last:
                pr_day, pr_amt = last[cid]
                gap = day - pr_day
                if gap < 30:
                    amount = (50 + int(rng.integers(0, 20)) - 10
                              if pr_amt < 40
                              else 30 + int(rng.integers(0, 10)) - 5)
                elif gap < 60:
                    amount = (100 + int(rng.integers(0, 40)) - 20
                              if pr_amt < 80
                              else 60 + int(rng.integers(0, 20)) - 10)
                else:
                    amount = (180 + int(rng.integers(0, 60)) - 30
                              if pr_amt < 150
                              else 120 + int(rng.integers(0, 40)) - 20)
            else:
                amount = 40 + int(rng.integers(0, 180))
            last[cid] = (day, amount)
            xid += 1
            rows.append([cid, str(xid), str(day), str(amount)])
    return rows


# --------------------------------------------------------------------------
# event sequences (HMM tutorial: resource/event_seq.rb)
# --------------------------------------------------------------------------

EVENT_SEQ_EVENTS = ["SL", "SS", "SM", "ML", "MS", "MM", "LL", "LS", "LM"]


def event_seq_rows(n: int, seed: int = 17, min_events: int = 5,
                   max_events: int = 24) -> List[List[str]]:
    """(custID, events...) rows with event_seq.rb's bursty structure: events
    come in three hidden groups of three (S*/M*/L* prefixes) and ~30% of
    picks trigger a 1-3 event burst inside the same group — the latent-group
    persistence an HMM can recover."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        events: List[str] = []
        for _ in range(int(rng.integers(min_events, max_events + 1))):
            idx = int(rng.integers(0, len(EVENT_SEQ_EVENTS)))
            events.append(EVENT_SEQ_EVENTS[idx])
            if rng.integers(0, 10) < 3:
                for _ in range(int(rng.integers(1, 4))):
                    # burst picks only the group's first two members —
                    # event_seq.rb:21 does `rand(2)`, kept for parity
                    idx = (idx // 3) * 3 + int(rng.integers(0, 2))
                    events.append(EVENT_SEQ_EVENTS[idx])
        rows.append([f"E{i:010d}"] + events)
    return rows


# --------------------------------------------------------------------------
# lead generation (online RL tutorial: resource/lead_gen.py)
# --------------------------------------------------------------------------

class LeadGenSimulator:
    """The lead_gen.py environment: three actions with a known CTR
    distribution per action (mean, stddev — actionCtrDistr
    lead_gen.py:13), rewards reported once an action has been selected
    ``sel_count_threshold`` times (lead_gen.py:14, 50-61). Drives
    ``stream.loop.OnlineLearnerLoop`` through any queue adapter; tests check
    the learner converges to ``best_action``."""

    DEFAULT_CTR = {"page1": (30, 12), "page2": (60, 30), "page3": (80, 10)}

    def __init__(self, ctr_distr: Dict[str, Tuple[int, int]] = None,
                 sel_count_threshold: int = 50, seed: int = 23):
        self.ctr_distr = dict(ctr_distr or self.DEFAULT_CTR)
        self.threshold = sel_count_threshold
        self._rng = np.random.default_rng(seed)
        self._sel_counts = {a: 0 for a in self.ctr_distr}
        self._event_num = 0

    @property
    def actions(self) -> List[str]:
        return list(self.ctr_distr)

    @property
    def best_action(self) -> str:
        return max(self.ctr_distr, key=lambda a: self.ctr_distr[a][0])

    def next_event_id(self) -> str:
        self._event_num += 1
        return f"session{self._event_num:08d}"

    def observe_action(self, action: str):
        """Returns (action, reward) once the selection-count threshold trips
        (an approximately normal CTR sample like lead_gen.py's 12-uniform
        sum), else None."""
        self._sel_counts[action] += 1
        if self._sel_counts[action] < self.threshold:
            return None
        self._sel_counts[action] = 0
        mean, std = self.ctr_distr[action]
        reward = int(max(self._rng.normal(0.0, 1.0) * std + mean, 0.0))
        return action, reward

    def drive(self, loop, n_events: int) -> int:
        """Pump n_events through an OnlineLearnerLoop: push event, step the
        loop, consume the action, feed back rewards. Returns rewards sent."""
        rewards_sent = 0
        for _ in range(n_events):
            loop.queues.push_event(self.next_event_id())
            loop.step()
            popped = loop.queues.pop_action()
            if popped is None:
                continue
            _, actions = popped
            for action in actions:
                result = self.observe_action(action)
                if result is not None:
                    loop.queues.push_reward(*result)
                    rewards_sent += 1
        return rewards_sent
