"""Seeded workload generators with planted signal: the churn (Naive Bayes)
and elearn (KNN) tutorials.

A copy of the churn and elearn sections of
``avenir_tpu/datagen/generators.py``: the same numpy calls in the same
order, so the same seed gives the same rows. The port imports nothing of
the JAX package, and ``chip_smoke.py`` writes its CSVs from here.
"""

from __future__ import annotations

from typing import Dict, List

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
