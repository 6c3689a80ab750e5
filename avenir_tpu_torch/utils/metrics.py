"""Metrics: the counter/validation system.

The reference's metrics are Hadoop counters — semantic names like
``("Validation","TruePositive")`` (NearestNeighbor.java:300-312) and record
counts — plus a ``validation.mode`` flag that keeps ground truth flowing so a
confusion matrix can be accumulated (BayesianPredictor.java:170-180).

Each job returns a :class:`MetricsRegistry` (dict of named numbers) and
classification jobs fill a :class:`ConfusionMatrix`, on the host, from numpy
arrays or torch tensors on any device. ``report().to_json()`` is byte for
byte the JSON ``avenir_tpu.utils.metrics`` writes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def to_numpy(a) -> np.ndarray:
    """Host copy of a numpy array, list or torch tensor (any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class MetricsRegistry:
    """Named counters, grouped like Hadoop counter groups."""

    def __init__(self):
        self._counters: Dict[str, float] = {}

    def incr(self, group: str, name: str, amount: float = 1) -> None:
        key = f"{group}.{name}"
        self._counters[key] = self._counters.get(key, 0) + float(amount)

    def set(self, group: str, name: str, value: float) -> None:
        self._counters[f"{group}.{name}"] = float(value)

    def get(self, group: str, name: str) -> float:
        return self._counters.get(f"{group}.{name}", 0.0)

    def as_dict(self) -> Dict[str, float]:
        return dict(self._counters)

    def to_json(self) -> str:
        return json.dumps(self._counters, sort_keys=True)

    def __repr__(self) -> str:
        return f"MetricsRegistry({self._counters})"


class ConfusionMatrix:
    """Multi-class confusion matrix with the reference's validation counters.

    For the binary case, ``positive_class`` selects which label maps to
    TP/FP/TN/FN exactly as the reference's per-record counter increments do.
    """

    def __init__(self, class_values: Sequence[str],
                 positive_class: Optional[str] = None):
        self.class_values: List[str] = list(class_values)
        self.positive_class = positive_class
        n = len(self.class_values)
        self.matrix = np.zeros((n, n), dtype=np.int64)  # [truth, predicted]
        self.invalid = 0  # index pairs rejected by update()

    def update(self, predicted, truth, strict: bool = False) -> None:
        """Accumulate from index arrays. Pairs outside ``[0, n_classes)``
        are counted in ``invalid`` (the ``Validation.Invalid`` counter) and
        dropped, or raised with the offending values under ``strict=True``."""
        n = len(self.class_values)
        pred = to_numpy(predicted).astype(np.int64).ravel()
        true = to_numpy(truth).astype(np.int64).ravel()
        if pred.shape != true.shape:
            raise ValueError(
                f"predicted and truth disagree on length: {pred.shape[0]} "
                f"vs {true.shape[0]}")
        ok = (pred >= 0) & (pred < n) & (true >= 0) & (true < n)
        n_bad = int(pred.shape[0] - ok.sum())
        if n_bad:
            if strict:
                bad_rows = np.nonzero(~ok)[0][:5]
                pairs = [(int(true[i]), int(pred[i])) for i in bad_rows]
                raise ValueError(
                    f"{n_bad} (truth, predicted) index pairs fall outside "
                    f"[0, {n}) for {n} classes; first offenders "
                    f"(truth, pred) at rows {bad_rows.tolist()}: {pairs}")
            self.invalid += n_bad
            pred, true = pred[ok], true[ok]
        flat = np.bincount(true * n + pred, minlength=n * n)
        self.matrix += flat.reshape(n, n)

    # -- derived metrics -----------------------------------------------------
    @property
    def total(self) -> int:
        return int(self.matrix.sum())

    @property
    def accuracy(self) -> float:
        t = self.total
        return float(np.trace(self.matrix)) / t if t else 0.0

    def _pos_index(self) -> int:
        if self.positive_class is None:
            raise ValueError("positive_class not set")
        return self.class_values.index(self.positive_class)

    @property
    def true_positive(self) -> int:
        p = self._pos_index()
        return int(self.matrix[p, p])

    @property
    def false_positive(self) -> int:
        p = self._pos_index()
        return int(self.matrix[:, p].sum() - self.matrix[p, p])

    @property
    def false_negative(self) -> int:
        p = self._pos_index()
        return int(self.matrix[p, :].sum() - self.matrix[p, p])

    @property
    def true_negative(self) -> int:
        p = self._pos_index()
        return int(self.total - self.matrix[p, :].sum()
                   - self.matrix[:, p].sum() + self.matrix[p, p])

    @property
    def precision(self) -> float:
        denom = self.true_positive + self.false_positive
        return self.true_positive / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.true_positive + self.false_negative
        return self.true_positive / denom if denom else 0.0

    def report(self, metrics: Optional[MetricsRegistry] = None
               ) -> MetricsRegistry:
        """Fill a registry with the reference's Validation counter names."""
        metrics = metrics or MetricsRegistry()
        metrics.set("Validation", "Total", self.total)
        metrics.set("Validation", "Accuracy", self.accuracy)
        if self.invalid:
            metrics.set("Validation", "Invalid", self.invalid)
        if self.positive_class is not None:
            metrics.set("Validation", "TruePositive", self.true_positive)
            metrics.set("Validation", "FalsePositive", self.false_positive)
            metrics.set("Validation", "TrueNegative", self.true_negative)
            metrics.set("Validation", "FalseNegative", self.false_negative)
            metrics.set("Validation", "Precision", self.precision)
            metrics.set("Validation", "Recall", self.recall)
        return metrics
