"""Univariate Fisher linear discriminant.

The reference's FisherDiscriminant (src/main/java/org/avenir/discriminant/
FisherDiscriminant.java) reuses chombo's NumericalAttrStats mapper/combiner
for class-conditional mean/variance and computes, per attribute
(reducer cleanup :83-96):

    pooledVariance = (v0·n0 + v1·n1) / (n0 + n1)
    logOddsPrior   = ln(n0 / n1)
    boundary       = (m0 + m1)/2 − logOddsPrior·pooledVariance/meanDiff

Counterpart of ``avenir_tpu/models/fisher.py`` (``FisherModel``,
``train``, ``serialize``, ``classify``). The class-conditional moments
come from the port's ``ops/histogram.per_class_moments`` (float64 sums of
the f32 values, each rounded to f32 once, on the table's device); the
discriminant is the JAX module's numpy float64 arithmetic, copied, for
every attribute at once. So the file equals the JAX package's wherever
its f32 einsum sums are exact (integer features whose sums and sums of
squares stay below 2^24); past that the port's moments are the exact
ones (ROADMAP queue C). Classification assigns class0 when the value lies
on class0's side of the boundary (the side of mean0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from avenir_tpu_torch.ops.histogram import per_class_moments
from avenir_tpu_torch.utils.dataset import EncodedTable


@dataclass
class FisherModel:
    feature_ordinals: Tuple[int, ...]
    log_odds_prior: float
    pooled_variance: np.ndarray   # [F]
    boundary: np.ndarray          # [F]
    mean0: np.ndarray             # [F]
    mean1: np.ndarray             # [F]
    class_values: Tuple[str, str]


def train(table: EncodedTable) -> FisherModel:
    if table.n_classes != 2:
        raise ValueError("Fisher discriminant needs a binary class attribute")
    cnt, vsum, vsq = per_class_moments(table.numeric, table.labels, 2)
    cnt_n, vsum_n, vsq_n = (a.cpu().numpy() for a in (cnt, vsum, vsq))
    if cnt_n.shape[1] and (cnt_n[0, 0] == 0 or cnt_n[1, 0] == 0):
        missing = table.class_values[0 if cnt_n[0, 0] == 0 else 1]
        raise ValueError(
            f"class {missing!r} has no rows — both classes need samples "
            "for a discriminant boundary")
    n0, n1 = np.maximum(cnt_n[0], 1.0), np.maximum(cnt_n[1], 1.0)
    m0, m1 = vsum_n[0] / n0, vsum_n[1] / n1
    v0 = np.maximum(vsq_n[0] / n0 - m0 * m0, 1e-12)
    v1 = np.maximum(vsq_n[1] / n1 - m1 * m1, 1e-12)
    pooled = (v0 * n0 + v1 * n1) / (n0 + n1)
    log_odds = float(np.log(n0[0] / n1[0])) if cnt_n.shape[1] else 0.0
    mean_diff = m0 - m1
    safe_diff = np.where(np.abs(mean_diff) > 1e-12, mean_diff, 1e-12)
    boundary = (m0 + m1) / 2.0 - log_odds * pooled / safe_diff
    return FisherModel(
        feature_ordinals=tuple(f.ordinal for f in table.feature_fields),
        log_odds_prior=log_odds, pooled_variance=pooled, boundary=boundary,
        mean0=m0, mean1=m1, class_values=tuple(table.class_values))


def serialize(model: FisherModel, delim: str = ",") -> List[str]:
    """One line per attribute: ``attr,logOddsPrior,pooledVariance,boundary``
    (the reducer's output format :94)."""
    return [delim.join([str(o), repr(model.log_odds_prior),
                        repr(float(model.pooled_variance[i])),
                        repr(float(model.boundary[i]))])
            for i, o in enumerate(model.feature_ordinals)]


def classify(model: FisherModel, values,
             feature_index: int = 0) -> np.ndarray:
    """Class index per row from one attribute's value vs its boundary."""
    v = (values.cpu().numpy() if hasattr(values, "cpu")
         else np.asarray(values))
    b = model.boundary[feature_index]
    class0_above = model.mean0[feature_index] >= model.mean1[feature_index]
    pred0 = (v >= b) if class0_above else (v <= b)
    return np.where(pred0, 0, 1).astype(np.int64)
