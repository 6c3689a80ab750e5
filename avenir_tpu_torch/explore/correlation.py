"""Categorical correlation: Cramér index, concentration, uncertainty.

Counterpart of ``avenir_tpu/explore/correlation.py``. The reference builds
per-mapper in-memory contingency matrices for configured (src, dst)
attribute pairs and reduces them (CramerCorrelation.java:161-235;
CategoricalCorrelation.java abstract reducer :155-209;
HeterogeneityReductionCorrelation.java:67-86). Here the contingency
matrices of all the pairs come from one K4 launch
(``ops/histogram.pair_counts_multi``) and one copy to the host, and the
indices are numpy formulas over each count matrix, copied from the JAX
package so that the same counts give the same bytes
(ContingencyMatrix.java):

- cramerIndex (:86-123):  (Σ p²/(p_r p_c) − 1) / (min(R,C) − 1)
- concentrationCoeff (:141-163): Goodman–Kruskal tau
- uncertaintyCoeff (:165-185): MI(row;col)/H(col). NOTE the reference's
  inner log multiplies by colSum where the standard formula divides
  (``p·c/r`` instead of ``p/(r·c)``) — an apparent bug; this build uses the
  standard Theil's U, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_histogram, histogram
from avenir_tpu_torch.utils.dataset import EncodedTable


def cramer_index(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    pr = np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
    pc = np.maximum(p.sum(axis=0, keepdims=True), 1e-12)
    pearson = float((p * p / (pr * pc)).sum()) - 1.0
    smaller = min(counts.shape)
    return pearson / max(smaller - 1, 1)


def concentration_coeff(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    pr = np.maximum(p.sum(axis=1), 1e-12)
    pc = p.sum(axis=0)
    sum_one = float(((p * p).sum(axis=1) / pr).sum())
    sum_two = float((pc * pc).sum())
    denom = 1.0 - sum_two
    return (sum_one - sum_two) / denom if denom > 1e-12 else 0.0


def uncertainty_coeff(counts: np.ndarray) -> float:
    """Theil's U (standard formula; see module docstring deviation note)."""
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    pr = p.sum(axis=1, keepdims=True)
    pc = p.sum(axis=0, keepdims=True)
    mask = p > 0
    mi = float(np.sum(np.where(
        mask, p * np.log(np.maximum(p, 1e-30) /
                         np.maximum(pr * pc, 1e-30)), 0.0)))
    h_col = -float(np.sum(np.where(pc > 0,
                                   pc * np.log(np.maximum(pc, 1e-30)), 0.0)))
    return mi / h_col if h_col > 1e-12 else 0.0


STAT_ALGORITHMS = {
    "cramerIndex": cramer_index,
    "concentrationCoeff": concentration_coeff,
    "uncertaintyCoeff": uncertainty_coeff,
}


def correlate_pairs(table: EncodedTable,
                    pairs: List[Tuple[int, int]],
                    algorithm: str = "cramerIndex",
                    class_ordinal: Optional[int] = None
                    ) -> Dict[Tuple[int, int], float]:
    """Correlation stat for each (srcOrdinal, dstOrdinal) attribute pair —
    the whole CramerCorrelation / HeterogeneityReductionCorrelation job.
    The counts of every pair are taken on the table's device in one call,
    over the columns the pairs name, the statistic in numpy over each f32
    count matrix.

    Either side of a pair may name the class attribute (pass its ordinal as
    ``class_ordinal``): to the reference the class column is just another
    categorical attribute, and the churn tutorial correlates each feature
    against it (tutorial_customer_churn_cramer_index.txt)."""
    stat = STAT_ALGORITHMS[algorithm]
    pos = {f.ordinal: i for i, f in enumerate(table.feature_fields)}

    def column(ordinal: int) -> Tuple[torch.Tensor, int]:
        if ordinal in pos:
            p = pos[ordinal]
            return table.binned[:, p], table.bins_per_feature[p]
        if class_ordinal is not None and ordinal == class_ordinal:
            if table.labels is None:
                raise ValueError("class column requested but the table has "
                                 "no labels")
            return table.labels, table.n_classes
        raise KeyError(f"ordinal {ordinal} is neither a feature field nor "
                       "the class attribute")

    if not pairs:
        return {}
    slot: Dict[int, int] = {}
    columns, cards = [], []
    for ordinal in (o for pair in pairs for o in pair):
        if ordinal not in slot:
            ids, card = column(ordinal)
            slot[ordinal] = len(columns)
            columns.append(ids.to(torch.int32))
            cards.append(card)
    slot_pairs = [(slot[src], slot[dst]) for src, dst in pairs]
    flat = histogram.pair_counts_multi(torch.stack(columns), slot_pairs,
                                       cards).cpu()
    counts = cuda_histogram.split_pairs(flat, slot_pairs, cards)
    return {(src, dst): float(stat(c.numpy()))
            for (src, dst), c in zip(pairs, counts)}
