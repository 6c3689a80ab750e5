"""Labeled matrices with text (de)serialization.

Counterpart of ``avenir_tpu/utils/tables.py``, copied (numpy only): the
reference's row normalization ``laplace_and_scale``, shared by the Markov
and HMM models, and ``LabeledMatrix``, the chombo ``TabularData`` /
``DoubleTable`` surface (StateTransitionProbability.java:28,
MarkovModel.java:32): a 2-D array with row/column string labels,
serialized one row per CSV line so the matrix can be written into and
parsed out of a model text file.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def laplace_and_scale(counts: np.ndarray, scale: int) -> np.ndarray:
    """The reference's row normalization (StateTransitionProbability.java
    :65-95), shared by every model that emits probability matrices: +1 to
    every cell of any row containing a zero, then integer floor division
    ``count*scale // rowSum`` (scale>1) or plain division (scale=1).
    Operates on the last axis; leading axes batch."""
    counts = counts.copy()
    rows_with_zero = (counts == 0).any(axis=-1)
    counts[rows_with_zero] += 1
    row_sum = counts.sum(axis=-1, keepdims=True)
    row_sum[row_sum == 0] = 1
    if scale > 1:
        return np.floor_divide(counts.astype(np.int64) * scale,
                               row_sum.astype(np.int64)).astype(np.float64)
    return counts / row_sum


class LabeledMatrix:
    """Row/column-labeled dense matrix (host side; device ops take ``.values``)."""

    def __init__(self, row_labels: Sequence[str], col_labels: Sequence[str],
                 values: Optional[np.ndarray] = None, dtype=np.float64):
        self.row_labels = list(row_labels)
        self.col_labels = list(col_labels)
        if values is None:
            values = np.zeros((len(self.row_labels), len(self.col_labels)),
                              dtype=dtype)
        self.values = np.asarray(values, dtype=dtype)
        if self.values.shape != (len(self.row_labels), len(self.col_labels)):
            raise ValueError("values shape does not match labels")

    # -- element access by label --------------------------------------------
    def row_index(self, label: str) -> int:
        return self.row_labels.index(label)

    def col_index(self, label: str) -> int:
        return self.col_labels.index(label)

    def get(self, row: str, col: str) -> float:
        return float(self.values[self.row_index(row), self.col_index(col)])

    def add(self, row: str, col: str, amount: float = 1) -> None:
        self.values[self.row_index(row), self.col_index(col)] += amount

    # -- transforms ----------------------------------------------------------
    def laplace_correct(self, pseudo_count: float = 1.0) -> "LabeledMatrix":
        """Add pseudo-count to every cell of any row containing a zero — the
        reference's correction (StateTransitionProbability.java:65-78 bumps
        the whole row when any cell is 0, keeping all log-probs finite)."""
        rows_with_zero = (self.values == 0).any(axis=1)
        self.values[rows_with_zero, :] += pseudo_count
        return self

    def row_normalize(self, scale: Optional[int] = None) -> "LabeledMatrix":
        """Normalize each row to sum 1, or to ``scale`` via the reference's
        integer floor division (same semantics as :func:`laplace_and_scale`
        minus the Laplace step, which :meth:`laplace_correct` applies)."""
        sums = self.values.sum(axis=1, keepdims=True)
        sums[sums == 0] = 1.0
        if scale is not None:
            self.values = np.floor_divide(
                self.values.astype(np.int64) * scale,
                sums.astype(np.int64)).astype(np.float64)
        else:
            self.values = self.values / sums
        return self

    # -- serialization (one CSV line per row) --------------------------------
    def serialize_rows(self, delim: str = ",", as_int: bool = False) -> List[str]:
        lines = []
        for r in range(self.values.shape[0]):
            vals = self.values[r]
            if as_int:
                lines.append(delim.join(str(int(round(v))) for v in vals))
            else:
                lines.append(delim.join(format(v, "g") for v in vals))
        return lines

    def deserialize_row(self, row_label: str, line: str,
                        delim: str = ",") -> None:
        tokens = [t for t in line.split(delim) if t != ""]
        self.values[self.row_index(row_label), :] = [float(t) for t in tokens]

    @staticmethod
    def from_lines(row_labels: Sequence[str], col_labels: Sequence[str],
                   lines: Sequence[str], delim: str = ",") -> "LabeledMatrix":
        m = LabeledMatrix(row_labels, col_labels)
        for label, line in zip(row_labels, lines):
            m.deserialize_row(label, line, delim)
        return m
