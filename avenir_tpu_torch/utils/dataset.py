"""CSV → dense torch tensors on an explicit device.

Counterpart of ``avenir_tpu/utils/dataset.py`` (``part_file_paths``,
``read_csv_lines``, ``FieldEncoder``, ``EncodedTable``, ``Featurizer``,
``normalize_numeric``). Featurization happens once, on the host, into the
same dense arrays the JAX package builds:

- categorical feature  -> vocabulary index (schema ``cardinality`` list when
  present, else a vocabulary built from the data; unseen values are either an
  error or a reserved OOV bin — ``unseen='error'|'oov'``)
- numeric feature with ``bucketWidth`` -> ``value // bucketWidth`` bin id
- numeric feature without bucket width -> continuous float column

The table then holds them as torch tensors on the featurizer's device.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.schema import FeatureField, FeatureSchema


def part_file_paths(path: str) -> List[str]:
    """Data files of an MR part-file dir in sorted order (names starting
    with ``_`` or ``.`` are sidecars, not data); a plain file is itself."""
    if not os.path.isdir(path):
        return [path]
    out: List[str] = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.startswith(("_", ".")) or not os.path.isfile(full):
            continue
        out.append(full)
    return out


def read_csv_lines(path: str, delim_regex: str = ",") -> List[List[str]]:
    """Read CSV rows, splitting on a regex like the reference's
    ``field.delim.regex``. A directory reads every non-hidden regular file
    in sorted order (``part_file_paths``)."""
    if os.path.isdir(path):
        rows: List[List[str]] = []
        for full in part_file_paths(path):
            rows.extend(read_csv_lines(full, delim_regex))
        return rows
    splitter = re.compile(delim_regex)
    rows = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line:
                rows.append([t.strip() for t in splitter.split(line)])
    return rows


@dataclass
class FieldEncoder:
    """Per-column encoder derived from a :class:`FeatureField` (+ data)."""

    field: FeatureField
    vocab: Optional[Dict[str, int]] = None      # categorical value -> index
    n_bins: int = 0                             # discrete bins (0 if continuous)
    bin_offset: int = 0                         # min-bin shift for bucketed numerics
    continuous: bool = False
    oov_index: Optional[int] = None
    norm_min: float = 0.0                       # fit-time range for [0,1]
    norm_max: float = 1.0                       # normalization (schema else data)

    def encode(self, token: str) -> Tuple[int, float]:
        """Return (bin_id, float_value) for one raw CSV token."""
        f = self.field
        if f.is_categorical:
            idx = self.vocab.get(token)
            if idx is None:
                if self.oov_index is None:
                    raise KeyError(
                        f"unseen categorical value {token!r} for field {f.name}")
                idx = self.oov_index
            return idx, float(idx)
        value = float(token)
        if self.continuous:
            return 0, value
        return int(value // f.bucket_width) - self.bin_offset, value


@dataclass
class EncodedTable:
    """Dense featurized dataset on one device.

    ``binned``/``numeric`` are [N, F] aligned with ``feature_fields`` order;
    continuous fields hold 0 in ``binned`` and their raw value in
    ``numeric`` (binned fields also record their raw value, or the vocab
    index, in ``numeric``).
    """

    binned: torch.Tensor            # [N, F] int32 bin ids
    numeric: torch.Tensor           # [N, F] float32 raw values
    labels: Optional[torch.Tensor]  # [N] int32 class indices (None if no class col)
    ids: List[str]                  # row ids (host side)
    feature_fields: List[FeatureField]
    bins_per_feature: Tuple[int, ...]
    is_continuous: Tuple[bool, ...]
    class_values: List[str]         # label vocabulary, index-aligned
    bin_labels: List[List[str]] = dc_field(default_factory=list)
    # per feature, the wire-format label of each bin id (empty for continuous)
    norm_min: Tuple[float, ...] = ()    # fit-time per-feature range, so train
    norm_max: Tuple[float, ...] = ()    # and test normalize on the SAME scale
    n_rows: int = 0

    def __post_init__(self):
        if not self.n_rows:
            self.n_rows = int(self.binned.shape[0])

    @property
    def device(self) -> torch.device:
        return self.binned.device

    @property
    def n_classes(self) -> int:
        return len(self.class_values)


class Featurizer:
    """Schema-driven row encoder; fit builds vocabularies, transform encodes
    into tables on ``device``."""

    def __init__(self, schema: FeatureSchema, unseen: str = "error",
                 device: DeviceLike = "cuda"):
        if unseen not in ("error", "oov"):
            raise ValueError("unseen must be 'error' or 'oov'")
        self.schema = schema
        self.unseen = unseen
        self.device = resolve_device(device)
        self.encoders: List[FieldEncoder] = []
        self.class_values: List[str] = []
        self._fitted = False

    @property
    def schema_data_dependent(self) -> bool:
        """True when featurization depends on the rows it is fitted on (a
        categorical without a cardinality list, or a bucketed numeric
        without min/max)."""
        fields = list(self.schema.get_feature_fields())
        try:
            fields.append(self.schema.find_class_attr_field())
        except ValueError:
            pass
        for f in fields:
            if f.is_categorical and f.cardinality is None:
                return True
            if f.is_numeric and f.bucket_width is not None and (
                    f.min is None or f.max is None):
                return True
        return False

    # -- fitting -------------------------------------------------------------
    def fit(self, rows: Sequence[Sequence[str]]) -> "Featurizer":
        feature_fields = self.schema.get_feature_fields()
        try:
            class_field = self.schema.find_class_attr_field()
        except ValueError:
            class_field = None

        def numeric_range(f: FeatureField) -> Tuple[float, float]:
            if f.min is not None and f.max is not None:
                lo, hi = float(f.min), float(f.max)
            else:
                vals = [float(row[f.ordinal]) for row in rows]
                lo, hi = (min(vals), max(vals)) if vals else (0.0, 1.0)
            return lo, (hi if hi > lo else lo + 1.0)

        self.encoders = []
        for f in feature_fields:
            if f.is_categorical:
                if f.cardinality is not None:
                    vocab = {v: i for i, v in enumerate(f.cardinality)}
                else:
                    values = sorted({row[f.ordinal] for row in rows})
                    vocab = {v: i for i, v in enumerate(values)}
                n_bins = len(vocab)
                oov = None
                if self.unseen == "oov":
                    oov = n_bins
                    n_bins += 1
                self.encoders.append(FieldEncoder(
                    field=f, vocab=vocab, n_bins=n_bins, oov_index=oov))
            elif f.bucket_width is not None:
                nlo, nhi = numeric_range(f)
                lo = int(nlo // f.bucket_width)
                hi = int(nhi // f.bucket_width)
                self.encoders.append(FieldEncoder(
                    field=f, n_bins=hi - lo + 1, bin_offset=lo,
                    norm_min=nlo, norm_max=nhi))
            else:
                nlo, nhi = numeric_range(f)
                self.encoders.append(FieldEncoder(
                    field=f, continuous=True, norm_min=nlo, norm_max=nhi))

        if class_field is not None:
            if class_field.cardinality is not None:
                self.class_values = list(class_field.cardinality)
            else:
                self.class_values = sorted(
                    {row[class_field.ordinal] for row in rows
                     if len(row) > class_field.ordinal})
        self._fitted = True
        return self

    # -- encoding ------------------------------------------------------------
    def transform_arrays(self, rows: Sequence[Sequence[str]],
                         with_labels: bool = True,
                         row_offset: int = 0):
        """Numpy featurization core: (binned [N,F] i32, numeric [N,F] f32,
        labels [N] i32 or None, ids). ``row_offset`` numbers synthetic ids
        when the schema has no id field."""
        if not self._fitted:
            raise RuntimeError("call fit() (or fit_transform) first")
        n = len(rows)
        nf = len(self.encoders)
        binned = np.zeros((n, nf), dtype=np.int32)
        numeric = np.zeros((n, nf), dtype=np.float32)

        id_field = self.schema.find_id_field()
        try:
            class_field = self.schema.find_class_attr_field()
        except ValueError:
            class_field = None

        ids: List[str] = []
        labels = np.zeros((n,), dtype=np.int32) if (
            with_labels and class_field is not None) else None
        class_index = {v: i for i, v in enumerate(self.class_values)}

        for r, row in enumerate(rows):
            ids.append(row[id_field.ordinal] if id_field is not None
                       else str(row_offset + r))
            for c, enc in enumerate(self.encoders):
                b, v = enc.encode(row[enc.field.ordinal])
                binned[r, c] = b
                numeric[r, c] = v
            if labels is not None:
                if len(row) <= class_field.ordinal:
                    raise ValueError(
                        f"row {r} has no class column (ordinal "
                        f"{class_field.ordinal}); pass with_labels=False for "
                        "unlabeled data")
                token = row[class_field.ordinal]
                if token not in class_index:
                    raise KeyError(f"unseen class value {token!r}")
                labels[r] = class_index[token]
        return binned, numeric, labels, ids

    def table_from_arrays(self, binned, numeric, labels, ids: List[str],
                          device: Optional[DeviceLike] = None
                          ) -> EncodedTable:
        """Wrap featurized arrays, on ``device`` (default: this
        featurizer's), with its schema metadata."""
        dev = self.device if device is None else resolve_device(device)
        return EncodedTable(
            binned=torch.as_tensor(binned, dtype=torch.int32, device=dev),
            numeric=torch.as_tensor(numeric, dtype=torch.float32, device=dev),
            labels=(torch.as_tensor(labels, dtype=torch.int32, device=dev)
                    if labels is not None else None),
            ids=ids,
            feature_fields=[e.field for e in self.encoders],
            bins_per_feature=tuple(e.n_bins for e in self.encoders),
            is_continuous=tuple(e.continuous for e in self.encoders),
            class_values=list(self.class_values),
            bin_labels=[self._bin_labels(e) for e in self.encoders],
            norm_min=tuple(e.norm_min for e in self.encoders),
            norm_max=tuple(e.norm_max for e in self.encoders),
        )

    def transform(self, rows: Sequence[Sequence[str]],
                  with_labels: bool = True,
                  device: Optional[DeviceLike] = None) -> EncodedTable:
        binned, numeric, labels, ids = self.transform_arrays(
            rows, with_labels=with_labels)
        return self.table_from_arrays(binned, numeric, labels, ids,
                                      device=device)

    @staticmethod
    def _bin_labels(enc: FieldEncoder) -> List[str]:
        if enc.continuous:
            return []
        if enc.field.is_categorical:
            labels = [""] * enc.n_bins
            for value, idx in enc.vocab.items():
                labels[idx] = value
            if enc.oov_index is not None:
                labels[enc.oov_index] = "__OOV__"
            return labels
        return [str(b + enc.bin_offset) for b in range(enc.n_bins)]

    def fit_transform(self, rows: Sequence[Sequence[str]],
                      with_labels: bool = True) -> EncodedTable:
        return self.fit(rows).transform(rows, with_labels=with_labels)


def norm_range(table: EncodedTable) -> Tuple[np.ndarray, np.ndarray]:
    """The fit-time (mins, span) per feature as f32, with zero-width spans
    replaced by 1 (the ``normalize_numeric`` rule)."""
    mins = np.asarray(table.norm_min, np.float32)
    span = np.asarray(table.norm_max, np.float32) - mins
    return mins, np.where(span > 0, span, np.float32(1.0))


def normalize_numeric(table: EncodedTable) -> torch.Tensor:
    """Range-normalize numeric features to [0, 1] on the FIT-time scale
    recorded in the table (schema min/max, else the fitted data's range),
    so train and test normalize in the same coordinate system."""
    if not table.norm_min:
        return table.numeric
    mins, span = norm_range(table)
    dev = table.numeric.device
    return ((table.numeric - torch.from_numpy(mins).to(dev))
            / torch.from_numpy(span).to(dev))
