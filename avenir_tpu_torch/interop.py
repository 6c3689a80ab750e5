"""State carried across from numpy: a trained Naive Bayes model and a
staged (encoded) table, so the same state can drive both this port and
the JAX package.

The model file is the other carrier: each package's ``load_model`` reads
what the other's ``save_model`` wrote.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.models.naive_bayes import BayesModel, model_from_numpy
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.schema import FeatureField


def bayes_model_from_numpy(arrays: dict, device: DeviceLike = "cuda"
                           ) -> BayesModel:
    """``arrays`` holds the six ``BayesModel`` fields (``class_counts``,
    ``post_counts``, ``prior_counts``, ``cont_count``, ``cont_sum``,
    ``cont_sumsq``) as numpy arrays."""
    return model_from_numpy(arrays, device)


def encoded_table_from_numpy(binned: np.ndarray, numeric: np.ndarray,
                             labels: Optional[np.ndarray], ids: List[str],
                             *, feature_fields: Sequence[FeatureField],
                             bins_per_feature: Sequence[int],
                             is_continuous: Sequence[bool],
                             class_values: Sequence[str],
                             bin_labels: Sequence[Sequence[str]] = (),
                             norm_min: Sequence[float] = (),
                             norm_max: Sequence[float] = (),
                             device: DeviceLike = "cuda") -> EncodedTable:
    """The port's :class:`EncodedTable` from host arrays (binned [N, F]
    int32, numeric [N, F] f32, labels [N] int32 or None) and the table's
    metadata."""
    dev = resolve_device(device)
    return EncodedTable(
        binned=torch.tensor(np.asarray(binned, np.int32), device=dev),
        numeric=torch.tensor(np.asarray(numeric, np.float32), device=dev),
        labels=(torch.tensor(np.asarray(labels, np.int32), device=dev)
                if labels is not None else None),
        ids=list(ids),
        feature_fields=list(feature_fields),
        bins_per_feature=tuple(bins_per_feature),
        is_continuous=tuple(is_continuous),
        class_values=list(class_values),
        bin_labels=[list(b) for b in bin_labels],
        norm_min=tuple(norm_min),
        norm_max=tuple(norm_max))
