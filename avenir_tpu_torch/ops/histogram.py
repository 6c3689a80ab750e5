"""One-hot / segment count reductions — the MR "shuffle" as tensor ops.

Counterpart of ``avenir_tpu/ops/histogram.py`` (``class_counts``,
``feature_bin_counts``, ``class_feature_bin_counts``,
``per_class_moments``). Every counting MR job of the reference is a
map-side emit of small count keys + a keyed shuffle + a reduce-side sum;
here each is one reduction over the row axis.

Ids outside their range drop out (the one-hot behavior), and integer
counts are exact. ``class_feature_bin_counts`` — the Naive Bayes joint
counts — goes through K1 (``ops/cuda_histogram.py``), whose wrapper takes
its plain version for CPU tensors and launches the kernel for CUDA ones.
All functions take an optional per-row ``weights`` vector.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops import cuda_histogram


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``ids`` over a new last axis; ids outside [0, n)
    give an all-zero row (``jax.nn.one_hot`` semantics)."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    oh = torch.nn.functional.one_hot(torch.where(valid, ids, 0), n)
    return oh.to(torch.float32) * valid.unsqueeze(-1).to(torch.float32)


def class_counts(labels: torch.Tensor, n_classes: int,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] int labels -> [C] counts (the class-prior reduction)."""
    oh = _one_hot(labels, n_classes)
    if weights is not None:
        oh = oh * weights.reshape(-1, 1)
    return oh.sum(dim=0)


def feature_bin_counts(bins: torch.Tensor, n_bins: int,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[N, F] bin ids -> [F, B] counts (the feature-prior reduction)."""
    oh = _one_hot(bins, n_bins)                                 # [N, F, B]
    if weights is not None:
        oh = oh * weights.reshape(-1, 1, 1)
    return oh.sum(dim=0)


def class_feature_bin_counts(bins: torch.Tensor, labels: torch.Tensor,
                             n_classes: int, n_bins: int,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """[N, F] bins × [N] labels -> [C, F, B] joint counts: the whole
    BayesianDistribution train job (mapper emit (classVal, ord, bin)→1 +
    reducer sum), through K1."""
    return cuda_histogram.class_feature_bin_counts(
        bins.to(torch.int32).contiguous(), labels.to(torch.int32).contiguous(),
        n_classes, n_bins,
        None if weights is None
        else weights.to(torch.float32).contiguous())


def per_class_moments(values: torch.Tensor, labels: torch.Tensor,
                      n_classes: int,
                      weights: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(class, feature) count / sum / sum-of-squares for continuous
    features — the Gaussian sufficient statistics the reference accumulates
    at BayesianDistribution.java:283-285. Returns ([C,F], [C,F], [C,F])."""
    oh = _one_hot(labels, n_classes)                            # [N, C]
    if weights is not None:
        oh = oh * weights.reshape(-1, 1)
    values = values.to(torch.float32)
    count = oh.T @ torch.ones_like(values)
    vsum = oh.T @ values
    vsq = oh.T @ (values * values)
    return count, vsum, vsq
