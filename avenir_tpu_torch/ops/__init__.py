"""Device kernels and the plain PyTorch ops around them:

- ``histogram``      — one-hot/segment count reductions (class, feature and
  joint counts, a tree level's node histogram, per-class moments, pair
  counts); the joint counts and node histograms go through K1, the pair
  counts through K4
- ``infotheory``     — entropy, mutual information and the decision
  tree's split statistics over count tensors
- ``distance``       — blocked pairwise distance + top-k in plain PyTorch
  (what the JAX package leaves to XLA), and the full scaled-int matrix of
  SameTypeSimilarity (``pairwise_full``)
- ``cuda_histogram`` — K1, the NB joint-count kernel, and K4, the pair
  contingency-count kernel (``csrc/hist.cu``)
- ``cuda_distance``  — K2, the staged distance top-k (``csrc/topk.cu``),
  and K5, the same over feature-major operands (same source, tpose flag;
  ``pairwise_topk_cuda(layout="tpose")``)
- ``cuda_fused``     — K3, the fused normalize→distance→top-k (same source,
  fused flag)
- ``fold``           — the lane-bucket fold of the KNN experiment kernels
  in plain PyTorch (bucket fold, k extraction, the metrics, the int32 and
  packed folds)
- ``cuda_fold``      — K6-K9, the fold kernels of ``scripts/exp_fold.py``
  and ``scripts/roofline_knn.py`` (``csrc/fold.cu``): indexed fold
  (``acc_fold``), lane minima (``dotmin``), fold without a product
  (``nodot_fold``), fold over feature-major operands (``tpose_fold``); and
  K10-K12, the folds of the kernel-restructure sweeps: the raw product of
  augmented operands (``raw_fold``, same source), int8 operands with int32
  sums (``int8_fold``) and the packed single-accumulator fold
  (``packed_fold``; ``csrc/fold_int8.cu``)
- ``_build``         — builds ``csrc/*.cu`` with nvcc and loads them

Each kernel wrapper takes its plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. There is no stub: a kernel that
cannot build raises from its first launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops.cuda_distance import (  # noqa: F401
    pairwise_topk_cuda, supported)
from avenir_tpu_torch.ops.cuda_fold import (  # noqa: F401
    int8_fold, packed_fold, raw_fold)
from avenir_tpu_torch.ops.cuda_fused import fused_topk_cuda  # noqa: F401
from avenir_tpu_torch.ops.distance import (  # noqa: F401
    INT_BIG, TOPK_BIG, encode_mixed, finalize_topk, fused_topk_plain,
    pairwise_full, pairwise_topk, pairwise_topk_raw)


def fused_topk(x_num_raw: Optional[torch.Tensor],
               y_num: Optional[torch.Tensor],
               x_cat: Optional[torch.Tensor] = None,
               y_cat: Optional[torch.Tensor] = None,
               *, k: int, mins: Optional[torch.Tensor] = None,
               span: Optional[torch.Tensor] = None,
               n_cat_bins: int = 0, distance_scale: int = 1000,
               algorithm: str = "euclidean", block_size: int = 65536,
               mode: str = "fast") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused normalize→distance→top-k over RAW test features: K3 on the
    shapes the kernel family takes, else the plain composition
    (normalize → ``pairwise_topk``). ``mins``/``span`` are the
    per-numeric-feature fit-time range (``span`` sanitized: zero width →
    1); ``None`` means already normalized."""
    n_num = x_num_raw.shape[1] if x_num_raw is not None else 0
    n_cat = x_cat.shape[1] if x_cat is not None else 0
    if supported(algorithm=algorithm, k=k, mode=mode,
                 encoded_width=n_num + n_cat * n_cat_bins):
        return fused_topk_cuda(
            x_num_raw, y_num, x_cat, y_cat, mins=mins, span=span, k=k,
            n_cat_bins=n_cat_bins, distance_scale=distance_scale)
    return fused_topk_plain(
        x_num_raw, mins, span, y_num, x_cat, y_cat, k=k,
        block_size=block_size, algorithm=algorithm, n_cat_bins=n_cat_bins,
        distance_scale=distance_scale, mode=mode)
