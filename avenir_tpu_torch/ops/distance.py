"""Pairwise mixed-type distance + streaming top-k, in plain PyTorch.

Counterpart of ``avenir_tpu/ops/distance.py`` (``INT_BIG``,
``encode_mixed``, ``finalize_topk``, ``pairwise_topk``): the path the JAX
package leaves to XLA, for what the CUDA kernels do not take (manhattan,
``knn.mode=exact``, k > 128, encoded width > 512).

- numeric attributes arrive range-normalized to [0, 1]; categoricals count
  0/1 mismatches, or ride as one-hot columns scaled by 1/√2 so that squared
  euclidean equals the mismatch count (:func:`encode_mixed`);
- the train axis streams in blocks with a running top-k merge, so the
  [M, N] matrix never materializes;
- selection is a STABLE sort of the metric in both modes: ties go to the
  lowest train id (``torch.topk`` does not promise that). The JAX fast mode
  selects with ``lax.approx_min_k`` and a bf16 cross term; here the cross
  term stays f32 and the selection exact, which passes the same gates.

Modes: ``fast`` defers the per-test-row constants (``y² − 2x·y``, the
``|x|²``, clamp and ``/n_attrs`` re-attached in :func:`finalize_topk`);
``exact`` is the legacy ``max(x² + y² − 2x·y, 0) / n_attrs`` form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: "no neighbor" scaled-int sentinel (shared across the kernel family)
INT_BIG = 2 ** 30
#: "no neighbor" sentinel of the PRE-finalize metric
TOPK_BIG = 3.4e38

_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))


def encode_mixed(num: Optional[torch.Tensor], cat: Optional[torch.Tensor],
                 n_cat_bins: int) -> torch.Tensor:
    """Numeric features followed by 1/√2-scaled one-hot categoricals, so
    plain squared euclidean equals numeric² + mismatch count."""
    parts = []
    if num is not None and num.shape[1]:
        parts.append(num.to(torch.float32))
    if cat is not None and cat.shape[1]:
        rows, fc = cat.shape
        codes = cat.long()
        # codes outside [0, n_cat_bins) encode as all-zero (one_hot drops them)
        valid = (codes >= 0) & (codes < n_cat_bins)
        offsets = torch.arange(fc, device=cat.device).reshape(1, fc) \
            * n_cat_bins
        oh = torch.zeros((rows, fc * n_cat_bins), dtype=torch.float32,
                         device=cat.device)
        row_idx = torch.arange(rows, device=cat.device).reshape(rows, 1) \
            .expand(rows, fc)
        oh[row_idx[valid], (codes + offsets)[valid]] = 1.0
        parts.append(oh * _INV_SQRT2)
    if not parts:
        raise ValueError("no features")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def row_sq_norm(a: torch.Tensor) -> torch.Tensor:
    """``[R, D]`` → ``[R]`` sum of squares, accumulated column by column in
    order: elementwise ops only, so a row's value does not depend on how
    many rows come with it (chunked and whole calls agree bit for bit)."""
    out = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for c in range(a.shape[1]):
        col = a[:, c]
        out = out + col * col
    return out


def stable_merge_topk(best_d: torch.Tensor, best_i: torch.Tensor,
                      cand_d: torch.Tensor, cand_i: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k merge: the k smallest of ``[best | cand]`` by a stable
    sort. ``best`` holds lower ids than ``cand`` (ascending sweep), so
    equal metrics keep the lowest id."""
    all_d = torch.cat([best_d, cand_d], dim=1)
    all_i = torch.cat([best_i, cand_i], dim=1)
    order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
    return (torch.gather(all_d, 1, order), torch.gather(all_i, 1, order))


def categorical_mismatch(x_cat: torch.Tensor, y_cat: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """[M, Fc] × [N, Fc] codes → [M, N] f32 mismatch counts (codes outside
    [0, n_bins) never match, as with the one-hot contraction)."""
    ok = (x_cat >= 0) & (x_cat < n_bins)
    match = (x_cat[:, None, :] == y_cat[None, :, :]) & ok[:, None, :]
    return float(x_cat.shape[1]) - match.sum(dim=2).to(torch.float32)


def _block_metric_deferred(x_num, y_num, x_cat, y_cat, n_cat_bins):
    parts = []
    if x_num is not None and x_num.shape[1]:
        y2 = row_sq_norm(y_num).reshape(1, -1)
        parts.append(y2 - 2.0 * (x_num @ y_num.T))
    if x_cat is not None and x_cat.shape[1]:
        parts.append(categorical_mismatch(x_cat, y_cat, n_cat_bins))
    if not parts:
        raise ValueError("no features")
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def _block_metric(x_num, y_num, x_cat, y_cat, n_cat_bins, algorithm):
    n_num = x_num.shape[1] if x_num is not None else 0
    n_cat = x_cat.shape[1] if x_cat is not None else 0
    n_attrs = max(n_num + n_cat, 1)
    m = x_num.shape[0] if n_num else x_cat.shape[0]
    n = y_num.shape[0] if n_num else y_cat.shape[0]
    dev = x_num.device if n_num else x_cat.device
    acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
    if algorithm == "euclidean":
        if n_num:
            x2 = (x_num * x_num).sum(dim=1, keepdim=True)
            y2 = (y_num * y_num).sum(dim=1).reshape(1, -1)
            acc = acc + torch.clamp(x2 + y2 - 2.0 * (x_num @ y_num.T),
                                    min=0.0)
    elif algorithm == "manhattan":
        if n_num:
            acc = acc + (x_num[:, None, :] - y_num[None, :, :]).abs().sum(-1)
    else:
        raise ValueError(f"unknown distance algorithm {algorithm!r}")
    if n_cat:
        acc = acc + categorical_mismatch(x_cat, y_cat, n_cat_bins)
    return acc / n_attrs


def pairwise_topk_raw(x_num: Optional[torch.Tensor],
                      y_num: Optional[torch.Tensor],
                      x_cat: Optional[torch.Tensor] = None,
                      y_cat: Optional[torch.Tensor] = None,
                      *, k: int, block_size: int = 65536,
                      algorithm: str = "euclidean", n_cat_bins: int = 0,
                      mode: str = "fast"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PRE-finalize streaming top-k: (metric [M, min(k, N)] f32, train ids
    [M, min(k, N)] int32, −1 where nothing was found)."""
    defer = mode == "fast" and algorithm == "euclidean"
    n = y_num.shape[0] if y_num is not None else y_cat.shape[0]
    m = x_num.shape[0] if x_num is not None else x_cat.shape[0]
    dev = x_num.device if x_num is not None else x_cat.device
    k_eff = min(k, n)
    best_d = torch.full((m, k_eff), TOPK_BIG, dtype=torch.float32,
                        device=dev)
    best_i = torch.full((m, k_eff), -1, dtype=torch.int32, device=dev)
    block = max(1, block_size)
    for j0 in range(0, n, block):
        j1 = min(n, j0 + block)
        yb_num = y_num[j0:j1] if y_num is not None else None
        yb_cat = y_cat[j0:j1] if y_cat is not None else None
        if defer:
            metric = _block_metric_deferred(x_num, yb_num, x_cat, yb_cat,
                                            n_cat_bins)
        else:
            metric = _block_metric(x_num, yb_num, x_cat, yb_cat, n_cat_bins,
                                   algorithm)
        ids = torch.arange(j0, j1, dtype=torch.int32, device=dev) \
            .reshape(1, -1).expand(m, j1 - j0)
        best_d, best_i = stable_merge_topk(best_d, best_i, metric, ids,
                                           k_eff)
    return best_d, best_i


def finalize_topk(best_d: torch.Tensor, best_i: torch.Tensor,
                  x_num: Optional[torch.Tensor],
                  x_cat: Optional[torch.Tensor],
                  *, algorithm: str, distance_scale: int, mode: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-finalize (metric, id) pairs → the reference's scaled-int
    distances and the (INT_BIG, −1) sentinels."""
    found = best_d < TOPK_BIG
    if mode == "fast" and algorithm == "euclidean":
        n_num = x_num.shape[1] if x_num is not None else 0
        n_cat = x_cat.shape[1] if x_cat is not None else 0
        if n_num:
            best_d = best_d + row_sq_norm(x_num).reshape(-1, 1)
        best_d = torch.clamp(best_d, min=0.0) / max(n_num + n_cat, 1)
    dist = torch.clamp(best_d, min=0.0)
    if algorithm == "euclidean":
        dist = torch.sqrt(dist)
    scaled = torch.where(found,
                         torch.round(dist * distance_scale).to(torch.int32),
                         torch.full_like(best_i, INT_BIG))
    return scaled, torch.where(found, best_i, torch.full_like(best_i, -1))


def pairwise_topk(x_num: Optional[torch.Tensor],
                  y_num: Optional[torch.Tensor],
                  x_cat: Optional[torch.Tensor] = None,
                  y_cat: Optional[torch.Tensor] = None,
                  *, k: int, block_size: int = 65536,
                  algorithm: str = "euclidean", n_cat_bins: int = 0,
                  distance_scale: int = 1000, mode: str = "fast"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest train rows for every test row: (scaled-int distances
    [M, min(k, N)] int32, train ids [M, min(k, N)] int32)."""
    best_d, best_i = pairwise_topk_raw(
        x_num, y_num, x_cat, y_cat, k=k, block_size=block_size,
        algorithm=algorithm, n_cat_bins=n_cat_bins, mode=mode)
    return finalize_topk(best_d, best_i, x_num, x_cat, algorithm=algorithm,
                         distance_scale=distance_scale, mode=mode)


def fused_topk_plain(x_num_raw: Optional[torch.Tensor],
                     mins: Optional[torch.Tensor],
                     span: Optional[torch.Tensor],
                     y_num: Optional[torch.Tensor],
                     x_cat: Optional[torch.Tensor] = None,
                     y_cat: Optional[torch.Tensor] = None,
                     **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize → :func:`pairwise_topk` (the JAX ``fused_topk_xla``): the
    normalize is the same IEEE elementwise expression as the host path, so
    this equals staged normalize → ``pairwise_topk`` bit for bit."""
    x_num = x_num_raw
    if x_num_raw is not None and mins is not None and span is not None:
        x_num = (x_num_raw - mins.reshape(1, -1)) / span.reshape(1, -1)
    return pairwise_topk(x_num, y_num, x_cat, y_cat, **kwargs)
