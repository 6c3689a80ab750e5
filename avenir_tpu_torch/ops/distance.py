"""Pairwise mixed-type distance + streaming top-k, in plain PyTorch.

Counterpart of ``avenir_tpu/ops/distance.py`` (``INT_BIG``,
``encode_mixed``, ``finalize_topk``, ``pairwise_topk``, and the full
matrix of SameTypeSimilarity: ``_sq_euclidean``, ``_manhattan``,
``block_distance``, ``_finalize``, ``pairwise_full``): the path the JAX
package leaves to XLA, for what the CUDA kernels do not take (manhattan,
``knn.mode=exact``, k > 128, encoded width > 512).

- numeric attributes arrive range-normalized to [0, 1]; categoricals count
  0/1 mismatches, or ride as one-hot columns scaled by 1/√2 so that squared
  euclidean equals the mismatch count (:func:`encode_mixed`);
- the train axis streams in blocks with a running top-k merge, so the
  [M, N] matrix never materializes;
- selection is in a stable sort's order of the metric in both modes: ties
  go to the lowest train id (``torch.topk`` of the metric alone does not
  promise that; it runs on unique (metric, id) keys). The JAX fast mode
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

from avenir_tpu_torch.ops.infotheory import _sqrt, fma

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
        # codes outside [0, n_cat_bins) encode as all-zero (one_hot drops
        # them): each (row, feature) writes one cell of its own block, 1
        # for a valid code, 0 at the clamped cell for another (a scatter,
        # not a mask: nothing is read back to the host)
        valid = (codes >= 0) & (codes < n_cat_bins)
        offsets = torch.arange(fc, device=cat.device).reshape(1, fc) \
            * n_cat_bins
        oh = torch.zeros((rows, fc * n_cat_bins), dtype=torch.float32,
                         device=cat.device)
        cells = torch.clamp(codes, 0, max(n_cat_bins - 1, 0)) + offsets
        if n_cat_bins:
            oh.scatter_(1, cells, valid.to(torch.float32))
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


_SHIFT = 1 << 32


def order_key(metric: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys that order as (f32 ``metric``, ``ids``) lexicographically
    (ids in [-1, 2³¹)): the float's bits as an int32 that keeps its order
    (negative floats' magnitude bits flipped), times 2³², plus the id."""
    bits = metric.to(torch.float32).contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.long() * _SHIFT + ids.long()


def _keyed_topk(d: torch.Tensor, i: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (metric, id) pairs a row, in that order: ``topk`` of
    :func:`order_key` (``+ 0`` makes a −0 metric equal to +0)."""
    order = torch.topk(order_key(d + 0.0, i), k, dim=1, largest=False,
                       sorted=True).indices
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def stable_merge_topk(best_d: torch.Tensor, best_i: torch.Tensor,
                      cand_d: torch.Tensor, cand_i: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k merge: the k smallest of ``[best | cand]``, in the
    order of a stable sort of the metric. ``best`` holds lower ids than
    ``cand`` (ascending sweep) and each part lists equal metrics in id
    order, so that order is (metric, id).

    The block's own k smallest pairs all lie at or below its k-th smallest
    metric. Where exactly k do, ``torch.topk`` of the metric returns that
    set (in some order); a row with a tie there takes its k by (metric,
    id) keys. Then the two lists of k merge by their keys. Finding the tied
    rows reads one flag back a block: free on the CPU, where this is the
    port's path; on the card it is only the kernels' plain version."""
    kc = min(k, cand_d.shape[1])
    sel_d, cols = torch.topk(cand_d, kc, dim=1, largest=False)
    sel_i = torch.gather(cand_i, 1, cols)
    tied = (cand_d <= sel_d.max(dim=1, keepdim=True).values).sum(dim=1) > kc
    if bool(tied.any()):
        rows = torch.nonzero(tied)[:, 0]
        sel_d[rows], sel_i[rows] = _keyed_topk(cand_d[rows], cand_i[rows],
                                               kc)
    return _keyed_topk(torch.cat([best_d, sel_d], dim=1),
                       torch.cat([best_i, sel_i], dim=1), k)


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


def _fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[M, D] · [N, D]ᵀ → [M, N] f32 as XLA's CPU dot sums it: one fused
    multiply-add a column, in column order, from 0. Each FMA goes through
    float64 (``infotheory.fma``), so every device rounds alike."""
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for c in range(x.shape[1]):
        acc = fma(x[:, c:c + 1], y[:, c].reshape(1, -1), acc)
    return acc


def _fma_sq_norm(a: torch.Tensor) -> torch.Tensor:
    """``[R, D]`` → ``[R]`` sum of squares as XLA compiles
    ``jnp.sum(a * a, axis=1)``: the product contracted into the sum, one
    FMA a column from 0."""
    out = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for c in range(a.shape[1]):
        out = fma(a[:, c], a[:, c], out)
    return out


def _sq_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[M, D] × [N, D] → [M, N] squared euclidean through the product
    expansion ``max(x² + y² − 2x·y, 0)``, each term rounded as the JAX
    package's jitted ``pairwise_full`` rounds it."""
    x2 = _fma_sq_norm(x).reshape(-1, 1)
    y2 = _fma_sq_norm(y).reshape(1, -1)
    return torch.clamp((x2 + y2) - 2.0 * _fma_dot(x, y), min=0.0)


def _manhattan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[M, D] × [N, D] → [M, N] L1, summed a column at a time from 0."""
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for c in range(x.shape[1]):
        acc = acc + (x[:, c:c + 1] - y[:, c].reshape(1, -1)).abs()
    return acc


def _full_metric(x_num, y_num, x_cat, y_cat, n_cat_bins: int,
                 algorithm: str) -> Tuple[torch.Tensor, int]:
    """(the [M, N] distance metric before its ``/ n_attrs``, n_attrs):
    squared euclidean or L1 of the numeric features plus the categorical
    mismatch count."""
    n_num = x_num.shape[1] if x_num is not None else 0
    n_cat = x_cat.shape[1] if x_cat is not None else 0
    if not n_num + n_cat:
        raise ValueError("no features")
    if algorithm not in ("euclidean", "manhattan"):
        raise ValueError(f"unknown distance algorithm {algorithm!r}")
    metric = None
    if n_num:
        metric = (_sq_euclidean if algorithm == "euclidean"
                  else _manhattan)(x_num.to(torch.float32),
                                   y_num.to(torch.float32))
    if n_cat:
        mismatch = categorical_mismatch(x_cat, y_cat, n_cat_bins)
        metric = mismatch if metric is None else metric + mismatch
    return metric, n_num + n_cat


def _inverse(n: int) -> float:
    """f32 ``1 / n``, as XLA turns a division by the constant ``n`` into a
    product with it."""
    return float(np.float32(1.0) / np.float32(n))


def _finalize(metric: torch.Tensor, algorithm: str) -> torch.Tensor:
    """Per-attribute metric → distance: the square root for euclidean,
    correctly rounded on every device."""
    return _sqrt(metric) if algorithm == "euclidean" else metric


def block_distance(x_num, y_num, x_cat=None, y_cat=None, n_cat_bins: int = 0,
                   algorithm: str = "euclidean") -> torch.Tensor:
    """Finalized [M, N] f32 distance in [0, 1] (the per-attribute rms or
    mean, the sifarish convention the reference configures), rounded as
    :func:`pairwise_full` rounds it before its scale."""
    metric, n_attrs = _full_metric(x_num, y_num, x_cat, y_cat, n_cat_bins,
                                   algorithm)
    return _finalize(metric * _inverse(n_attrs), algorithm)


#: most (row, column) cells :func:`pairwise_full` computes at once
_FULL_BLOCK_CELLS = 1 << 25


def pairwise_full(x_num: Optional[torch.Tensor],
                  y_num: Optional[torch.Tensor],
                  x_cat: Optional[torch.Tensor] = None,
                  y_cat: Optional[torch.Tensor] = None,
                  *, algorithm: str = "euclidean", n_cat_bins: int = 0,
                  distance_scale: int = 1000) -> torch.Tensor:
    """Full [M, N] scaled-int distance matrix (the SameTypeSimilarity
    matrix): ``rint(distance · distance_scale)``, int32, on the operands'
    device. The JAX package jits it, and XLA contracts its products into
    FMAs, turns ``/ n_attrs`` into a product with f32 ``1 / n_attrs`` and,
    for manhattan, folds the scale into that constant; each step here is
    rounded as the compiled one. Rows go in blocks of at most
    ``_FULL_BLOCK_CELLS`` cells (each cell's value does not depend on the
    block), so device memory stays bounded."""
    ref = x_num if x_num is not None else x_cat
    other = y_num if y_num is not None else y_cat
    m, n = ref.shape[0], other.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=ref.device)
    rows = max(1, _FULL_BLOCK_CELLS // max(n, 1))
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        metric, n_attrs = _full_metric(
            None if x_num is None else x_num[r0:r1], y_num,
            None if x_cat is None else x_cat[r0:r1], y_cat, n_cat_bins,
            algorithm)
        inv = _inverse(n_attrs)
        if algorithm == "euclidean":
            d = _finalize(metric * inv, algorithm) * float(distance_scale)
        else:
            d = metric * float(np.float32(inv) * np.float32(distance_scale))
        out[r0:r1] = torch.round(d).to(torch.int32)
    return out


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
