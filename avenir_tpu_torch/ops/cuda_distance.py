"""K2: the staged distance top-k — the CUDA kernel's wrapper, its plain
PyTorch twin, and the public entry around them.

Replaces ``avenir_tpu/ops/pallas_distance.py`` (``supported``,
``_tile_plan``, ``pairwise_topk_pallas``; the kernel and its design note
are in ``csrc/topk.cu``). The kernel returns, per test row, the k smallest
``y² − 2x·y`` with their train ids, ties to the lowest id; the wrapper
adds ``|x|²``, divides by ``n_attrs``, takes the sqrt and scales to the
reference's int, as the JAX package does outside its kernel.

A CPU tensor takes the plain version (f32 metric, stable sort); a CUDA
tensor launches the kernel or raises. The two agree up to the f32
summation order of the dot: ids are equal except where two metrics lie
within a few ulps, and scaled ints within 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops.distance import (
    INT_BIG, encode_mixed, row_sq_norm, stable_merge_topk)

MAX_K = 128
MAX_ENCODED_WIDTH = 512


def supported(*, algorithm: str, k: int, mode: str,
              encoded_width: int = 0) -> bool:
    """Does the kernel family take this job? Euclidean, fast mode,
    1 ≤ k ≤ 128, encoded width ≤ 512 — the range the JAX kernels take."""
    return (algorithm == "euclidean" and mode == "fast" and
            1 <= k <= MAX_K and encoded_width <= MAX_ENCODED_WIDTH)


def topk_raw_plain(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                   k: int, block_rows: int = 8192, block_cols: int = 65536
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the f32 metric ``y2 − 2·x@yᵀ`` in
    blocks, k smallest by a stable sort (lowest id on ties)."""
    m, n = x.shape[0], y.shape[0]
    k = min(k, n)
    out_d = torch.empty((m, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=x.device)
    for r0 in range(0, m, block_rows):
        xb = x[r0:r0 + block_rows]
        mb = xb.shape[0]
        best_d = torch.empty((mb, 0), dtype=torch.float32, device=x.device)
        best_i = torch.empty((mb, 0), dtype=torch.int32, device=x.device)
        for c0 in range(0, n, block_cols):
            c1 = min(n, c0 + block_cols)
            metric = y2[c0:c1].reshape(1, -1) - 2.0 * (xb @ y[c0:c1].T)
            ids = torch.arange(c0, c1, dtype=torch.int32, device=x.device) \
                .reshape(1, -1).expand(mb, c1 - c0)
            best_d, best_i = stable_merge_topk(best_d, best_i, metric, ids, k)
        out_d[r0:r0 + mb] = best_d
        out_i[r0:r0 + mb] = best_i
    return out_d, out_i


def _check_operands(**tensors: Optional[torch.Tensor]) -> torch.device:
    """Every operand f32, contiguous and on one CUDA device; returns it."""
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, others on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _launch_topk(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                 k: int, mins: Optional[torch.Tensor] = None,
                 span: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (or K3 when ``mins``/``span`` are given) on the current
    stream: ``[M, D]`` × ``[N, D]`` → (metric [M, k], ids [M, k]). Only
    the wrappers ``topk_raw`` and ``fused_topk_raw`` call it; each counts
    its own launches."""
    dev = _check_operands(x=x, y=y, y2=y2, mins=mins, span=span)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must be "
                         "[M, D] and [N, D]")
    m, d = x.shape
    n = y.shape[0]
    if y2.shape != (n,):
        raise ValueError(f"y2 must be [{n}], got {tuple(y2.shape)}")
    for name, t in (("mins", mins), ("span", span)):
        if t is not None and t.shape != (d,):
            raise ValueError(f"{name} must be [{d}], got {tuple(t.shape)}")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"k must be in [1, min({MAX_K}, N={n})], got {k}")
    if not 1 <= d <= MAX_ENCODED_WIDTH:
        raise ValueError(f"encoded width must be in [1, {MAX_ENCODED_WIDTH}]"
                         f", got {d}")
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return out_d, out_i
    lib = _build.load_library()
    splits = lib.avt_topk_splits(m, n, d, dev.index)
    part_d = part_i = None
    if splits > 1:
        part_d = torch.empty((splits, m, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, m, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    if mins is None:
        err = lib.avt_topk_staged(ptr(x), ptr(y), ptr(y2), m, n, d, k,
                                  ptr(part_d), ptr(part_i), ptr(out_d),
                                  ptr(out_i), dev.index, stream)
    else:
        err = lib.avt_topk_fused(ptr(x), ptr(y), ptr(y2), ptr(mins),
                                 ptr(span), m, n, d, k, ptr(part_d),
                                 ptr(part_i), ptr(out_d), ptr(out_i),
                                 dev.index, stream)
    _build.check(err, "topk kernel launch")
    return out_d, out_i


def topk_raw(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: normalized encoded test ``[M, D]`` × train ``[N, D]``
    (``y2 = |y|²``, ``[N]``) → (metric ``[M, k]`` f32, ids ``[M, k]``
    int32), ``k ≤ N``."""
    if x.device.type == "cpu":
        return topk_raw_plain(x, y, y2, k)
    out = _launch_topk(x, y, y2, k)
    if x.shape[0]:
        topk_raw.launches += 1
    return out


topk_raw.launches = 0


def finalize(raw_d: torch.Tensor, raw_i: torch.Tensor, x2: torch.Tensor,
             n_attrs: int, distance_scale: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel output → (scaled-int distances, ids): ``rint(sqrt(max(d +
    |x|², 0) / n_attrs) · scale)``, (INT_BIG, −1) where nothing was found."""
    found = raw_i >= 0
    sq = torch.clamp(raw_d + x2.reshape(-1, 1), min=0.0) / max(n_attrs, 1)
    scaled = torch.round(torch.sqrt(sq) * distance_scale).to(torch.int32)
    return (torch.where(found, scaled, torch.full_like(raw_i, INT_BIG)),
            torch.where(found, raw_i, torch.full_like(raw_i, -1)))


def pairwise_topk_cuda(x_num: Optional[torch.Tensor],
                       y_num: Optional[torch.Tensor],
                       x_cat: Optional[torch.Tensor] = None,
                       y_cat: Optional[torch.Tensor] = None,
                       *, k: int, n_cat_bins: int = 0,
                       distance_scale: int = 1000
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.distance.pairwise_topk`` (euclidean, fast mode)
    through K2: (scaled-int distances [M, min(k, N)], train ids)."""
    x = encode_mixed(x_num, x_cat, n_cat_bins)
    y = encode_mixed(y_num, y_cat, n_cat_bins)
    n_attrs = ((x_num.shape[1] if x_num is not None else 0) +
               (x_cat.shape[1] if x_cat is not None else 0))
    k_eff = min(k, y.shape[0])
    if k_eff == 0:
        empty = torch.empty((x.shape[0], 0), dtype=torch.int32,
                            device=x.device)
        return empty, empty.clone()
    raw_d, raw_i = topk_raw(x, y, row_sq_norm(y), k_eff)
    return finalize(raw_d, raw_i, row_sq_norm(x), n_attrs, distance_scale)
