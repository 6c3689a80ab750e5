"""K2 and K5: the staged distance top-k, over row-major (K2) or
feature-major (K5) operands — the CUDA kernels' wrappers, their plain
PyTorch twins, and the public entry around them.

Replaces ``avenir_tpu/ops/pallas_distance.py`` (``supported``,
``_tile_plan``, ``pairwise_topk_pallas`` with its ``layout=``; the
kernels and their design note are in ``csrc/topk.cu``). K5 is K2 over
operands that arrive transposed, ``xt`` ``[D, M]`` and ``yt`` ``[D, N]``,
and gives K2's result bit for bit. The kernel returns, per test row, the
k smallest ``y² − 2x·y`` with their train ids, ties to the lowest id; the
wrapper adds ``|x|²``, divides by ``n_attrs``, takes the sqrt and scales
to the reference's int, as the JAX package does outside its kernel.

A CPU tensor takes the plain version (f32 metric, stable sort); a CUDA
tensor launches the kernel or raises. The two agree up to the f32
summation order of the dot: ids are equal except where two metrics lie
within a few ulps, and scaled ints within 1.

Two ablations of K2 serve the KNN decomposition
(``scripts/roofline_knn.py``): :func:`topk_nodot_raw` runs K2 with the
product taken out (the metric ``|y2[j] − Σ_d x[r, d]|``, the selection
alone), :func:`topk_sweep_min` runs K2's product sweep with the selection
taken out (each row's smallest metric, no list). Neither is a path of the
CLI.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops.distance import (
    INT_BIG, encode_mixed, row_sq_norm, stable_merge_topk)
from avenir_tpu_torch.ops.fold import row_sum

MAX_K = 128
MAX_ENCODED_WIDTH = 512
#: the list capacity of K2's ablations
MAX_PART_K = 8
#: the plain versions' metric blocks: 8,192 × 65,536 f32, 2 GB
_PLAIN_ROWS, _PLAIN_COLS = 8192, 65536


def supported(*, algorithm: str, k: int, mode: str,
              encoded_width: int = 0) -> bool:
    """Does the kernel family take this job? Euclidean, fast mode,
    1 ≤ k ≤ 128, encoded width ≤ 512 — the range the JAX kernels take."""
    return (algorithm == "euclidean" and mode == "fast" and
            1 <= k <= MAX_K and encoded_width <= MAX_ENCODED_WIDTH)


def topk_raw_plain(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the f32 metric ``y2 − 2·x@yᵀ`` in
    blocks, k smallest by a stable sort (lowest id on ties)."""
    return _plain_topk(
        x.shape[0], y.shape[0], k, x.device,
        lambda r0, r1, c0, c1: y2[c0:c1].reshape(1, -1)
        - 2.0 * (x[r0:r1] @ y[c0:c1].T))


def _plain_topk(m: int, n: int, k: int, device: torch.device, metric
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of ``metric(r0, r1, c0, c1)`` (the ``[r1 − r0,
    c1 − c0]`` block of an ``[m, n]`` metric) per row, by a stable sort
    over blocks: (values [m, k], ids [m, k] int32), lowest id on ties."""
    k = min(k, n)
    out_d = torch.empty((m, k), dtype=torch.float32, device=device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=device)
    for r0 in range(0, m, _PLAIN_ROWS):
        r1 = min(m, r0 + _PLAIN_ROWS)
        best_d = torch.empty((r1 - r0, 0), dtype=torch.float32, device=device)
        best_i = torch.empty((r1 - r0, 0), dtype=torch.int32, device=device)
        for c0 in range(0, n, _PLAIN_COLS):
            c1 = min(n, c0 + _PLAIN_COLS)
            ids = torch.arange(c0, c1, dtype=torch.int32, device=device) \
                .reshape(1, -1).expand(r1 - r0, c1 - c0)
            best_d, best_i = stable_merge_topk(
                best_d, best_i, metric(r0, r1, c0, c1), ids, k)
        out_d[r0:r1] = best_d
        out_i[r0:r1] = best_i
    return out_d, out_i


def topk_nodot_plain(x: torch.Tensor, y2: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's no-product ablation: the k smallest
    ``|y2[j] − Σ_d x[r, d]|`` per test row (the sum in feature order),
    lowest id on ties."""
    s = row_sum(x).reshape(-1, 1)
    return _plain_topk(x.shape[0], y2.shape[0], k, x.device,
                       lambda r0, r1, c0, c1: torch.abs(
                           y2[c0:c1].reshape(1, -1) - s[r0:r1]))


def topk_sweep_plain(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of K2's no-selection ablation: each test row's
    smallest ``y2 − 2·x@yᵀ``, ``[M]``."""
    return torch.cat([(y2.reshape(1, -1) - 2.0 * (x[r0:r0 + _PLAIN_ROWS]
                                                   @ y.T)).min(dim=1).values
                      for r0 in range(0, x.shape[0], _PLAIN_ROWS)])


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


def _launch_topk(x: torch.Tensor, y: Optional[torch.Tensor],
                 y2: torch.Tensor, k: int,
                 mins: Optional[torch.Tensor] = None,
                 span: Optional[torch.Tensor] = None, tpose: bool = False,
                 part: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (K3 when ``mins``/``span`` are given, K5 when ``tpose``,
    an ablation when ``part`` is ``"nodot"`` — y None — or ``"sweep"`` —
    k 1) on the current stream: ``[M, D]`` × ``[N, D]`` (K5: ``[D, M]`` ×
    ``[D, N]``) → (metric [M, k], ids [M, k]). Only the wrappers call it;
    each counts its own launches."""
    dev = _check_operands(x=x, y=y, y2=y2, mins=mins, span=span)
    feat = 0 if tpose else 1
    if x.dim() != 2 or (y is not None and (
            y.dim() != 2 or x.shape[feat] != y.shape[feat])):
        want = "[D, M] and [D, N]" if tpose else "[M, D] and [N, D]"
        raise ValueError(f"x {tuple(x.shape)} and y "
                         f"{None if y is None else tuple(y.shape)} must be "
                         f"{want}")
    d = x.shape[feat]
    m = x.shape[1 - feat]
    n = y2.shape[0] if y is None else y.shape[1 - feat]
    if y2.shape != (n,):
        raise ValueError(f"y2 must be [{n}], got {tuple(y2.shape)}")
    for name, t in (("mins", mins), ("span", span)):
        if t is not None and t.shape != (d,):
            raise ValueError(f"{name} must be [{d}], got {tuple(t.shape)}")
    most = MAX_PART_K if part else MAX_K
    if not 1 <= k <= min(most, n):
        raise ValueError(f"k must be in [1, min({most}, N={n})], got {k}")
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

    if part == "nodot":
        err = lib.avt_topk_nodot(ptr(x), ptr(y2), m, n, d, k, ptr(part_d),
                                 ptr(part_i), ptr(out_d), ptr(out_i),
                                 dev.index, stream)
    elif part == "sweep":
        err = lib.avt_topk_sweep(ptr(x), ptr(y), ptr(y2), m, n, d,
                                 ptr(part_d), ptr(part_i), ptr(out_d),
                                 ptr(out_i), dev.index, stream)
    elif mins is None:
        launch = lib.avt_topk_tpose if tpose else lib.avt_topk_staged
        err = launch(ptr(x), ptr(y), ptr(y2), m, n, d, k, ptr(part_d),
                     ptr(part_i), ptr(out_d), ptr(out_i), dev.index, stream)
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


def topk_nodot_raw(x: torch.Tensor, y2: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 without its product: (metric ``[M, k]``, ids ``[M, k]``) of the
    k ≤ 8 smallest ``|y2[j] − Σ_d x[r, d]|``, through K2's lists, splits
    and merge; see :func:`topk_nodot_plain`."""
    if x.device.type == "cpu":
        return topk_nodot_plain(x, y2, k)
    out = _launch_topk(x, None, y2, k, part="nodot")
    if x.shape[0]:
        topk_nodot_raw.launches += 1
    return out


topk_nodot_raw.launches = 0


def topk_sweep_min(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor
                   ) -> torch.Tensor:
    """K2 without its selection: each test row's smallest ``y2 − 2·x·y``,
    ``[M]``, from K2's product sweep; see :func:`topk_sweep_plain`."""
    if x.device.type == "cpu":
        return topk_sweep_plain(x, y, y2)
    out_d, _ = _launch_topk(x, y, y2, 1, part="sweep")
    if x.shape[0]:
        topk_sweep_min.launches += 1
    return out_d[:, 0]


topk_sweep_min.launches = 0


def topk_raw_tpose_plain(xt: torch.Tensor, yt: torch.Tensor,
                         y2: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: K2's plain version on the operands transposed
    back to row-major."""
    return topk_raw_plain(xt.T.contiguous(), yt.T.contiguous(), y2, k)


def topk_raw_tpose(xt: torch.Tensor, yt: torch.Tensor, y2: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper: normalized encoded test ``[D, M]`` × train ``[D, N]``
    (``y2 = |y|²``, ``[N]``) → (metric ``[M, k]`` f32, ids ``[M, k]``
    int32), ``k ≤ N``; bit-identical to ``topk_raw`` on ``xt.T``,
    ``yt.T``."""
    if xt.device.type == "cpu":
        return topk_raw_tpose_plain(xt, yt, y2, k)
    out = _launch_topk(xt, yt, y2, k, tpose=True)
    if xt.shape[1]:
        topk_raw_tpose.launches += 1
    return out


topk_raw_tpose.launches = 0


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
                       distance_scale: int = 1000, layout: str = "lane"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.distance.pairwise_topk`` (euclidean, fast mode)
    through K2: (scaled-int distances [M, min(k, N)], train ids).
    ``layout="tpose"`` transposes the encoded operands to feature-major and
    goes through K5 instead, with the same result bit for bit — the
    counterpart of ``pairwise_topk_pallas(layout=)``."""
    if layout not in ("lane", "tpose"):
        raise ValueError(f"layout must be 'lane' or 'tpose', got {layout!r}")
    x = encode_mixed(x_num, x_cat, n_cat_bins)
    y = encode_mixed(y_num, y_cat, n_cat_bins)
    n_attrs = ((x_num.shape[1] if x_num is not None else 0) +
               (x_cat.shape[1] if x_cat is not None else 0))
    k_eff = min(k, y.shape[0])
    if k_eff == 0:
        empty = torch.empty((x.shape[0], 0), dtype=torch.int32,
                            device=x.device)
        return empty, empty.clone()
    if layout == "tpose":
        raw_d, raw_i = topk_raw_tpose(x.T.contiguous(), y.T.contiguous(),
                                      row_sq_norm(y), k_eff)
    else:
        raw_d, raw_i = topk_raw(x, y, row_sq_norm(y), k_eff)
    return finalize(raw_d, raw_i, row_sq_norm(x), n_attrs, distance_scale)
