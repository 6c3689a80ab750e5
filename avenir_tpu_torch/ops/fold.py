"""The lane-bucket fold of the KNN experiment kernels, in plain PyTorch:
the plain versions of K6-K9 (``csrc/fold.cu``).

Counterpart of the fold that ``scripts/exp_fold.py`` (``_acc_kernel``) and
``scripts/roofline_knn.py`` (``_dotmin_kernel``, ``_nodot_kernel``,
``_tpose_kernel``) run on the TPU. For one test row and a per-column metric:

- **buckets**: there are ``B = n_acc·128``; train column ``col`` falls in
  bucket ``col mod B``. The TPU kernels bucket by
  ``((col mod tile_n) div 128 mod n_acc)·128 + col mod 128``, which is
  ``col mod B`` whenever ``tile_n`` is a multiple of ``B``; the port takes
  ``tile_n`` only to hold it to that rule (:func:`check_tiles`).
- **fold**: each bucket keeps its smallest metric strictly below ``BIG``
  and the lowest column that reaches it; a bucket nothing reaches keeps
  ``(BIG, -1)``. Columns past N do not exist (the TPU launchers pad them
  with ``y² = BIG``, which never wins).
- **extraction** (:func:`extract_k`): k rounds, each taking the smallest
  value, the lowest index among the entries equal to it, and masking
  exactly that (value, index) entry. Slots past k hold ``(BIG, -1)``.

Each function returns the raw ``[M, 128]`` outputs of its TPU kernel
(metric f32, and column int32 where the kernel is indexed) and works over
row chunks, so that an 8,192 × 65,536 metric never materializes whole.
Ties go to the lowest column explicitly, never through ``torch.min``'s
index.
"""

from __future__ import annotations

from typing import Tuple

import torch

LANES = 128
BIG = 3.0e38
INT_BIG = 2 ** 30
#: the bucket multipliers the kernels take (``B = n_acc·128`` threads)
N_ACC_CHOICES = (1, 2, 4, 8)
MAX_K = LANES
#: metric elements per row chunk of the plain versions (256 MB of f32)
_CHUNK_ELEMS = 1 << 26


def check_tiles(n_acc: int, tile_n: int) -> int:
    """The number of buckets ``n_acc·128``; raises unless ``n_acc`` is one
    the kernels take and ``tile_n`` is a multiple of it (then the TPU
    kernels' bucket of a column is ``col mod B`` and ``tile_n`` changes
    nothing in the result)."""
    if n_acc not in N_ACC_CHOICES:
        raise ValueError(f"n_acc must be one of {N_ACC_CHOICES}, got {n_acc}")
    buckets = n_acc * LANES
    if tile_n <= 0 or tile_n % buckets:
        raise ValueError(
            f"tile_n ({tile_n}) must be a positive multiple of n_acc·128 "
            f"({buckets}): only then does a train column's bucket not depend "
            "on the tile")
    return buckets


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) → f32."""
    return a.to(torch.bfloat16).to(torch.float32)


def row_sum(a: torch.Tensor) -> torch.Tensor:
    """``[R, D]`` → ``[R]``, summed column by column in order, as K8 does."""
    out = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for c in range(a.shape[1]):
        out = out + a[:, c]
    return out


def _row_chunks(m: int, n: int):
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    for r0 in range(0, m, rows):
        yield r0, min(m, r0 + rows)


def _pad_columns(metric: torch.Tensor, buckets: int) -> torch.Tensor:
    """``[R, N]`` → ``[R, N/B, B]`` with the columns past N at ``BIG``."""
    r, n = metric.shape
    n_pad = -(-n // buckets) * buckets
    if n_pad != n:
        metric = torch.nn.functional.pad(metric, (0, n_pad - n), value=BIG)
    return metric.reshape(r, n_pad // buckets, buckets)


def bucket_fold(metric: torch.Tensor, buckets: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[R, N]`` metric → per bucket (value, column) ``[R, B]``: the
    smallest value strictly below ``BIG`` with its lowest column, else
    ``(BIG, -1)``."""
    v = _pad_columns(metric, buckets)
    best = v.min(dim=1).values
    cols = torch.arange(v.shape[1] * buckets, dtype=torch.int32,
                        device=metric.device).reshape(1, -1, buckets)
    idx = torch.where(v == best.unsqueeze(1), cols,
                      torch.tensor(INT_BIG, dtype=torch.int32,
                                   device=metric.device)).min(dim=1).values
    found = best < BIG
    return (torch.where(found, best, torch.full_like(best, BIG)),
            torch.where(found, idx, torch.full_like(idx, -1)))


def extract_k(val: torch.Tensor, idx: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k rounds over the ``[R, B]`` buckets → ``[R, 128]`` (value, index),
    slot by slot: the smallest value, the lowest index equal to it, that
    (value, index) entry masked to ``BIG``; ``(BIG, -1)`` past k."""
    check_k(k)
    r = val.shape[0]
    out_d = torch.full((r, LANES), BIG, dtype=torch.float32,
                       device=val.device)
    out_i = torch.full((r, LANES), -1, dtype=torch.int32, device=val.device)
    int_big = torch.tensor(INT_BIG, dtype=torch.int32, device=val.device)
    for slot in range(k):
        min_d = val.min(dim=1, keepdim=True).values
        min_i = torch.where(val == min_d, idx, int_big).min(
            dim=1, keepdim=True).values
        out_d[:, slot] = min_d[:, 0]
        out_i[:, slot] = min_i[:, 0]
        val = torch.where((val == min_d) & (idx == min_i),
                          torch.full_like(val, BIG), val)
    return out_d, out_i


def _fold_rows(m: int, n: int, metric_rows, k: int, buckets: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    outs = [extract_k(*bucket_fold(metric_rows(r0, r1), buckets), k)
            for r0, r1 in _row_chunks(m, n)]
    if not outs:
        raise ValueError("no test rows")
    return (torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs]))


def _dot_metric(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor):
    """Rows r0:r1 of ``y2 − 2·x@yᵀ`` (f32 operands as given)."""
    def rows(r0, r1):
        return y2.reshape(1, -1) - 2.0 * (x[r0:r1] @ y.T)
    return rows


def acc_fold_plain(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, *,
                   k: int, n_acc: int = 4, tile_n: int = 4096,
                   use_bf16: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K6 (``_acc_kernel``): x ``[M, D]``, y ``[N, D]``, ``y2 = |y|²``
    of the unrounded y → ``[M, 128]`` (metric, column) of the fold over
    ``n_acc·128`` buckets, k extracted. With ``use_bf16`` x and y are
    rounded to bf16 before the product, which is summed in f32."""
    buckets = check_tiles(n_acc, tile_n)
    check_k(k)
    if use_bf16:
        x, y = round_bf16(x), round_bf16(y)
    return _fold_rows(x.shape[0], y.shape[0], _dot_metric(x, y, y2), k,
                      buckets)


def dotmin_plain(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor
                 ) -> torch.Tensor:
    """Plain K7 (``_dotmin_kernel``): ``[M, 128]`` minima of
    ``y2 − 2·bf16(x)@bf16(y)ᵀ`` over the columns ``col mod 128 = l``,
    ``BIG`` where a lane has none; values only."""
    x, y = round_bf16(x), round_bf16(y)
    metric_rows = _dot_metric(x, y, y2)
    outs = []
    for r0, r1 in _row_chunks(x.shape[0], y.shape[0]):
        v = _pad_columns(metric_rows(r0, r1), LANES).min(dim=1).values
        outs.append(torch.clamp(v, max=BIG))
    return torch.cat(outs)


def nodot_fold_plain(x: torch.Tensor, y2: torch.Tensor, *, k: int,
                     n_acc: int = 4, tile_n: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K8 (``_nodot_kernel``): the fold and extraction of K6 over the
    metric ``y2[col] + Σ_d x[r, d]`` (f32, no product, no rounding)."""
    buckets = check_tiles(n_acc, tile_n)
    check_k(k)
    s = row_sum(x).reshape(-1, 1)

    def rows(r0, r1):
        return y2.reshape(1, -1) + s[r0:r1]
    return _fold_rows(x.shape[0], y2.shape[0], rows, k, buckets)


def tpose_fold_plain(xt: torch.Tensor, yt: torch.Tensor, y2: torch.Tensor,
                     *, k: int, n_acc: int = 4, tile_n: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K9 (``_tpose_kernel``): K6 with bf16 rounding over
    feature-major operands xt ``[D, M]``, yt ``[D, N]``."""
    return acc_fold_plain(xt.T, yt.T, y2, k=k, n_acc=n_acc, tile_n=tile_n,
                          use_bf16=True)
