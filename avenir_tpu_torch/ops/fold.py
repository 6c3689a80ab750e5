"""The lane-bucket fold of the KNN experiment kernels, in plain PyTorch:
the plain versions of K6-K10 (``csrc/fold.cu``) and K11-K12
(``csrc/fold_int8.cu``).

Counterpart of the fold that ``scripts/exp_fold.py`` (``_acc_kernel``),
``scripts/roofline_knn.py`` (``_dotmin_kernel``, ``_nodot_kernel``,
``_tpose_kernel``) and the kernel-restructure sweeps (``_tag_kernel`` and
``_packed_kernel`` of ``scripts/sweep16*_kernels.py``, ``_tpose_tag_kernel``
and ``_tpose_aug_kernel`` of ``scripts/sweep18_tpose_fold.py``) run on the
TPU. For one test row and a per-column metric:

- **buckets**: there are ``B = n_acc·128``; train column ``col`` falls in
  bucket ``col mod B``. The TPU kernels bucket by
  ``((col mod tile_n) div 128 mod n_acc)·128 + col mod 128``, which is
  ``col mod B`` whenever ``tile_n`` is a multiple of ``B``; the port takes
  ``tile_n`` only to hold it to that rule (:func:`check_tiles`).
- **fold**: each bucket keeps its smallest metric strictly below ``BIG``
  and the lowest column that reaches it; a bucket nothing reaches keeps
  ``(BIG, -1)``. Columns past N do not exist (the TPU launchers pad them
  with ``y² = BIG``, which never wins). Integer metrics (K11, K12) fold
  the same way with ``INT_BIG`` for ``BIG``.
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

from typing import Optional, Tuple

import torch

LANES = 128
BIG = 3.0e38
INT_BIG = 2 ** 30
#: the bucket multipliers the kernels take (``B = n_acc·128`` threads)
N_ACC_CHOICES = (1, 2, 4, 8)
#: K12 alone also takes 16 (2,048 buckets, two a thread)
PACKED_N_ACC_CHOICES = N_ACC_CHOICES + (16,)
MAX_K = LANES
#: the packed fold: ``metric·2048 + tag`` in one int32, ``tag = col div 128``
PACK = 2048
PACKED_MAX_N = PACK * LANES
PACKED_METRIC_LIMIT = 2 ** 18
#: metric elements per row chunk of the plain versions (256 MB of f32)
_CHUNK_ELEMS = 1 << 26


def check_tiles(n_acc: int, tile_n: int,
                choices: Tuple[int, ...] = N_ACC_CHOICES) -> int:
    """The number of buckets ``n_acc·128``; raises unless ``n_acc`` is one
    the kernel takes (``choices``) and ``tile_n`` is a multiple of it (then
    the TPU kernels' bucket of a column is ``col mod B`` and ``tile_n``
    changes nothing in the result)."""
    if n_acc not in choices:
        raise ValueError(f"n_acc must be one of {choices}, got {n_acc}")
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


def _pad_columns(metric: torch.Tensor, buckets: int, big=BIG
                 ) -> torch.Tensor:
    """``[R, N]`` → ``[R, N/B, B]`` with the columns past N at ``big``."""
    r, n = metric.shape
    n_pad = -(-n // buckets) * buckets
    if n_pad != n:
        metric = torch.nn.functional.pad(metric, (0, n_pad - n), value=big)
    return metric.reshape(r, n_pad // buckets, buckets)


def bucket_fold(metric: torch.Tensor, buckets: int, big=BIG
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[R, N]`` metric (f32, or int32 with ``big = INT_BIG``) → per
    bucket (value, column) ``[R, B]``: the smallest value strictly below
    ``big`` with its lowest column, else ``(big, -1)``."""
    v = _pad_columns(metric, buckets, big)
    best = v.min(dim=1).values
    cols = torch.arange(v.shape[1] * buckets, dtype=torch.int32,
                        device=metric.device).reshape(1, -1, buckets)
    idx = torch.where(v == best.unsqueeze(1), cols,
                      torch.tensor(INT_BIG, dtype=torch.int32,
                                   device=metric.device)).min(dim=1).values
    found = best < big
    return (torch.where(found, best, torch.full_like(best, big)),
            torch.where(found, idx, torch.full_like(idx, -1)))


def extract_k(val: torch.Tensor, idx: torch.Tensor, k: int, big=BIG
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k rounds over the ``[R, B]`` buckets → ``[R, 128]`` (value, index),
    slot by slot: the smallest value, the lowest index equal to it, that
    (value, index) entry masked to ``big``; ``(big, -1)`` past k. The
    values keep their type (f32, or int32 with ``big = INT_BIG``)."""
    check_k(k)
    r = val.shape[0]
    out_d = torch.full((r, LANES), big, dtype=val.dtype, device=val.device)
    out_i = torch.full((r, LANES), -1, dtype=torch.int32, device=val.device)
    int_big = torch.tensor(INT_BIG, dtype=torch.int32, device=val.device)
    for slot in range(k):
        min_d = val.min(dim=1, keepdim=True).values
        min_i = torch.where(val == min_d, idx, int_big).min(
            dim=1, keepdim=True).values
        out_d[:, slot] = min_d[:, 0]
        out_i[:, slot] = min_i[:, 0]
        val = torch.where((val == min_d) & (idx == min_i),
                          torch.full_like(val, big), val)
    return out_d, out_i


def _fold_rows(m: int, n: int, metric_rows, k: int, buckets: int, big=BIG
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    outs = [extract_k(*bucket_fold(metric_rows(r0, r1), buckets, big), k,
                      big)
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


def raw_fold_plain(x: torch.Tensor, y: torch.Tensor, *, k: int,
                   n_acc: int = 4, tile_n: int = 4096, tpose: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K10 (``_tag_kernel`` without an epilogue, ``_tpose_aug_kernel``):
    the fold and extraction of K6 over the raw product of augmented
    operands, ``metric = Σ_c bf16(x[r, c])·bf16(y[col, c])``: x ``[M, W]``
    and y ``[N, W]``, or feature-major ``[W, M]`` and ``[W, N]`` with
    ``tpose``. The caller has folded ``y² − 2·x·y`` into the columns, so
    there is no ``y2`` operand. Operands are rounded to bf16 (a no-op on
    operands cast already); the products of two bf16 values are exact in
    f32 and are summed in f32 **in feature order**, c = 0, 1, ..., as the
    CUDA-core body does, bit for bit: with the ``y²`` of the hi and lo
    columns some 2⁸ times the other terms the order shows in the last bits,
    so it is fixed. The tensor-core body sums in its own order and agrees
    within 1e-5 relative, columns differing at near-ties only."""
    buckets = check_tiles(n_acc, tile_n)
    check_k(k)
    if tpose:
        x, y = x.T, y.T
    x, y = round_bf16(x), round_bf16(y)

    def rows(r0, r1):
        acc = x[r0:r1, 0:1] * y[:, 0].reshape(1, -1)
        for c in range(1, x.shape[1]):
            acc = acc + x[r0:r1, c:c + 1] * y[:, c].reshape(1, -1)
        return acc
    return _fold_rows(x.shape[0], y.shape[0], rows, k, buckets)


def _int_cross(xa: torch.Tensor, ya: torch.Tensor):
    """Rows r0:r1 of the int32 product ``xa @ yaᵀ`` of int8 operands,
    through float64, which holds every sum of products exactly (integer
    matrix products have no CUDA path in PyTorch)."""
    y64 = ya.to(torch.float64).T

    def rows(r0, r1):
        return (xa[r0:r1].to(torch.float64) @ y64).to(torch.int32)
    return rows


def int8_fold_plain(xa: torch.Tensor, ya: torch.Tensor,
                    y2: Optional[torch.Tensor] = None, *, k: int,
                    n_acc: int = 4, tile_n: int = 4096
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K11 (``_tag_kernel`` with int32 sums): int8 xa ``[M, W]``, ya
    ``[N, W]`` → ``[M, 128]`` (metric int32, column int32). The metric is
    the int32 product ``Σ_c xa[r, c]·ya[col, c]`` itself, or with ``y2``
    (int32 ``[N]``) the epilogue ``y2[col] − 2·product``; buckets hold
    values strictly below ``INT_BIG``, empty ones ``(INT_BIG, -1)``.
    Integer sums are exact in any order."""
    buckets = check_tiles(n_acc, tile_n)
    check_k(k)
    cross = _int_cross(xa, ya)
    if y2 is None:
        rows = cross
    else:
        def rows(r0, r1):
            return y2.reshape(1, -1) - 2 * cross(r0, r1)
    return _fold_rows(xa.shape[0], ya.shape[0], rows, k, buckets, INT_BIG)


def packed_metric_bound(xa: torch.Tensor, ya: torch.Tensor) -> int:
    """The largest ``|Σ_c xa[r, c]·ya[col, c]|`` the operands' ranges
    allow: ``Σ_c max|xa[:, c]|·max|ya[:, c]|`` (reads the tensors)."""
    if xa.shape[0] == 0 or ya.shape[0] == 0:
        return 0
    ax = xa.to(torch.int32).abs().amax(dim=0)
    ay = ya.to(torch.int32).abs().amax(dim=0)
    return int((ax * ay).sum())


def check_packed(n: int, metric_bound: int) -> None:
    """The packed fold's ranges: the tag ``col div 128`` has 11 bits, and
    ``metric·2048 + tag`` stays inside ±2³⁰ only for ``|metric| < 2¹⁸``."""
    if n > PACKED_MAX_N:
        raise ValueError(f"the packed fold takes at most {PACKED_MAX_N} "
                         f"train rows (an 11-bit tag), got {n}")
    if metric_bound >= PACKED_METRIC_LIMIT:
        raise ValueError(
            f"the operands allow |metric| up to {metric_bound}, not below "
            f"2**18 = {PACKED_METRIC_LIMIT}: metric·2048 + tag could leave "
            "the int32 range of the packed fold")


def packed_fold_plain(xa: torch.Tensor, ya: torch.Tensor, *, k: int,
                      n_acc: int = 4, tile_n: int = 4096,
                      metric_bound: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K12 (``_packed_kernel``): one int32 a bucket, the minimum of
    ``packed = metric·2048 + (col div 128)`` over the bucket's columns,
    ``metric = Σ_c xa[r, c]·ya[col, c]``. A bucket is found where its
    minimum is below ``INT_BIG``; then its metric is ``packed >> 11``
    (arithmetic: centered operands give negative metrics) and its column
    ``(packed & 2047)·128 + bucket mod 128``. k candidates (k ≤ 128) are
    extracted as in :func:`extract_k`. ``n_acc`` may be 16. Raises where N
    exceeds 262,144 or ``metric_bound`` (by default
    :func:`packed_metric_bound` of the operands) reaches 2¹⁸."""
    buckets = check_tiles(n_acc, tile_n, PACKED_N_ACC_CHOICES)
    check_k(k)
    n = ya.shape[0]
    check_packed(n, packed_metric_bound(xa, ya) if metric_bound is None
                 else metric_bound)
    cross = _int_cross(xa, ya)
    tags = torch.arange(n, dtype=torch.int32, device=ya.device) // LANES
    lane = torch.arange(buckets, dtype=torch.int32, device=ya.device) % LANES
    outs = []
    for r0, r1 in _row_chunks(xa.shape[0], n):
        packed = cross(r0, r1) * PACK + tags.reshape(1, -1)
        val = _pad_columns(packed, buckets, INT_BIG).min(dim=1).values
        found = val < INT_BIG
        idx = torch.where(found, (val & (PACK - 1)) * LANES + lane,
                          torch.full_like(val, -1))
        metric = torch.where(found, val >> 11, torch.full_like(val, INT_BIG))
        outs.append(extract_k(metric, idx, k, INT_BIG))
    if not outs:
        raise ValueError("no test rows")
    return (torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs]))
