"""Quantized distance candidates + exact f32 re-rank, in plain PyTorch.

Counterpart of ``avenir_tpu/ops/quantized.py`` (``_q8``, ``int8_scale``,
``_quantize_int8``, ``_candidate_metric``, ``gathered_candidate_metric``,
``_candidate_topk``, ``exact_candidate_metric``, ``_rerank_metric``,
``finalize_quantized``, ``_rerank_exact``, ``quantized_topk``). The JAX
package computes this outside any Pallas kernel (``lax.dot_general``,
``lax.top_k``, ``lax.sort``), so the port is plain torch ops:

- a low-precision candidate top-k′ (k′ = oversample·k): int8 at ONE
  global symmetric scale ``127 / max(|x|, |y|)`` with the deferred metric
  ``y² − 2·x·y`` in exact int32, or bf16-rounded operands with f32 sums;
- the survivors re-scored in exact f32 (elementwise ``Σ(x−y)²``) and
  sorted by (metric, lowest train id), then scaled to the reference's ints.

Exactness rules the port keeps, so that int8 results equal the JAX
package's byte for byte:

- the int8 cross term is an f32 product of int8 values over at most 1,024
  features at a time: every partial sum is an integer below 2²⁴, exact in
  any summation order (CUDA has no int8 ``matmul``), then summed in int32;
- ``lax.top_k`` is stable (ties keep the lowest id) and ``lax.sort(...,
  num_keys=2)`` is lexicographic; ``torch.topk`` promises no order among
  ties, so every selection here runs on a unique int64 key: the f32
  metric's bits mapped to an order-keeping int32, times 2³², plus the id.
  The candidate SET is then the top-k′ by (metric, id) however the train
  blocks are cut;
- the re-rank metric accumulates ``(x−y)²`` feature by feature as fused
  multiply-adds (each rounded once from float64) and scales by the f32
  reciprocal of the attribute count: the form XLA's CPU backend gives
  the JAX expression up to 32 features.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.ops.distance import (
    INT_BIG, TOPK_BIG, encode_mixed, order_key)
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

#: candidate-metric sentinel (``distance.TOPK_BIG``)
BIG = TOPK_BIG

QDTYPES = ("int8", "bf16")

#: features an exact f32 product of int8 values takes at once: 1,024 ×
#: 127² < 2²⁴
_EXACT_COLS = 1024
#: elements of the largest per-step slab of a scan ([rows, block] metrics
#: or [rows, probe_pad, D] gathered rows): test rows go through in chunks
#: of at most this many elements, which changes no row's result
SLAB = 1 << 27

ArrayLike = Union[np.ndarray, torch.Tensor]


def as_tensor(a: Optional[ArrayLike], dev: torch.device
              ) -> Optional[torch.Tensor]:
    """A numpy array or tensor on ``dev`` (``None`` passes through)."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dev)


def key_ids(key: torch.Tensor) -> torch.Tensor:
    """The ids of :func:`order_key` keys, int32."""
    return (key & 0xFFFFFFFF).to(torch.int32)


def _q8(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric fixed-point int8 of ``v`` at scale ``s``: the one
    quantization expression of the brute-force and IVF scans."""
    return torch.clamp(torch.round(v * s), -127, 127).to(torch.int8)


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The global symmetric scale for a joint magnitude bound."""
    return 127.0 / torch.clamp(amax.to(torch.float32), min=1e-30)


def row_chunks(m: int, per_row: int):
    """Row ranges ``(r0, r1)`` of at most ``SLAB // per_row`` rows."""
    step = max(1, SLAB // max(per_row, 1))
    return [(r0, min(m, r0 + step)) for r0 in range(0, m, step)]


def _abs_max(a: torch.Tensor) -> torch.Tensor:
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=a.device)
    return a.abs().max()


def _quantize_int8(x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both operands at one shared scale (ranking survives only a uniform
    transform)."""
    s = int8_scale(torch.maximum(_abs_max(x), _abs_max(y)))
    return _q8(x, s), _q8(y, s)


def int8_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 operands (``[..., D] @ [..., D, C]``):
    f32 products over 1,024 features at a time, each exact, summed in
    int32."""
    out = None
    for c0 in range(0, a.shape[-1], _EXACT_COLS):
        part = (a[..., c0:c0 + _EXACT_COLS].to(torch.float32)
                @ b[..., c0:c0 + _EXACT_COLS, :].to(torch.float32))
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values held in f32: their products are exact in f32,
    so the f32 product sums them in f32 (bf16 ``matmul`` would round the
    sum to bf16)."""
    return a.to(torch.bfloat16).to(torch.float32)


def _candidate_metric(xq: torch.Tensor, yq_block: torch.Tensor,
                      qdtype: str) -> torch.Tensor:
    """[M, B] deferred low-precision metric ``y² − 2·x·y`` for one train
    block."""
    if qdtype == "int8":
        cross = int8_cross(xq, yq_block.T)
        y2 = (yq_block.to(torch.int32) ** 2).sum(dim=1).reshape(1, -1)
        return (y2 - 2 * cross).to(torch.float32)
    cross = _bf16(xq) @ _bf16(yq_block).T
    y2 = (yq_block * yq_block).sum(dim=1).reshape(1, -1)
    return y2 - 2.0 * cross


def gathered_candidate_metric(xq: torch.Tensor, yq: torch.Tensor,
                              qdtype: str) -> torch.Tensor:
    """[M, D] × [M, C, D] per-query gathered candidates -> [M, C]
    low-precision metric, the batched twin of :func:`_candidate_metric`.
    int8 is exact integer math, so each pair's metric equals the
    brute-force scan's; bf16 carries recall bounds only."""
    if qdtype == "int8":
        cross = int8_cross(yq, xq.unsqueeze(-1)).squeeze(-1)
        y2 = (yq.to(torch.int32) ** 2).sum(dim=2)
        return (y2 - 2 * cross).to(torch.float32)
    cross = (_bf16(yq) @ _bf16(xq).unsqueeze(-1)).squeeze(-1)
    y2 = (yq * yq).sum(dim=2)
    return y2 - 2.0 * cross


def merge_keys(best: Optional[torch.Tensor], cand: torch.Tensor, kprime: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``kprime`` smallest unique keys of ``[best | cand]`` and their
    positions in that concatenation."""
    keys = cand if best is None else torch.cat([best, cand], dim=1)
    keys, pos = torch.topk(keys, min(kprime, keys.shape[1]), dim=1,
                           largest=False, sorted=False)
    return keys, pos


def _candidate_topk(x: torch.Tensor, y: torch.Tensor, kprime: int,
                    block_size: int, qdtype: str) -> torch.Tensor:
    """[M, kprime] candidate train ids, ordered by (quantized metric, id):
    a running top-k′ over train blocks, so the [M, N] slab stays
    block-sized (and test rows go through in chunks of ``SLAB``)."""
    if qdtype == "int8":
        xq, yq = _quantize_int8(x, y)
    else:
        xq, yq = x, y
    n = y.shape[0]
    if n == 0:
        return torch.empty((x.shape[0], 0), dtype=torch.int32,
                           device=x.device)
    block = max(1, min(block_size, n))
    parts = []
    for r0, r1 in row_chunks(x.shape[0], block):
        best = None
        for j0 in range(0, n, block):
            metric = _candidate_metric(xq[r0:r1], yq[j0:j0 + block], qdtype)
            cols = torch.arange(j0, j0 + metric.shape[1], device=x.device)
            best, _ = merge_keys(
                best, order_key(metric, cols.expand_as(metric)), kprime)
        parts.append(key_ids(torch.sort(best, dim=1).values))
    if not parts:
        return torch.empty((0, kprime), dtype=torch.int32, device=x.device)
    return torch.cat(parts)


def exact_candidate_metric(x: torch.Tensor, yc: torch.Tensor, n_attrs: int
                           ) -> torch.Tensor:
    """[M, D] × [M, K', D] gathered candidates -> [M, K'] exact f32
    re-rank metric ``Σ(x−y)²/n_attrs``, summed feature by feature: each
    step ``s + d·d`` rounded once to f32 from float64 (a fused multiply-
    add, the form XLA's CPU backend compiles the JAX sum to), then scaled
    by the f32 reciprocal of ``n_attrs`` (XLA's form of the division)."""
    diff = x.unsqueeze(1) - yc
    acc = torch.zeros(diff.shape[:2], dtype=torch.float32, device=x.device)
    for c in range(diff.shape[2]):
        d = diff[:, :, c].to(torch.float64)
        acc = (acc.to(torch.float64) + d * d).to(torch.float32)
    recip = np.float32(1.0) / np.float32(max(n_attrs, 1))
    return acc * float(recip)


def sort_pairs(metric: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` (metric, id) pairs of a lexicographic sort of each
    row."""
    order = torch.sort(order_key(metric, ids), dim=1).indices[:, :k]
    return torch.gather(metric, 1, order), torch.gather(ids, 1, order)


def _rerank_metric(x: torch.Tensor, y: torch.Tensor, cand_i: torch.Tensor,
                   k: int, n_attrs: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-score of the candidate rows + (metric, row id) sort:
    the PRE-finalize key (metric with ``BIG`` sentinels, ids with
    ``INT_BIG`` sentinels)."""
    found = cand_i >= 0
    yc = y[torch.clamp(cand_i, min=0).long()]              # [M, K', D]
    metric = exact_candidate_metric(x, yc, n_attrs)
    metric = torch.where(found, metric, torch.full_like(metric, BIG))
    idx_key = torch.where(found, cand_i, torch.full_like(cand_i, INT_BIG))
    return sort_pairs(metric, idx_key, k)


def finalize_quantized(metric_s: torch.Tensor, idx_s: torch.Tensor,
                       distance_scale: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted (metric, id) -> (scaled ints, ids), sentinels (INT_BIG, -1)."""
    ok = metric_s < BIG
    scaled = torch.round(torch.sqrt(metric_s) * distance_scale) \
        .to(torch.int32)
    return (torch.where(ok, scaled, torch.full_like(scaled, INT_BIG)),
            torch.where(ok, idx_s, torch.full_like(idx_s, -1)))


def _rerank_exact(x: torch.Tensor, y: torch.Tensor, cand_i: torch.Tensor,
                  k: int, n_attrs: int, distance_scale: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank + finalization (the single-device path)."""
    return finalize_quantized(
        *_rerank_metric(x, y, cand_i, k, n_attrs), distance_scale)


def check_params(qdtype: str, oversample: int) -> None:
    if qdtype not in QDTYPES:
        raise ValueError(f"qdtype {qdtype!r} not one of {QDTYPES}")
    if oversample < 1:
        raise ValueError("oversample must be >= 1")


def quantized_topk(x_num: Optional[ArrayLike], y_num: Optional[ArrayLike],
                   x_cat: Optional[ArrayLike] = None,
                   y_cat: Optional[ArrayLike] = None,
                   *, k: int, n_cat_bins: int = 0,
                   distance_scale: int = 1000, oversample: int = 4,
                   qdtype: str = "int8", block_size: int = 65536,
                   algorithm: str = "euclidean",
                   device: DeviceLike = "cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized candidate pass + exact f32 re-rank, a drop-in for
    ``distance.pairwise_topk`` (euclidean) over normalized features:
    (scaled-int distances [M, min(k, N)] int32, train ids int32) on
    ``device``. ``oversample`` sets k′ = min(oversample·k, N)."""
    if algorithm != "euclidean":
        raise ValueError(
            f"quantized distance supports euclidean only, got {algorithm!r}")
    check_params(qdtype, oversample)
    dev = resolve_device(device)
    x_num, y_num, x_cat, y_cat = (as_tensor(a, dev)
                                  for a in (x_num, y_num, x_cat, y_cat))
    x = encode_mixed(x_num, x_cat, n_cat_bins)
    y = encode_mixed(y_num, y_cat, n_cat_bins)
    n_attrs = ((x_num.shape[1] if x_num is not None else 0) +
               (x_cat.shape[1] if x_cat is not None else 0))
    n = y.shape[0]
    k_eff = min(k, n)
    kprime = min(max(oversample * k_eff, k_eff), n)
    cand_i = _candidate_topk(x, y, kprime, block_size, qdtype)
    return _rerank_exact(x, y, cand_i, k_eff, n_attrs, distance_scale)
