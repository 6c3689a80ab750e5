"""K3: the fused normalize → distance → top-k — the CUDA kernel's
wrapper, its plain PyTorch twin, and the public entry around them.

Replaces ``avenir_tpu/ops/pallas_fused.py`` (``_encoded_scales``,
``fused_topk_pallas``). The test rows arrive RAW (fit scale); the kernel
(``csrc/topk.cu`` with its fused flag) applies ``(x − mins) / span`` to
each test tile as it loads it, with the same IEEE f32 ops the host
normalize uses, so the result is bit-identical to host-normalize → K2.
The train rows arrive normalized (staged once). ``|x|²`` comes from the
same normalize expression, computed by the wrapper.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops.cuda_distance import (
    finalize, _launch_topk, topk_raw_plain)
from avenir_tpu_torch.ops.distance import encode_mixed, row_sq_norm


def encoded_scales(mins: Optional[torch.Tensor], span: Optional[torch.Tensor],
                   n_num: int, cat_width: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-numeric-feature scales padded with the identity (min 0, span
    1) for the one-hot columns; ``None`` scales mean already normalized."""
    if mins is None or span is None:
        mins_n = torch.zeros(n_num, dtype=torch.float32, device=device)
        span_n = torch.ones(n_num, dtype=torch.float32, device=device)
    else:
        mins_n = mins.to(device=device, dtype=torch.float32).reshape(-1)
        span_n = span.to(device=device, dtype=torch.float32).reshape(-1)
    if cat_width:
        mins_n = torch.cat([mins_n, torch.zeros(cat_width,
                                                dtype=torch.float32,
                                                device=device)])
        span_n = torch.cat([span_n, torch.ones(cat_width,
                                               dtype=torch.float32,
                                               device=device)])
    return mins_n, span_n


def normalize(x_raw: torch.Tensor, mins: torch.Tensor, span: torch.Tensor
              ) -> torch.Tensor:
    return (x_raw - mins.reshape(1, -1)) / span.reshape(1, -1)


def fused_topk_raw_plain(x_raw: torch.Tensor, y: torch.Tensor,
                         y2: torch.Tensor, mins: torch.Tensor,
                         span: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: normalize, then K2's plain version."""
    return topk_raw_plain(normalize(x_raw, mins, span), y, y2, k)


def fused_topk_raw(x_raw: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                   mins: torch.Tensor, span: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: RAW encoded test ``[M, D]`` with full-width scales
    ``[D]`` × normalized train ``[N, D]`` → (metric ``[M, k]``, ids)."""
    if x_raw.device.type == "cpu":
        return fused_topk_raw_plain(x_raw, y, y2, mins, span, k)
    out = _launch_topk(x_raw, y, y2, k, mins=mins, span=span)
    if x_raw.shape[0]:
        fused_topk_raw.launches += 1
    return out


fused_topk_raw.launches = 0


def fused_topk_cuda(x_num: Optional[torch.Tensor],
                    y_num: Optional[torch.Tensor],
                    x_cat: Optional[torch.Tensor] = None,
                    y_cat: Optional[torch.Tensor] = None,
                    *, mins: Optional[torch.Tensor] = None,
                    span: Optional[torch.Tensor] = None,
                    k: int, n_cat_bins: int = 0,
                    distance_scale: int = 1000
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pairwise_topk_cuda`` on RAW test features: ``x_num`` on the fit
    scale, ``mins``/``span`` per numeric feature (``span`` sanitized:
    zero width → 1). Bit-identical to host-normalizing ``x_num`` and
    calling ``pairwise_topk_cuda``."""
    x = encode_mixed(x_num, x_cat, n_cat_bins)
    y = encode_mixed(y_num, y_cat, n_cat_bins)
    n_num = x_num.shape[1] if x_num is not None else 0
    n_attrs = n_num + (x_cat.shape[1] if x_cat is not None else 0)
    mins_e, span_e = encoded_scales(mins, span, n_num, x.shape[1] - n_num,
                                    x.device)
    k_eff = min(k, y.shape[0])
    if k_eff == 0:
        empty = torch.empty((x.shape[0], 0), dtype=torch.int32,
                            device=x.device)
        return empty, empty.clone()
    raw_d, raw_i = fused_topk_raw(x, y, row_sq_norm(y), mins_e, span_e,
                                  k_eff)
    x2 = row_sq_norm(normalize(x, mins_e, span_e))
    return finalize(raw_d, raw_i, x2, n_attrs, distance_scale)
