"""K1 (the Naive Bayes joint counts) and K4 (the pair contingency counts):
the CUDA kernels' wrappers and their plain PyTorch twins.

Replaces ``avenir_tpu/ops/pallas_histogram.py``'s ``_cfb_kernel`` and
``_pair_kernel`` (the kernels and their design notes are in
``csrc/hist.cu``), with the JAX functions' contracts:

- K1: ``[N, F]`` bin ids × ``[N]`` labels (optional ``[N]`` weights) →
  ``[C, F, B]`` f32 joint counts; ids outside ``[0, B)`` and labels
  outside ``[0, C)`` drop out; N = 0 or F = 0 give zeros.
- K4: ``[N]`` × ``[N]`` ids (optional ``[N]`` weights, folded into the
  ``a`` side) → ``[n_a, n_b]`` f32 contingency counts; ids outside their
  range drop out; N = 0 gives zeros.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from avenir_tpu_torch.ops import _build


def class_feature_bin_counts_plain(bins: torch.Tensor, labels: torch.Tensor,
                                   n_classes: int, n_bins: int,
                                   weights: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain version: a bincount over the masked combined ids
    ``f·C·B + label·B + bin`` (integer counts, exact), or an index_add of
    the weights in float64, rounded once to f32."""
    n, n_f = bins.shape
    dev = bins.device
    cells = n_f * n_classes * n_bins
    bins = bins.long()
    labels = labels.long().reshape(n, 1)
    valid = ((bins >= 0) & (bins < n_bins)
             & (labels >= 0) & (labels < n_classes))
    f_off = torch.arange(n_f, device=dev).reshape(1, n_f) * (n_classes
                                                             * n_bins)
    flat = (f_off + labels * n_bins + bins)[valid]
    if weights is None:
        counts = torch.bincount(flat, minlength=cells).to(torch.float32)
    else:
        w = weights.to(torch.float64).reshape(n, 1).expand(n, n_f)[valid]
        counts = torch.zeros(cells, dtype=torch.float64, device=dev)
        counts = counts.index_add_(0, flat, w).to(torch.float32)
    return counts.reshape(n_f, n_classes, n_bins).permute(1, 0, 2) \
        .contiguous()


def _check_ids(ref: torch.Tensor, **tensors: Optional[torch.Tensor]) -> None:
    """Each operand on ``ref``'s device, of its dtype (int32 ids, f32
    weights) and contiguous."""
    for name, t in tensors.items():
        if t is None:
            continue
        dtype = torch.float32 if name == "weights" else torch.int32
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def class_feature_bin_counts(bins: torch.Tensor, labels: torch.Tensor,
                             n_classes: int, n_bins: int,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``[N, F]`` int32 bins × ``[N]`` int32 labels → ``[C, F, B]`` f32."""
    if bins.dim() != 2:
        raise ValueError(f"bins must be [N, F], got shape {tuple(bins.shape)}")
    if bins.device.type == "cpu":
        return class_feature_bin_counts_plain(bins, labels, n_classes,
                                              n_bins, weights)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    n, n_f = bins.shape
    if labels.shape != (n,):
        raise ValueError(f"labels must be [{n}], got {tuple(labels.shape)}")
    _check_ids(bins, bins=bins, labels=labels, weights=weights)
    if weights is not None and weights.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {tuple(weights.shape)}")
    if n_classes < 1 or n_bins < 1:
        raise ValueError(f"n_classes and n_bins must be >= 1, got "
                         f"{n_classes}, {n_bins}")
    if n == 0 or n_f == 0:
        return torch.zeros((n_classes, n_f, n_bins), dtype=torch.float32,
                           device=bins.device)
    lib = _build.load_library()
    out = torch.empty((n_f, n_classes * n_bins),
                      dtype=torch.int32 if weights is None else torch.float32,
                      device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    err = lib.avt_cfb_counts(
        bins.data_ptr(), labels.data_ptr(),
        None if weights is None else weights.data_ptr(),
        n, n_f, n_classes, n_bins, out.data_ptr(), bins.device.index,
        stream)
    _build.check(err, "class_feature_bin_counts kernel launch")
    class_feature_bin_counts.launches += 1
    return out.to(torch.float32).reshape(n_f, n_classes, n_bins) \
        .permute(1, 0, 2).contiguous()


class_feature_bin_counts.launches = 0


def pair_counts_plain(a: torch.Tensor, b: torch.Tensor, n_a: int, n_b: int,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: a bincount over the masked combined ids
    ``a·n_b + b`` (integer counts, exact), or an index_add of the weights
    in float64, rounded once to f32."""
    a, b = a.long(), b.long()
    valid = (a >= 0) & (a < n_a) & (b >= 0) & (b < n_b)
    flat = (a * n_b + b)[valid]
    if weights is None:
        counts = torch.bincount(flat, minlength=n_a * n_b).to(torch.float32)
    else:
        counts = torch.zeros(n_a * n_b, dtype=torch.float64, device=a.device)
        counts = counts.index_add_(0, flat, weights.to(torch.float64)[valid]) \
            .to(torch.float32)
    return counts.reshape(n_a, n_b)


def pair_counts(a: torch.Tensor, b: torch.Tensor, n_a: int, n_b: int,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[N]`` int32 × ``[N]`` int32 ids → ``[n_a, n_b]`` f32 counts."""
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError(f"a and b must be [N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return pair_counts_plain(a, b, n_a, n_b, weights)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    n = a.shape[0]
    _check_ids(a, a=a, b=b, weights=weights)
    if weights is not None and weights.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {tuple(weights.shape)}")
    if n_a < 1 or n_b < 1 or n_a * n_b >= 2 ** 31:
        raise ValueError(f"n_a and n_b must be >= 1 with fewer than 2**31 "
                         f"cells, got {n_a}, {n_b}")
    if n == 0:
        return torch.zeros((n_a, n_b), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    out = torch.empty((n_a, n_b),
                      dtype=torch.int32 if weights is None else torch.float32,
                      device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.avt_pair_counts(
        a.data_ptr(), b.data_ptr(),
        None if weights is None else weights.data_ptr(), n, n_a, n_b,
        out.data_ptr(), a.device.index, stream)
    _build.check(err, "pair_counts kernel launch")
    pair_counts.launches += 1
    return out.to(torch.float32)


pair_counts.launches = 0
