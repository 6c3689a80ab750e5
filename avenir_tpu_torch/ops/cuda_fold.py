"""K6-K9: the lane-bucket fold kernels of the KNN experiments — the CUDA
kernels' wrappers (``csrc/fold.cu``) over the plain versions in
:mod:`avenir_tpu_torch.ops.fold`.

- :func:`acc_fold` (K6) replaces ``_acc_kernel`` (``scripts/exp_fold.py``);
- :func:`dotmin` (K7) ``_dotmin_kernel``, :func:`nodot_fold` (K8)
  ``_nodot_kernel`` and :func:`tpose_fold` (K9) ``_tpose_kernel``
  (``scripts/roofline_knn.py``).

Each returns the raw ``[M, 128]`` outputs of its TPU kernel. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises. Kernel
and plain version agree up to the f32 summation order of the product:
metrics within a few ulps, and columns equal except where two candidates'
metrics lie that close. K8 sums in the same order as its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops import fold as F
from avenir_tpu_torch.ops.cuda_distance import _check_operands

#: widest rows the kernels take: K6/K7 stage 1,024 train rows of d floats
#: in shared memory
MAX_D = 48


def _check_rows(x: torch.Tensor, feat: int, y2: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> Tuple[int, int, int]:
    """(m, n, d) of test x and train y (features on axis ``feat`` of
    both), with ``y2`` ``[n]``; n comes from y2 where y is not read."""
    if x.dim() != 2 or y2.dim() != 1 or (y is not None and (
            y.dim() != 2 or y.shape[feat] != x.shape[feat])):
        want = "[D, M] and [D, N]" if feat == 0 else "[M, D] and [N, D]"
        raise ValueError(f"operands must be {want} with y2 [N], got "
                         f"{tuple(x.shape)}, "
                         f"{None if y is None else tuple(y.shape)} and "
                         f"{tuple(y2.shape)}")
    d, m = x.shape[feat], x.shape[1 - feat]
    n = y2.shape[0] if y is None else y.shape[1 - feat]
    if y2.shape[0] != n:
        raise ValueError(f"y2 must be [{n}], got {tuple(y2.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"width must be in [1, {MAX_D}], got {d}")
    if n < 1:
        raise ValueError("no train columns")
    return m, n, d


def _outputs(m: int, dev: torch.device, indexed: bool = True):
    out_d = torch.empty((m, F.LANES), dtype=torch.float32, device=dev)
    out_i = (torch.empty((m, F.LANES), dtype=torch.int32, device=dev)
             if indexed else None)
    return out_d, out_i


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def acc_fold(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, *, k: int,
             n_acc: int = 4, tile_n: int = 4096, use_bf16: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: x ``[M, D]``, y ``[N, D]``, ``y2 = |y|²`` of the
    unrounded y → ``[M, 128]`` (metric f32, column int32), k extracted
    from ``n_acc·128`` buckets; see :func:`fold.acc_fold_plain`."""
    if x.device.type == "cpu":
        return F.acc_fold_plain(x, y, y2, k=k, n_acc=n_acc, tile_n=tile_n,
                                use_bf16=use_bf16)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(x=x, y=y, y2=y2)
    m, n, d = _check_rows(x, 1, y2, y)
    out_d, out_i = _outputs(m, dev)
    if m:
        _build.check(_build.load_library().avt_fold_acc(
            x.data_ptr(), y.data_ptr(), y2.data_ptr(), m, n, d, k,
            n_acc, int(use_bf16), out_d.data_ptr(), out_i.data_ptr(),
            dev.index, _stream(dev)), "K6 fold launch")
        acc_fold.launches += 1
    return out_d, out_i


acc_fold.launches = 0


def dotmin(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor
           ) -> torch.Tensor:
    """K7 wrapper: ``[M, 128]`` lane minima of ``y2 − 2·bf16(x)@bf16(y)ᵀ``;
    see :func:`fold.dotmin_plain`."""
    if x.device.type == "cpu":
        return F.dotmin_plain(x, y, y2)
    dev = _check_operands(x=x, y=y, y2=y2)
    m, n, d = _check_rows(x, 1, y2, y)
    out_d, _ = _outputs(m, dev, indexed=False)
    if m:
        _build.check(_build.load_library().avt_fold_dotmin(
            x.data_ptr(), y.data_ptr(), y2.data_ptr(), m, n, d,
            out_d.data_ptr(), dev.index, _stream(dev)), "K7 fold launch")
        dotmin.launches += 1
    return out_d


dotmin.launches = 0


def nodot_fold(x: torch.Tensor, y2: torch.Tensor, *, k: int, n_acc: int = 4,
               tile_n: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 wrapper: the fold of ``y2[col] + Σ_d x[r, d]``; see
    :func:`fold.nodot_fold_plain`."""
    if x.device.type == "cpu":
        return F.nodot_fold_plain(x, y2, k=k, n_acc=n_acc, tile_n=tile_n)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(x=x, y2=y2)
    m, n, d = _check_rows(x, 1, y2)
    out_d, out_i = _outputs(m, dev)
    if m:
        _build.check(_build.load_library().avt_fold_nodot(
            x.data_ptr(), y2.data_ptr(), m, n, d, k, n_acc,
            out_d.data_ptr(), out_i.data_ptr(), dev.index, _stream(dev)),
            "K8 fold launch")
        nodot_fold.launches += 1
    return out_d, out_i


nodot_fold.launches = 0


def tpose_fold(xt: torch.Tensor, yt: torch.Tensor, y2: torch.Tensor, *,
               k: int, n_acc: int = 4, tile_n: int = 4096
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 wrapper: K6 with bf16 rounding over feature-major xt ``[D, M]``,
    yt ``[D, N]``; see :func:`fold.tpose_fold_plain`."""
    if xt.device.type == "cpu":
        return F.tpose_fold_plain(xt, yt, y2, k=k, n_acc=n_acc, tile_n=tile_n)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(xt=xt, yt=yt, y2=y2)
    m, n, d = _check_rows(xt, 0, y2, yt)
    out_d, out_i = _outputs(m, dev)
    if m:
        _build.check(_build.load_library().avt_fold_tpose(
            xt.data_ptr(), yt.data_ptr(), y2.data_ptr(), m, n, d, k,
            n_acc, out_d.data_ptr(), out_i.data_ptr(), dev.index,
            _stream(dev)), "K9 fold launch")
        tpose_fold.launches += 1
    return out_d, out_i


tpose_fold.launches = 0
