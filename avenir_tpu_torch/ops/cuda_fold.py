"""K6-K12: the lane-bucket fold kernels of the KNN experiments — the CUDA
kernels' wrappers (``csrc/fold.cu``, ``csrc/fold_int8.cu``) over the plain
versions in :mod:`avenir_tpu_torch.ops.fold`.

- :func:`acc_fold` (K6) replaces ``_acc_kernel`` (``scripts/exp_fold.py``);
  it also runs ``_topk_kernel`` under other tiles
  (``scripts/sweep11_vmem.py``) and ``tagfold`` of
  ``scripts/sweep16b_kernels.py``, the same function;
- :func:`dotmin` (K7) ``_dotmin_kernel``, :func:`nodot_fold` (K8)
  ``_nodot_kernel`` and :func:`tpose_fold` (K9) ``_tpose_kernel``
  (``scripts/roofline_knn.py``); K9 also runs ``_tpose_kernel`` of
  ``scripts/sweep14_tpose.py`` and ``_tpose_tag_kernel`` of
  ``scripts/sweep18_tpose_fold.py``;
- :func:`raw_fold` (K10) replaces the f32 uses of ``_tag_kernel`` without
  an epilogue (``augbf16``, ``augv2``) and ``_tpose_aug_kernel``;
- :func:`int8_fold` (K11) the int32 uses of ``_tag_kernel`` (``int8epi``,
  ``int8aug``, ``int8rr``), :func:`packed_fold` (K12) ``_packed_kernel``
  (``int8pk``, ``int8pk8``, ``int8pk16``).

Each returns the raw ``[M, 128]`` outputs of its TPU kernel. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises. Kernel
and plain version agree up to the f32 summation order of the product:
metrics within a few ulps, and columns equal except where two candidates'
metrics lie that close. K8 does one f32 add a pair, as its plain version
does, and equals it bit for bit; K11 and K12 are integer and equal theirs
bit for bit.

**Bodies.** K6 with bf16 rounding, K7, K9 and K10 run on the tensor-core
body of ``csrc/fold.cu`` (namespace ``tc``: the train rows packed to bf16
with y2 in the padding of k, a block of ``TC_ROWS`` test rows ×
``TC_SLICE`` buckets, the fold on the accumulator fragments, the indexed
folds' slices merged through an ``[M, B]`` scratch and an extraction
kernel); K9 and K10's ``tpose_aug`` read their feature-major operands
through the strides of :func:`tc_strides`. K10 is the body's raw mode: A
carries ``bf16(x)`` in place of ``−2·bf16(x)`` and the packed rows no y2
(:func:`tc_operands` with ``y2`` None), so the accumulator is the raw
product; it sums in the tensor cores' order, where its plain version sums
in feature order. K8 runs that body's tile with the product replaced by
an add, over y2 padded with +inf. K11 and K12 run the same tile on the
int8 tensor cores (``csrc/fold_int8.cu``, namespace ``tc``: the train rows
packed to 32 bytes, the exact int32 cross term folded on the accumulator
fragments, columns past N masked in the sweep's last round;
:func:`int8_tc_plan`). The CUDA-core body (one thread per bucket) serves
K6 with f32 operands, and stays reachable as ``_launch_acc``,
``_launch_dotmin``, ``_launch_nodot``, ``_launch_tpose``, ``_launch_raw``,
``_launch_int8`` and ``_launch_packed`` with ``body "cuda_cores"`` so
that ``chip_smoke.py`` can time it beside the new body; no public path
selects it.

**Padding.** The TPU launchers pad the train rows to a multiple of
``tile_n``. With a ``y2`` epilogue the pad's ``y2`` is ``BIG`` and never
wins. Without one the pad is part of the operands: ``augv2`` and
``tpose_aug`` put ``BIG`` in the ``y2hi`` column; ``augbf16`` pads with zero
rows, whose metric 0 would win; the int8 forms encode 126s, a metric of
about 144,018 that is below ``INT_BIG`` and so is *found*, with a column
≥ N, in a bucket no real column reaches. Here columns past N do not exist:
the wrappers take the N real rows, and a bucket no real column reaches is
empty, ``(BIG, -1)`` or ``(INT_BIG, -1)``. The two agree wherever N is a
multiple of ``tile_n``, and on the buckets that real columns reach.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def _as_f32(*operands: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """bf16 operands (cast by the caller, as the sweeps' host-cast arms
    do) widened to f32, exactly; others as they are."""
    return tuple(t.to(torch.float32) if t.dtype == torch.bfloat16 else t
                 for t in operands)


def _outputs(m: int, dev: torch.device, indexed: bool = True,
             dtype: torch.dtype = torch.float32):
    out_d = torch.empty((m, F.LANES), dtype=dtype, device=dev)
    out_i = (torch.empty((m, F.LANES), dtype=torch.int32, device=dev)
             if indexed else None)
    return out_d, out_i


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


#: K6 (bf16 on), K7, K9 and K10 on the tensor cores, K8 on their tile
#: (``csrc/fold.cu``, namespace ``tc``): a block owns TC_ROWS test rows and
#: TC_SLICE buckets, and the train rows are packed first to bf16 rows of
#: ``tc_width(d)`` values (K8: y2 padded to the same ``n_pad`` entries)
TC_ROWS = 128
TC_SLICE = 64
#: K7's buckets on the tensor cores: four a lane, a thread holding all
#: four of its lanes and writing their minimum
TC_DOTMIN_BUCKETS = 512
#: the packed y2 of a pad row, as bf16 bits: the largest finite bf16, so
#: that a pad column's metric lies above BIG
TC_PAD_Y2 = 0x7F7F
#: the kernel's order of the eight 32-bit words (two values each) of a
#: packed row's k-step: lane tig's B fragment, words tig and tig + 4, is
#: then one 8-byte load
TC_WORD_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)
#: the C entries' ``body`` argument: the CUDA-core body of PRs 3-4, one
#: thread per bucket; the tensor-core body (K6, K7, K9, K10); and its tile
#: with the product replaced by an add (K8, which has no product)
BODIES = {"cuda_cores": 0, "tensor": 1, "tile": 1}


def tc_steps(d: int) -> int:
    """k-steps of 16 of the tensor-core product: d features and the three
    bf16 parts of y2."""
    return -(-(d + 3) // 16)


def tc_width(d: int) -> int:
    """Values a packed train row holds."""
    return 16 * tc_steps(d)


def tc_ahead(d: int) -> int:
    """Steps whose train rows are loaded ahead of the one folded: two at
    one k-step, one at more."""
    return 2 if tc_steps(d) == 1 else 1


def tc_sweep_steps(n: int, d: int, buckets: int) -> int:
    """Steps of ``buckets`` columns the sweep runs: n rounded up to whole
    rounds of ``tc_ahead(d) + 1`` steps."""
    rounds = tc_ahead(d) + 1
    return -(-n // (buckets * rounds)) * rounds


def tc_padded_rows(n: int, d: int, buckets: int) -> int:
    """Packed rows: the sweep's steps, and the steps its last loads reach
    past them."""
    return (tc_sweep_steps(n, d, buckets) + tc_ahead(d)) * buckets


class TcPlan(NamedTuple):
    """One tensor-core launch: the packed rows ``[n_pad, width]`` bf16, the
    sweep's grid (row tiles, bucket slices), and K6's scratch ``[m,
    buckets]`` of (row, bucket) pairs (metric f32, column int32); None
    for K7, whose sweep writes the lane minima."""
    buckets: int
    width: int
    n_pad: int
    grid: Tuple[int, int]
    scratch: Optional[Tuple[int, int]]


def tc_plan(m: int, n: int, d: int, buckets: int,
            indexed: bool = True) -> TcPlan:
    """Shapes of a tensor-core launch over m test rows, n train rows of d
    features and ``buckets`` buckets: K6, K9 and K10 (``indexed``,
    ``n_acc·128`` buckets) or K7 (``TC_DOTMIN_BUCKETS``)."""
    if buckets < F.LANES or buckets % TC_SLICE:
        raise ValueError(f"buckets must be a multiple of {TC_SLICE}, at "
                         f"least {F.LANES}, got {buckets}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"width must be in [1, {MAX_D}], got {d}")
    if m < 1 or n < 1:
        raise ValueError(f"no rows: m={m}, n={n}")
    if not indexed and buckets != TC_DOTMIN_BUCKETS:
        raise ValueError(f"K7 folds {TC_DOTMIN_BUCKETS} buckets, got "
                         f"{buckets}")
    return TcPlan(buckets, tc_width(d), tc_padded_rows(n, d, buckets),
                  (-(-m // TC_ROWS), buckets // TC_SLICE),
                  (m, buckets) if indexed else None)


def tc_strides(rows: int, d: int, tpose: bool) -> Tuple[int, int]:
    """(row, feature) strides, in elements, through which the tensor-core
    body reads an operand of ``rows`` rows of d features: element (i, c)
    at ``i·row + c·feature``; ``(d, 1)`` row-major ``[rows, d]``, ``(1,
    rows)`` feature-major ``[d, rows]`` (K9)."""
    return (1, rows) if tpose else (d, 1)


def _strided_rows(t: torch.Tensor, tpose: bool) -> torch.Tensor:
    """The contiguous operand ``t`` (``[rows, d]``, or ``[d, rows]`` with
    ``tpose``) as ``[rows, d]``, read through :func:`tc_strides`."""
    rows, d = (t.shape[1], t.shape[0]) if tpose else t.shape
    return t.as_strided((rows, d), tc_strides(rows, d, tpose),
                        t.storage_offset())


def tc_operands(x: torch.Tensor, y: torch.Tensor,
                y2: Optional[torch.Tensor], buckets: int, tpose: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core body's operands, as f32 tensors of bf16 values in
    logical order: A ``[m, W]`` = (−2·bf16(x) | 1 1 1 | 0) and the packed
    train rows ``[n_pad, W]`` = (bf16(y) | y2 split exactly into three bf16
    parts | 0), a pad row 0 but for the largest finite bf16 against the
    first 1. ``A @ Yᵀ`` summed exactly is ``y2 − 2·bf16(x)·bf16(y)``; a pad
    column's is above BIG. With ``y2`` None, K10's raw mode: A = (bf16(x) |
    1 1 1 | 0) against (bf16(y) | 0 0 0 | 0), so that ``A @ Yᵀ`` is the raw
    product ``Σ_c bf16(x)·bf16(y)`` and the pad rows are as above. x ``[m,
    d]`` and y ``[n, d]`` are contiguous, or with ``tpose`` feature-major
    ``[d, m]`` and ``[d, n]`` (K9, K10's ``tpose_aug``), read through
    :func:`tc_strides` as the kernel reads them. :func:`tc_packed` gives
    the kernel's layout."""
    x, y = _strided_rows(x, tpose), _strided_rows(y, tpose)
    m, d = x.shape
    n = y.shape[0]
    w = tc_width(d)
    a = torch.zeros((m, w), dtype=torch.float32, device=x.device)
    a[:, :d] = F.round_bf16(x) if y2 is None else -2.0 * F.round_bf16(x)
    a[:, d:d + 3] = 1.0
    yp = torch.zeros((tc_padded_rows(n, d, buckets), w), dtype=torch.float32,
                     device=y.device)
    yp[:n, :d] = F.round_bf16(y)
    if y2 is not None:
        hi = F.round_bf16(y2)
        rest = y2 - hi
        mid = F.round_bf16(rest)
        yp[:n, d] = hi
        yp[:n, d + 1] = mid
        yp[:n, d + 2] = F.round_bf16(rest - mid)
    pad = torch.tensor([TC_PAD_Y2], dtype=torch.int16).view(torch.bfloat16)
    yp[n:, d] = pad.to(torch.float32).item()
    return a, yp


def tc_packed(rows: torch.Tensor) -> torch.Tensor:
    """Packed rows of :func:`tc_operands` in the kernel's memory layout:
    bf16, each k-step's words in ``TC_WORD_ORDER``."""
    n, w = rows.shape
    words = rows.to(torch.bfloat16).view(torch.int32).reshape(n, w // 16, 8)
    order = torch.tensor(TC_WORD_ORDER, device=rows.device)
    return words[:, :, order].reshape(n, w // 2).view(torch.bfloat16)


def _tc_pairs(plan: TcPlan, dev: torch.device) -> Tuple:
    """The scratch of an indexed sweep of ``plan``: its (row, bucket)
    metrics and columns."""
    return (torch.empty(plan.scratch, dtype=torch.float32, device=dev),
            torch.empty(plan.scratch, dtype=torch.int32, device=dev))


def _tc_scratch(plan: TcPlan, dev: torch.device) -> Tuple:
    """The packed rows, then K6's scratch metrics and columns, of
    ``plan``."""
    out = (torch.empty((plan.n_pad, plan.width), dtype=torch.bfloat16,
                       device=dev),)
    if plan.scratch is not None:
        out += _tc_pairs(plan, dev)
    return out


def _launch_acc(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, k: int,
                n_acc: int, use_bf16: bool, body: str, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Launch K6's ``body`` on checked operands: (out_d, out_i, the
    tensor-core body's packed rows and scratch, or ())."""
    m, n, d = _check_rows(x, 1, y2, y)
    out_d, out_i = _outputs(m, dev)
    scratch: Tuple = ()
    if m:
        if body != "cuda_cores":
            scratch = _tc_scratch(tc_plan(m, n, d, n_acc * F.LANES), dev)
        ptrs = [t.data_ptr() for t in scratch] or [None] * 3
        _build.check(_build.load_library().avt_fold_acc(
            x.data_ptr(), y.data_ptr(), y2.data_ptr(), m, n, d, k,
            n_acc, int(use_bf16), BODIES[body], *ptrs, out_d.data_ptr(),
            out_i.data_ptr(), dev.index, _stream(dev)), "K6 fold launch")
    return out_d, out_i, scratch


def acc_fold(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, *, k: int,
             n_acc: int = 4, tile_n: int = 4096, use_bf16: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: x ``[M, D]``, y ``[N, D]``, ``y2 = |y|²`` of the
    unrounded y → ``[M, 128]`` (metric f32, column int32), k extracted
    from ``n_acc·128`` buckets; see :func:`fold.acc_fold_plain`. x and y
    may arrive as bf16 tensors, rounded by the caller; they widen
    exactly. On the card bf16 rounding runs on the tensor cores (faster at
    every n_acc), f32 operands on the CUDA cores."""
    x, y = _as_f32(x, y)
    if x.device.type == "cpu":
        return F.acc_fold_plain(x, y, y2, k=k, n_acc=n_acc, tile_n=tile_n,
                                use_bf16=use_bf16)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(x=x, y=y, y2=y2)
    out_d, out_i, _ = _launch_acc(x, y, y2, k, n_acc, use_bf16,
                                  "tensor" if use_bf16 else "cuda_cores",
                                  dev)
    if out_d.shape[0]:
        acc_fold.launches += 1
    return out_d, out_i


acc_fold.launches = 0


def _launch_dotmin(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                   body: str, dev: torch.device
                   ) -> Tuple[torch.Tensor, Tuple]:
    """Launch K7's ``body`` ("cuda_cores" or "tensor") on checked operands:
    (out_d, the tensor-core body's packed rows, or ())."""
    m, n, d = _check_rows(x, 1, y2, y)
    out_d, _ = _outputs(m, dev, indexed=False)
    scratch: Tuple = ()
    if m:
        if body != "cuda_cores":
            scratch = _tc_scratch(tc_plan(m, n, d, TC_DOTMIN_BUCKETS,
                                          indexed=False), dev)
        _build.check(_build.load_library().avt_fold_dotmin(
            x.data_ptr(), y.data_ptr(), y2.data_ptr(), m, n, d,
            BODIES[body], scratch[0].data_ptr() if scratch else None,
            out_d.data_ptr(), dev.index, _stream(dev)), "K7 fold launch")
    return out_d, scratch


def dotmin(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor
           ) -> torch.Tensor:
    """K7 wrapper: ``[M, 128]`` lane minima of ``y2 − 2·bf16(x)@bf16(y)ᵀ``;
    see :func:`fold.dotmin_plain`. On the card it runs on the tensor
    cores."""
    if x.device.type == "cpu":
        return F.dotmin_plain(x, y, y2)
    dev = _check_operands(x=x, y=y, y2=y2)
    out_d, _ = _launch_dotmin(x, y, y2, "tensor", dev)
    if out_d.shape[0]:
        dotmin.launches += 1
    return out_d


dotmin.launches = 0


def _launch_nodot(x: torch.Tensor, y2: torch.Tensor, k: int, n_acc: int,
                  body: str, dev: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Launch K8's ``body`` ("cuda_cores" or "tile") on checked operands:
    (out_d, out_i, the tile's y2p — y2 padded with +inf to the plan's
    ``n_pad`` entries, so that the sweep tests no bound and a pad never
    wins — and scratch, or ())."""
    if body not in ("cuda_cores", "tile"):
        raise ValueError(f"K8 runs on 'cuda_cores' or 'tile', got {body!r}")
    m, n, d = _check_rows(x, 1, y2)
    out_d, out_i = _outputs(m, dev)
    scratch: Tuple = ()
    if m:
        if body == "tile":
            plan = tc_plan(m, n, d, n_acc * F.LANES)
            scratch = (torch.nn.functional.pad(y2, (0, plan.n_pad - n),
                                               value=float("inf")),
                       *_tc_pairs(plan, dev))
        ptrs = [t.data_ptr() for t in scratch] or [None] * 3
        _build.check(_build.load_library().avt_fold_nodot(
            x.data_ptr(), y2.data_ptr(), m, n, d, k, n_acc, BODIES[body],
            *ptrs, out_d.data_ptr(), out_i.data_ptr(), dev.index,
            _stream(dev)), "K8 fold launch")
    return out_d, out_i, scratch


def nodot_fold(x: torch.Tensor, y2: torch.Tensor, *, k: int, n_acc: int = 4,
               tile_n: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 wrapper: the fold of ``y2[col] + Σ_d x[r, d]``; see
    :func:`fold.nodot_fold_plain`, which it equals bit for bit. On the card
    it runs on the tensor-core body's tile, an add in place of the
    product."""
    if x.device.type == "cpu":
        return F.nodot_fold_plain(x, y2, k=k, n_acc=n_acc, tile_n=tile_n)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(x=x, y2=y2)
    out_d, out_i, _ = _launch_nodot(x, y2, k, n_acc, "tile", dev)
    if out_d.shape[0]:
        nodot_fold.launches += 1
    return out_d, out_i


nodot_fold.launches = 0


def _launch_tpose(xt: torch.Tensor, yt: torch.Tensor, y2: torch.Tensor,
                  k: int, n_acc: int, body: str, dev: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Launch K9's ``body`` ("cuda_cores" or "tensor") on checked
    feature-major operands, with their strides (:func:`tc_strides`):
    (out_d, out_i, the tensor-core body's packed rows and scratch, or
    ())."""
    if body not in ("cuda_cores", "tensor"):
        raise ValueError(f"K9 runs on 'cuda_cores' or 'tensor', got "
                         f"{body!r}")
    m, n, d = _check_rows(xt, 0, y2, yt)
    out_d, out_i = _outputs(m, dev)
    scratch: Tuple = ()
    if m:
        if body == "tensor":
            scratch = _tc_scratch(tc_plan(m, n, d, n_acc * F.LANES), dev)
        ptrs = [t.data_ptr() for t in scratch] or [None] * 3
        _build.check(_build.load_library().avt_fold_tpose(
            xt.data_ptr(), yt.data_ptr(), y2.data_ptr(), m, n, d, k, n_acc,
            BODIES[body], *tc_strides(m, d, True), *tc_strides(n, d, True),
            *ptrs, out_d.data_ptr(), out_i.data_ptr(), dev.index,
            _stream(dev)), "K9 fold launch")
    return out_d, out_i, scratch


def tpose_fold(xt: torch.Tensor, yt: torch.Tensor, y2: torch.Tensor, *,
               k: int, n_acc: int = 4, tile_n: int = 4096
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 wrapper: K6 with bf16 rounding over feature-major xt ``[D, M]``,
    yt ``[D, N]``; see :func:`fold.tpose_fold_plain`. On the card it runs
    K6's tensor-core body, which reads the operands through their
    strides."""
    if xt.device.type == "cpu":
        return F.tpose_fold_plain(xt, yt, y2, k=k, n_acc=n_acc, tile_n=tile_n)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(xt=xt, yt=yt, y2=y2)
    out_d, out_i, _ = _launch_tpose(xt, yt, y2, k, n_acc, "tensor", dev)
    if out_d.shape[0]:
        tpose_fold.launches += 1
    return out_d, out_i


tpose_fold.launches = 0


def _raw_rows(x: torch.Tensor, y: torch.Tensor, tpose: bool
              ) -> Tuple[int, int, int]:
    """(m, n, W) of K10's operands: x ``[M, W]`` and y ``[N, W]``, or with
    ``tpose`` ``[W, M]`` and ``[W, N]``."""
    feat = 0 if tpose else 1
    if x.dim() != 2 or y.dim() != 2 or x.shape[feat] != y.shape[feat]:
        want = "[W, M] and [W, N]" if tpose else "[M, W] and [N, W]"
        raise ValueError(f"operands must be {want}, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    d, m, n = x.shape[feat], x.shape[1 - feat], y.shape[1 - feat]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"width must be in [1, {MAX_D}], got {d}")
    if n < 1:
        raise ValueError("no train columns")
    return m, n, d


def _launch_raw(x: torch.Tensor, y: torch.Tensor, k: int, n_acc: int,
                tpose: bool, body: str, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Launch K10's ``body`` ("cuda_cores" or "tensor") on checked f32
    operands, row-major or (``tpose``) feature-major, with their strides
    (:func:`tc_strides`): (out_d, out_i, the tensor-core body's packed rows
    and scratch, or ())."""
    if body not in ("cuda_cores", "tensor"):
        raise ValueError(f"K10 runs on 'cuda_cores' or 'tensor', got "
                         f"{body!r}")
    m, n, d = _raw_rows(x, y, tpose)
    out_d, out_i = _outputs(m, dev)
    scratch: Tuple = ()
    if m:
        if body == "tensor":
            scratch = _tc_scratch(tc_plan(m, n, d, n_acc * F.LANES), dev)
        ptrs = [t.data_ptr() for t in scratch] or [None] * 3
        _build.check(_build.load_library().avt_fold_raw(
            x.data_ptr(), y.data_ptr(), m, n, d, k, n_acc, int(tpose),
            BODIES[body], *tc_strides(m, d, tpose), *tc_strides(n, d, tpose),
            *ptrs, out_d.data_ptr(), out_i.data_ptr(), dev.index,
            _stream(dev)), "K10 fold launch")
    return out_d, out_i, scratch


def raw_fold(x: torch.Tensor, y: torch.Tensor, *, k: int, n_acc: int = 4,
             tile_n: int = 4096, tpose: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 wrapper: the fold of the raw product of augmented operands, x
    ``[M, W]`` and y ``[N, W]`` (``tpose``: ``[W, M]`` and ``[W, N]``), f32
    or bf16 tensors, rounded to bf16 → ``[M, 128]`` (metric f32, column
    int32); see :func:`fold.raw_fold_plain`. On the card it runs on the
    tensor cores, row-major or reading the feature-major operands through
    their strides; sizes the kernel does not take raise."""
    x, y = _as_f32(x, y)
    if x.device.type == "cpu":
        return F.raw_fold_plain(x, y, k=k, n_acc=n_acc, tile_n=tile_n,
                                tpose=tpose)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev = _check_operands(x=x, y=y)
    out_d, out_i, _ = _launch_raw(x, y, k, n_acc, tpose, "tensor", dev)
    if out_d.shape[0]:
        raw_fold.launches += 1
    return out_d, out_i


raw_fold.launches = 0

#: widest int8 rows K11 and K12 take (the sweeps use 9 and 19)
MAX_INT8_W = 32


def _check_int8(xa: torch.Tensor, ya: torch.Tensor,
                y2: Optional[torch.Tensor] = None) -> Tuple:
    """(device, m, n, w) of int8 xa ``[M, W]``, ya ``[N, W]`` and int32 y2
    ``[N]``, contiguous on one CUDA device."""
    dev = None
    for name, t, dtype in (("xa", xa, torch.int8), ("ya", ya, torch.int8),
                           ("y2", y2, torch.int32)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xa.dim() != 2 or ya.dim() != 2 or xa.shape[1] != ya.shape[1]:
        raise ValueError(f"operands must be [M, W] and [N, W], got "
                         f"{tuple(xa.shape)} and {tuple(ya.shape)}")
    (m, w), n = xa.shape, ya.shape[0]
    if y2 is not None and y2.shape != (n,):
        raise ValueError(f"y2 must be [{n}], got {tuple(y2.shape)}")
    if not 1 <= w <= MAX_INT8_W:
        raise ValueError(f"width must be in [1, {MAX_INT8_W}], got {w}")
    if n < 1:
        raise ValueError("no train columns")
    return dev, m, n, w


#: K11 and K12 on the int8 tensor cores (``csrc/fold_int8.cu``, namespace
#: ``tc``): K6's block of TC_ROWS test rows × TC_SLICE buckets over train
#: rows packed to INT8_TC_WIDTH bytes (one k-step of mma m16n8k32), each
#: row's eight 32-bit words in TC_WORD_ORDER
INT8_TC_WIDTH = 32


#: train steps the int8 sweep loads ahead of the one it folds
INT8_TC_AHEAD = 1


def int8_tc_sweep_steps(n: int, buckets: int) -> int:
    """Steps of ``buckets`` columns the int8 sweep runs: n rounded up to
    whole rounds of ``INT8_TC_AHEAD + 1`` steps."""
    rounds = INT8_TC_AHEAD + 1
    return -(-n // (buckets * rounds)) * rounds


def int8_tc_open_rounds(n: int, buckets: int) -> int:
    """The sweep's leading rounds whose columns all lie below n; it masks
    the columns past n in the rest."""
    return n // buckets // (INT8_TC_AHEAD + 1)


def int8_tc_plan(m: int, n: int, w: int, buckets: int) -> TcPlan:
    """Shapes of a K11 or K12 launch on the tensor cores over m test rows,
    n train rows of w int8 and ``buckets`` buckets: the packed rows
    ``[n_pad, 32]`` (K11's y2 is padded to the same ``n_pad``), the sweep's
    grid, and the ``[m, buckets]`` (metric, column) scratch."""
    if buckets not in [a * F.LANES for a in F.PACKED_N_ACC_CHOICES]:
        raise ValueError(f"buckets must be n_acc·128 for n_acc in "
                         f"{F.PACKED_N_ACC_CHOICES}, got {buckets}")
    if not 1 <= w <= MAX_INT8_W:
        raise ValueError(f"width must be in [1, {MAX_INT8_W}], got {w}")
    if m < 1 or n < 1:
        raise ValueError(f"no rows: m={m}, n={n}")
    n_pad = (int8_tc_sweep_steps(n, buckets) + INT8_TC_AHEAD) * buckets
    return TcPlan(buckets, INT8_TC_WIDTH, n_pad,
                  (-(-m // TC_ROWS), buckets // TC_SLICE), (m, buckets))


def int8_tc_packed(ya: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The packed train rows of the int8 tensor-core body, ``[n_pad, 32]``
    int8: ya ``[N, W]`` zero-padded to 32 bytes and to ``n_pad`` rows, each
    row's eight 32-bit words in ``TC_WORD_ORDER`` (lane tig's B fragment,
    words tig and tig + 4, is then one 8-byte load)."""
    n, w = ya.shape
    rows = torch.zeros((n_pad, INT8_TC_WIDTH), dtype=torch.int8,
                       device=ya.device)
    rows[:n, :w] = ya
    order = torch.tensor(TC_WORD_ORDER, device=ya.device)
    return rows.view(torch.int32)[:, order].contiguous().view(torch.int8)


def _int8_scratch(plan: TcPlan, epi: bool, dev: torch.device) -> Tuple:
    """The int8 tensor-core body's scratch of ``plan``: the packed rows, y2
    padded to them (with ``epi``, else None), then the (metric, column)
    pairs."""
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.empty((plan.n_pad, plan.width), dtype=torch.int8,
                        device=dev),
            torch.empty(plan.n_pad, **i32) if epi else None,
            torch.empty(plan.scratch, **i32), torch.empty(plan.scratch, **i32))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_int8(xa: torch.Tensor, ya: torch.Tensor,
                 y2: Optional[torch.Tensor], k: int, n_acc: int, body: str,
                 dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                             Tuple]:
    """Launch K11's ``body`` ("cuda_cores" or "tensor") on checked
    operands: (out_d, out_i, the tensor-core body's scratch — packed rows,
    y2 padded or None, metrics, columns — or ())."""
    if body not in ("cuda_cores", "tensor"):
        raise ValueError(f"K11 runs on 'cuda_cores' or 'tensor', got "
                         f"{body!r}")
    (m, w), n = xa.shape, ya.shape[0]
    out_d, out_i = _outputs(m, dev, dtype=torch.int32)
    scratch: Tuple = ()
    if m:
        epi = y2 is not None
        if body == "tensor":
            scratch = _int8_scratch(int8_tc_plan(m, n, w, n_acc * F.LANES),
                                    epi, dev)
        _build.check(_build.load_library().avt_fold_int8(
            xa.data_ptr(), ya.data_ptr(), _ptr(y2), m, n, w, k, n_acc,
            BODIES[body], *map(_ptr, scratch or (None,) * 4),
            out_d.data_ptr(), out_i.data_ptr(), dev.index, _stream(dev)),
            "K11 fold launch")
    return out_d, out_i, scratch


def int8_fold(xa: torch.Tensor, ya: torch.Tensor,
              y2: Optional[torch.Tensor] = None, *, k: int, n_acc: int = 4,
              tile_n: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 wrapper: int8 xa ``[M, W]``, ya ``[N, W]`` (W as the caller
    built them, 9 or 19 in the sweeps) → ``[M, 128]`` (metric int32, column
    int32) of the fold of the int32 product, or of ``y2 − 2·product`` with
    int32 ``y2`` ``[N]``; see :func:`fold.int8_fold_plain`, which it equals
    bit for bit. On the card it runs on the int8 tensor cores."""
    if xa.device.type == "cpu":
        return F.int8_fold_plain(xa, ya, y2, k=k, n_acc=n_acc, tile_n=tile_n)
    F.check_tiles(n_acc, tile_n)
    F.check_k(k)
    dev, m, _, _ = _check_int8(xa, ya, y2)
    out_d, out_i, _ = _launch_int8(xa, ya, y2, k, n_acc, "tensor", dev)
    if m:
        int8_fold.launches += 1
    return out_d, out_i


int8_fold.launches = 0


def _launch_packed(xa: torch.Tensor, ya: torch.Tensor, k: int, n_acc: int,
                   body: str, dev: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Launch K12's ``body`` ("cuda_cores" or "tensor") on checked operands
    (ranges checked by the caller): (out_d, out_i, the tensor-core body's
    scratch as K11's, its y2 None, or ())."""
    if body not in ("cuda_cores", "tensor"):
        raise ValueError(f"K12 runs on 'cuda_cores' or 'tensor', got "
                         f"{body!r}")
    (m, w), n = xa.shape, ya.shape[0]
    out_d, out_i = _outputs(m, dev, dtype=torch.int32)
    scratch: Tuple = ()
    if m:
        if body == "tensor":
            scratch = _int8_scratch(int8_tc_plan(m, n, w, n_acc * F.LANES),
                                    False, dev)
        yp, _, vals, cols = scratch or (None,) * 4
        _build.check(_build.load_library().avt_fold_packed(
            xa.data_ptr(), ya.data_ptr(), m, n, w, k, n_acc, BODIES[body],
            _ptr(yp), _ptr(vals), _ptr(cols), out_d.data_ptr(),
            out_i.data_ptr(), dev.index, _stream(dev)), "K12 fold launch")
    return out_d, out_i, scratch


def packed_fold(xa: torch.Tensor, ya: torch.Tensor, *, k: int,
                n_acc: int = 4, tile_n: int = 4096,
                metric_bound: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 wrapper: K11 without ``y2`` through one packed int32 a bucket,
    ``metric·2048 + col div 128`` folded by ``min`` → ``[M, 128]`` (metric
    int32, column int32), k ≤ 128 candidates; ``n_acc`` may be 16; see
    :func:`fold.packed_fold_plain`, which it equals bit for bit. On the
    card it runs on the int8 tensor cores. Raises where N > 262,144, and
    where ``|metric| ≥ 2**18`` cannot be excluded: ``metric_bound`` is the
    caller's bound of ``|metric|`` by the operands' construction, and
    without one the wrapper reads it off the tensors
    (:func:`fold.packed_metric_bound`, which waits for the device)."""
    if xa.device.type == "cpu":
        return F.packed_fold_plain(xa, ya, k=k, n_acc=n_acc, tile_n=tile_n,
                                   metric_bound=metric_bound)
    F.check_tiles(n_acc, tile_n, F.PACKED_N_ACC_CHOICES)
    F.check_k(k)
    dev, m, n, _ = _check_int8(xa, ya)
    F.check_packed(n, F.packed_metric_bound(xa, ya) if metric_bound is None
                   else metric_bound)
    out_d, out_i, _ = _launch_packed(xa, ya, k, n_acc, "tensor", dev)
    if m:
        packed_fold.launches += 1
    return out_d, out_i


packed_fold.launches = 0
