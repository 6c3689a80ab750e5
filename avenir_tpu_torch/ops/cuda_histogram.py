"""K1 (the Naive Bayes joint counts) and K4 (the pair contingency counts):
the CUDA kernels' wrappers and their plain PyTorch twins.

Replaces ``avenir_tpu/ops/pallas_histogram.py``'s ``_cfb_kernel`` and
``_pair_kernel`` (the kernels and their design notes are in
``csrc/hist.cu``), with the JAX functions' contracts:

- K1: ``[N, F]`` bin ids × ``[N]`` labels (optional ``[N]`` weights) →
  ``[C, F, B]`` f32 joint counts; ids outside ``[0, B)`` and labels
  outside ``[0, C)`` drop out; N = 0 or F = 0 give zeros. Its integer
  mode, ``class_feature_bin_sums``, sums integer-valued f32 weights
  exactly into ``[C, F, B]`` int64 (int32 in the kernel, rows split
  across launches so that no cell can pass 2^31).
- K4: ``[N]`` × ``[N]`` ids (optional ``[N]`` weights, folded into the
  ``a`` side) → ``[n_a, n_b]`` f32 contingency counts; ids outside their
  range drop out; N = 0 gives zeros. ``pair_counts_multi`` counts many
  pairs of the columns of one ``[K, N]`` id matrix in one launch, into one
  flat buffer (pair p's ``[n_a, n_b]`` block at its offset); each block
  equals ``pair_counts`` of its two columns. ``pair_counts`` is the same
  launch with one pair.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Nothing falls back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
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


# --------------------------------------------------------------------------
# K1's integer mode: exact sums of integer-valued weights
# --------------------------------------------------------------------------

#: a launch's cells stay below this (int32 accumulators)
INT_SUM_LIMIT = 2 ** 31


def class_feature_bin_sums_plain(bins: torch.Tensor, labels: torch.Tensor,
                                 n_classes: int, n_bins: int,
                                 weights: torch.Tensor) -> torch.Tensor:
    """Plain version: an int64 ``index_add_`` of the weights (each cast to
    an integer, as the kernel casts it) over the masked combined ids
    ``f·C·B + label·B + bin``; int64 needs no bound on the weights."""
    n, n_f = bins.shape
    cells = n_f * n_classes * n_bins
    bins = bins.long()
    labels = labels.long().reshape(n, 1)
    valid = ((bins >= 0) & (bins < n_bins)
             & (labels >= 0) & (labels < n_classes))
    f_off = torch.arange(n_f, device=bins.device).reshape(1, n_f) * (
        n_classes * n_bins)
    flat = (f_off + labels * n_bins + bins)[valid]
    w = weights.to(torch.int64).reshape(n, 1).expand(n, n_f)[valid]
    sums = torch.zeros(cells, dtype=torch.int64, device=bins.device)
    sums.index_add_(0, flat, w)
    return sums.reshape(n_f, n_classes, n_bins).permute(1, 0, 2).contiguous()


def class_feature_bin_sums(bins: torch.Tensor, labels: torch.Tensor,
                           n_classes: int, n_bins: int,
                           weights: torch.Tensor, max_abs_weight: float
                           ) -> torch.Tensor:
    """K1's integer mode: ``[N, F]`` int32 bins × ``[N]`` int32 labels ×
    ``[N]`` integer-valued f32 weights, none of magnitude above
    ``max_abs_weight`` → ``[C, F, B]`` int64 exact sums of the weights.
    The rows go in launches of fewer than 2^31 / max|w| rows, so no int32
    cell can overflow, and the launches' sums add in int64."""
    if bins.dim() != 2:
        raise ValueError(f"bins must be [N, F], got shape {tuple(bins.shape)}")
    if bins.device.type == "cpu":
        return class_feature_bin_sums_plain(bins, labels, n_classes, n_bins,
                                            weights)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    n, n_f = bins.shape
    if labels.shape != (n,) or weights.shape != (n,):
        raise ValueError(f"labels and weights must be [{n}], got "
                         f"{tuple(labels.shape)}, {tuple(weights.shape)}")
    _check_ids(bins, bins=bins, labels=labels, weights=weights)
    if n_classes < 1 or n_bins < 1:
        raise ValueError(f"n_classes and n_bins must be >= 1, got "
                         f"{n_classes}, {n_bins}")
    if n == 0 or n_f == 0:
        return torch.zeros((n_classes, n_f, n_bins), dtype=torch.int64,
                           device=bins.device)
    sums = _int_sum_launches(bins, labels, weights, n_classes, n_bins,
                             rows_per_launch(max_abs_weight))
    return sums.reshape(n_f, n_classes, n_bins).permute(1, 0, 2).contiguous()


def rows_per_launch(max_abs_weight: float) -> int:
    """The most rows one launch of K1's integer mode may take when no
    weight exceeds ``max_abs_weight`` in magnitude: fewer than
    2^31 / max|w|, so that no int32 cell can overflow."""
    if not max_abs_weight < INT_SUM_LIMIT:
        raise ValueError(f"a weight of magnitude {max_abs_weight} does not "
                         "fit an int32 sum")
    return max(1, int((INT_SUM_LIMIT - 1) // max(max_abs_weight, 1.0)))


def _int_sum_launches(bins, labels, weights, n_classes: int, n_bins: int,
                      rows: int) -> torch.Tensor:
    """[F, C·B] int64: K1's integer mode launched on ``rows`` rows at a
    time (row r0's operands at their storage plus r0 rows), each launch's
    int32 sums added in int64."""
    n, n_f = bins.shape
    lib = _build.load_library()
    out = torch.empty((n_f, n_classes * n_bins), dtype=torch.int32,
                      device=bins.device)
    sums = torch.zeros((n_f, n_classes * n_bins), dtype=torch.int64,
                       device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    for r0 in range(0, n, rows):
        err = lib.avt_cfb_sums_int(
            bins[r0:].data_ptr(), labels[r0:].data_ptr(),
            weights[r0:].data_ptr(), min(rows, n - r0), n_f, n_classes,
            n_bins, out.data_ptr(), bins.device.index, stream)
        _build.check(err, "class_feature_bin_sums kernel launch")
        class_feature_bin_sums.launches += 1
        sums += out
    return sums


class_feature_bin_sums.launches = 0


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
    """``[N]`` int32 × ``[N]`` int32 ids → ``[n_a, n_b]`` f32 counts: the
    launch of ``pair_counts_multi`` with the one pair (a, b)."""
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
    # the kernel reads column k at ids + k * ld: a's storage, then b's
    ld = (b.data_ptr() - a.data_ptr()) // 4
    out = _launch(a, ld, n, ((0, 1),), (n_a, n_b), weights)
    pair_counts.launches += 1
    return out.reshape(n_a, n_b)


pair_counts.launches = 0


# --------------------------------------------------------------------------
# K4 over many pairs: one launch for every pair of a job
# --------------------------------------------------------------------------

#: the kernel's shared-memory layout (``csrc/hist.cu``): the most a block
#: may use, its warps, and a group's staged tile: about PAIR_TILE_ITEMS
#: (row, pair) items, in rows a multiple of PAIR_TILE_MIN_ROWS up to
#: PAIR_TILE_MAX_ROWS (the plan hands the kernel each group's), each column
#: padded by PAIR_TILE_PAD words
MAX_SHARED_BYTES = 232448
WARPS = 8
PAIR_TILE_ITEMS = 8192
PAIR_TILE_MIN_ROWS = 256
PAIR_TILE_MAX_ROWS = 2048
PAIR_TILE_PAD = 4


@dataclass(frozen=True)
class PairGroup:
    """Pairs counted by the same blocks: ``pairs`` (a range of the
    caller's pair indices), the distinct ``columns`` they name, their
    ``cells``, the ``copies`` of their histograms a block keeps in shared
    memory (0: one pair too large for shared memory, added into the global
    result directly), the rows of a staged tile and the ``smem`` bytes a
    block of the group takes."""

    pairs: range
    columns: Tuple[int, ...]
    cells: int
    copies: int
    tile_rows: int
    smem: int


def _round4(x: int) -> int:
    return (x + 3) & ~3


def pair_tile_rows(n_pairs: int) -> int:
    """Rows of a staged tile for a group of ``n_pairs`` pairs."""
    rows = -(-PAIR_TILE_ITEMS // n_pairs)
    rows = -(-rows // PAIR_TILE_MIN_ROWS) * PAIR_TILE_MIN_ROWS
    return min(rows, PAIR_TILE_MAX_ROWS)


def _group_smem(n_pairs: int, n_columns: int, cells: int, copies: int,
                weighted: bool) -> int:
    """The pairs' table, the histogram copies and two staged tiles."""
    stride = pair_tile_rows(n_pairs) + PAIR_TILE_PAD
    return (16 * n_pairs + 4 * _round4(copies * cells)
            + 8 * (n_columns + weighted) * stride)


def pair_offsets(pairs: Sequence[Tuple[int, int]],
                 cards: Sequence[int]) -> List[int]:
    """Where each pair's ``[n_a, n_b]`` block starts in the flat result,
    and the total, as ``len(pairs) + 1`` offsets."""
    offsets = [0]
    for a, b in pairs:
        offsets.append(offsets[-1] + cards[a] * cards[b])
    return offsets


def plan_pair_groups(pairs: Sequence[Tuple[int, int]], cards: Sequence[int],
                     weighted: bool = False,
                     budget: int = MAX_SHARED_BYTES) -> List[PairGroup]:
    """Cut the pair list, in order, into groups whose histograms (int32
    cells), staged columns and pair table fit ``budget`` bytes of shared
    memory. A pair that does not fit alone forms a group of its own with
    ``copies`` 0. A group of fewer than 32 pairs (whose warps' lanes cover
    several rows of one pair) keeps one histogram copy a warp where they
    fit, up to ``WARPS``; a larger one keeps one copy."""
    groups: List[PairGroup] = []
    start, columns, cells = 0, [], 0

    def close(end: int) -> None:
        if end == start:
            return
        n_p = end - start
        copies = WARPS if n_p < 32 else 1
        while copies > 1 and _group_smem(n_p, len(columns), cells, copies,
                                         weighted) > budget:
            copies -= 1
        groups.append(PairGroup(range(start, end), tuple(columns), cells,
                                copies, pair_tile_rows(n_p),
                                _group_smem(n_p, len(columns), cells,
                                            copies, weighted)))

    for p, (a, b) in enumerate(pairs):
        pair_cells = cards[a] * cards[b]
        pair_columns = list(dict.fromkeys((a, b)))
        if _group_smem(1, len(pair_columns), pair_cells, 1,
                       weighted) > budget:
            close(p)
            groups.append(PairGroup(range(p, p + 1), tuple(pair_columns),
                                    pair_cells, 0, pair_tile_rows(1),
                                    _group_smem(1, len(pair_columns), 0, 0,
                                                weighted)))
            start, columns, cells = p + 1, [], 0
            continue
        grown = list(dict.fromkeys(columns + pair_columns))
        if _group_smem(p - start + 1, len(grown), cells + pair_cells, 1,
                       weighted) > budget:
            close(p)
            start, grown, cells = p, pair_columns, 0
        columns, cells = grown, cells + pair_cells
    close(len(pairs))
    return groups


def _plan_table(pairs, cards, groups) -> np.ndarray:
    """The kernel's plan (``csrc/hist.cu``, ``PairGroup``): eight int32 a
    group, four a pair, then the groups' column lists."""
    offsets = pair_offsets(pairs, cards)
    head, body, slots = [], [], []
    for g in groups:
        slot = {c: i for i, c in enumerate(g.columns)}
        head += [g.pairs.start, g.pairs.stop, len(slots),
                 len(slots) + len(g.columns), g.cells, g.copies,
                 offsets[g.pairs.start], g.tile_rows]
        for p in g.pairs:
            a, b = pairs[p]
            body += [slot[a] | slot[b] << 16, cards[a], cards[b],
                     offsets[p] - offsets[g.pairs.start]]
        slots += g.columns
    return np.asarray(head + body + slots, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _device_plan(pairs: Tuple[Tuple[int, int], ...], cards: Tuple[int, ...],
                 weighted: bool, device: torch.device):
    """The plan of a pair list on ``device``, built once for each pair
    list, cardinalities and weighting: (groups, table, shared-memory bytes
    of the largest group, most cells a pair of a shared-memory group holds
    on average)."""
    groups = plan_pair_groups(pairs, cards, weighted)
    table = torch.from_numpy(_plan_table(pairs, cards, groups)).to(device)
    smem = max(g.smem for g in groups)
    per_pair = max([-(-g.cells // len(g.pairs)) for g in groups
                    if g.copies > 0] or [0])
    return groups, table, smem, per_pair


def _launch(ids: torch.Tensor, ld: int, n: int,
            pairs: Tuple[Tuple[int, int], ...], cards: Tuple[int, ...],
            weights: Optional[torch.Tensor]) -> torch.Tensor:
    """One K4 launch over ``n`` rows of the columns at ``ids``'s storage
    plus ``k * ld`` elements: the flat f32 counts of every pair."""
    groups, table, smem, per_pair = _device_plan(
        pairs, cards, weights is not None, ids.device)
    if len(groups) > 65535:
        raise ValueError(f"{len(groups)} groups of pairs exceed the grid's "
                         "65,535")
    lib = _build.load_library()
    out = torch.empty(pair_offsets(pairs, cards)[-1],
                      dtype=torch.int32 if weights is None else torch.float32,
                      device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = lib.avt_pair_counts_multi(
        ids.data_ptr(), ld, None if weights is None else weights.data_ptr(),
        n, table.data_ptr(), len(groups), len(pairs), out.numel(), smem,
        per_pair, out.data_ptr(), ids.device.index, stream)
    _build.check(err, "pair_counts_multi kernel launch")
    return out.to(torch.float32)


def _check_pairs(n_columns: int, pairs, cards) -> None:
    if len(cards) != n_columns:
        raise ValueError(f"cards must name {n_columns} columns, got "
                         f"{len(cards)}")
    if any(c < 1 for c in cards):
        raise ValueError(f"cardinalities must be >= 1, got {list(cards)}")
    for a, b in pairs:
        if not (0 <= a < n_columns and 0 <= b < n_columns):
            raise ValueError(f"pair ({a}, {b}) names a column outside "
                             f"[0, {n_columns})")
    if pair_offsets(pairs, cards)[-1] >= 2 ** 31:
        raise ValueError("the pairs' cells must number fewer than 2**31")


def pair_counts_multi_plain(ids: torch.Tensor,
                            pairs: Sequence[Tuple[int, int]],
                            cards: Sequence[int],
                            weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version: one bincount over the masked combined ids
    ``offset[p] + a·n_b + b`` of every pair (integer counts, exact), or an
    index_add of the weights in float64, rounded once to f32."""
    dev = ids.device
    offsets = pair_offsets(pairs, cards)
    if not pairs:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    n = ids.shape[1]
    col_a = torch.tensor([a for a, _ in pairs], device=dev)
    col_b = torch.tensor([b for _, b in pairs], device=dev)
    cards_t = torch.tensor(list(cards), device=dev)
    n_a, n_b = cards_t[col_a].reshape(-1, 1), cards_t[col_b].reshape(-1, 1)
    ids = ids.long()
    a, b = ids[col_a], ids[col_b]                               # [P, N]
    valid = (a >= 0) & (a < n_a) & (b >= 0) & (b < n_b)
    off = torch.tensor(offsets[:-1], device=dev).reshape(-1, 1)
    flat = (off + a * n_b + b)[valid]
    if weights is None:
        return torch.bincount(flat, minlength=offsets[-1]).to(torch.float32)
    w = weights.to(torch.float64).reshape(1, n).expand(len(pairs), n)[valid]
    counts = torch.zeros(offsets[-1], dtype=torch.float64, device=dev)
    return counts.index_add_(0, flat, w).to(torch.float32)


def pair_counts_multi(ids: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                      cards: Sequence[int],
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``[K, N]`` int32 ids (column k is row k), P pairs ``(c_a, c_b)`` of
    its columns and each column's cardinality → the flat f32 counts of
    every pair, pair p's ``[card[c_a], card[c_b]]`` block at
    ``pair_offsets(pairs, cards)[p]`` (``split_pairs`` cuts it), in one
    launch."""
    if ids.dim() != 2:
        raise ValueError(f"ids must be [K, N], got shape {tuple(ids.shape)}")
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    cards = tuple(int(c) for c in cards)
    _check_pairs(ids.shape[0], pairs, cards)
    if ids.device.type == "cpu":
        return pair_counts_multi_plain(ids, pairs, cards, weights)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    n = ids.shape[1]
    _check_ids(ids, ids=ids, weights=weights)
    if weights is not None and weights.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {tuple(weights.shape)}")
    if n == 0 or not pairs:
        return torch.zeros(pair_offsets(pairs, cards)[-1],
                           dtype=torch.float32, device=ids.device)
    out = _launch(ids, n, n, pairs, cards, weights)
    pair_counts_multi.launches += 1
    return out


pair_counts_multi.launches = 0


def split_pairs(flat: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                cards: Sequence[int]) -> List[torch.Tensor]:
    """The ``[n_a, n_b]`` blocks of ``pair_counts_multi``'s flat result,
    one a pair (views)."""
    offsets = pair_offsets(pairs, cards)
    return [flat[offsets[p]:offsets[p + 1]].reshape(cards[a], cards[b])
            for p, (a, b) in enumerate(pairs)]
