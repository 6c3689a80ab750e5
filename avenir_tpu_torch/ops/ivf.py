"""IVF approximate nearest neighbor on one device, in plain PyTorch.

Counterpart of ``avenir_tpu/ops/ivf.py`` (``default_nlist``,
``default_nprobe``, ``_seed_centroids``, ``_lloyd_step``,
``assign_counts``, ``_assign_rows``, ``train_coarse_quantizer``,
``IvfIndex``, ``_build_lists``, ``build_ivf``, ``ann_core`` with its
overflow tails, ``ann_topk`` and the live index's query,
:func:`live_ann_topk`) without the sharded layout, which the multi-device
layer ports. The train set is clustered once (a coarse quantizer of
``nlist`` centroids) and each query scans only the rows of its
``n_probe`` nearest lists:

- **Coarse quantizer**: k-means++ seeding on the host from a fixed seed
  (the JAX package's numpy code, so the same seed picks the same seeds),
  then Lloyd steps on the device. Each step's per-list counts go through
  ``histogram.class_feature_bin_counts`` (one class, one feature,
  ``nlist`` bins): K1 on the card. The per-list sums are a one-hot product
  over fixed row chunks, never ``index_add_``: float atomics would sum in
  another order each run, and two builds must give the same index. An
  empty list keeps its centroid; argmin ties take the lowest centroid id.
- **Inverted lists**: the train rows reordered by list into one flat
  table, each list's span padded to a power-of-two row count
  (``pipeline.bucket_rows``), padding rows carrying id −1; the scan's
  gather width ``probe_pad`` is the largest padded span.
- **Query**: the ``n_probe`` nearest centroids (deferred ``c² − 2x·c``,
  ties to the lowest id), then one probed list at a time (the JAX
  package's ``lax.scan``; gathering every probe at once would need
  M × n_probe × probe_pad rows): the low-precision metric of
  ``quantized.gathered_candidate_metric`` feeds a running top-k′ on
  (metric, train id) keys, and the survivors re-rank in exact f32 as in
  ``quantized``. With ``n_probe = nlist`` every row is a candidate and
  the int8 result IS ``quantized.quantized_topk``'s: same joint scale,
  integer metrics, the same (metric, id) rule.
- **Overflow tails** (the live index, ``models/live_ann.py``): each list
  also owns a fixed-width block of appended rows, ``tail_cap`` a list;
  a probed list's tail goes through the same masked gather, the same
  (metric, id) merge and the same exact re-rank as its main span.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.ops.distance import INT_BIG, encode_mixed
from avenir_tpu_torch.ops.quantized import (
    BIG, ArrayLike, _q8, as_tensor, check_params, exact_candidate_metric,
    finalize_quantized, gathered_candidate_metric, int8_scale, key_ids,
    merge_keys, order_key, row_chunks, sort_pairs)
from avenir_tpu_torch.parallel.pipeline import bucket_rows
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

#: per-list bucket floor: lists pad to bucket_rows(len, _LIST_FLOOR)
_LIST_FLOOR = 8
#: rows a step of the assignment and of the per-list sums takes at once
#: (bounds the [rows, nlist] metric and one-hot blocks)
_ROW_CHUNK = 65536
#: k-means++ seeds from at most this many rows a list (the training
#: subsample, so that seeding never dominates the build)
_SEED_SAMPLE = 64
#: Lloyd stops once no centroid moves by more than this (squared)
_TOL = 1e-12


def default_nlist(n: int) -> int:
    """Auto ``nlist``: ~√N, capped so that lists hold ≥ 64 rows."""
    n = max(int(n), 1)
    root = int(round(float(np.sqrt(n))))
    return max(1, min(root, max(1, n // 64)))


def default_nprobe(nlist: int) -> int:
    """Auto ``n_probe``: a quarter of the lists with a floor of 8."""
    return max(1, min(nlist, max(8, nlist // 4)))


# ---------------------------------------------------------------------------
# coarse quantizer: k-means++ seeding + Lloyd steps
# ---------------------------------------------------------------------------

def _seed_centroids(y: np.ndarray, nlist: int,
                    rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on the host: each next seed is drawn ∝ squared
    distance to the nearest chosen one; with fewer than ``nlist`` distinct
    rows the surplus seeds duplicate (and own empty lists)."""
    n = y.shape[0]
    y64 = y.astype(np.float64)
    first = int(rng.integers(n))
    cents = [y[first]]
    d2 = ((y64 - y64[first]) ** 2).sum(axis=1)
    for _ in range(1, nlist):
        total = float(d2.sum())
        if total <= 0.0:
            idx = int(rng.integers(n))
        else:
            idx = int(rng.choice(n, p=d2 / total))
        cents.append(y[idx])
        d2 = np.minimum(d2, ((y64 - y64[idx]) ** 2).sum(axis=1))
    return np.stack(cents).astype(np.float32)


def _nearest(y: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[N] int32 nearest centroid of each row (deferred ``c² − 2y·c``;
    ``argmin`` ties take the lowest centroid id), row chunk by row
    chunk."""
    c2 = (cents * cents).sum(dim=1).reshape(1, -1)
    parts = [torch.argmin(c2 - 2.0 * (y[r0:r0 + _ROW_CHUNK] @ cents.T), dim=1)
             for r0 in range(0, y.shape[0], _ROW_CHUNK)]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=y.device)
    return torch.cat(parts).to(torch.int32)


def _list_counts(assign: torch.Tensor, nlist: int) -> torch.Tensor:
    """[nlist] f32 rows per list, through K1 (one class, one feature)."""
    n = assign.shape[0]
    return histogram.class_feature_bin_counts(
        assign.reshape(n, 1), torch.zeros(n, dtype=torch.int32,
                                          device=assign.device),
        n_classes=1, n_bins=nlist).reshape(nlist)


def _list_sums(y: torch.Tensor, assign: torch.Tensor, nlist: int
               ) -> torch.Tensor:
    """[nlist, D] f32 per-list row sums: a one-hot product over fixed row
    chunks, added in chunk order (the same order every run)."""
    sums = torch.zeros((nlist, y.shape[1]), dtype=torch.float32,
                       device=y.device)
    for r0 in range(0, y.shape[0], _ROW_CHUNK):
        rows = assign[r0:r0 + _ROW_CHUNK].long().reshape(-1, 1)
        onehot = torch.zeros((rows.shape[0], nlist), dtype=torch.float32,
                             device=y.device).scatter_(1, rows, 1.0)
        sums = sums + onehot.T @ y[r0:r0 + _ROW_CHUNK]
    return sums


def _lloyd_step(y: torch.Tensor, cents: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration: (new centroids, assignment, largest squared
    centroid move)."""
    nlist = cents.shape[0]
    assign = _nearest(y, cents)
    counts = _list_counts(assign, nlist)
    sums = _list_sums(y, assign, nlist)
    new = torch.where((counts > 0).reshape(-1, 1),
                      sums / torch.clamp(counts, min=1.0).reshape(-1, 1),
                      cents)
    shift = ((new - cents) ** 2).sum(dim=1).max()
    return new, assign, shift


def assign_counts(y: torch.Tensor, cents: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment [N] int32 and rows per list [nlist]
    f32 (K1 on the card)."""
    assign = _nearest(y, cents)
    return assign, _list_counts(assign, cents.shape[0])


def _assign_rows(y: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """The final assignment, against the centroids queries will probe."""
    return _nearest(y, cents)


def train_coarse_quantizer(y: torch.Tensor, nlist: int, *, n_iters: int = 15,
                           seed: int = 0,
                           init_centroids: Optional[np.ndarray] = None
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """k-means over the encoded rows ``y`` [N, D] on their device: host
    k-means++ seeding on a sample of ≤ 64 · ``nlist`` rows, then up to
    ``n_iters`` Lloyd steps, stopping once no centroid moves. Returns
    (centroids [nlist, D] on ``y``'s device, final assignment [N] host
    int32). ``init_centroids`` [nlist, D] starts Lloyd from them in place
    of the seeding (the live index's rebuild)."""
    n = int(y.shape[0])
    if nlist < 1:
        raise ValueError(f"nlist must be >= 1, got {nlist}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if init_centroids is not None:
        init = np.asarray(init_centroids, np.float32)
        if init.shape != (nlist, int(y.shape[1])):
            raise ValueError(
                f"init_centroids shape {init.shape} does not match "
                f"(nlist={nlist}, d={int(y.shape[1])})")
        cents = torch.from_numpy(init.copy()).to(y.device)
    else:
        rng = np.random.default_rng(seed)
        y_host = y.cpu().numpy()
        cap = max(nlist, min(n, _SEED_SAMPLE * nlist))
        sample = (y_host if cap >= n
                  else y_host[rng.choice(n, cap, replace=False)])
        cents = torch.from_numpy(
            _seed_centroids(sample, nlist, rng)).to(y.device)
    for _ in range(n_iters):
        cents, _, shift = _lloyd_step(y, cents)
        if float(shift) < _TOL:
            break
    return cents, _assign_rows(y, cents).cpu().numpy()


# ---------------------------------------------------------------------------
# inverted-list layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IvfIndex:
    """One staged IVF index, every tensor on one device: the reordered
    flat table plus probe metadata. ``models/knn.py``'s one-slot train
    cache holds it."""

    centroids: torch.Tensor   # [L, D] f32 (encoded space)
    cent_valid: torch.Tensor  # [L] bool, False for structural pad lists
    flat: torch.Tensor        # [N_pad, D] f32, rows grouped by list
    qflat: torch.Tensor       # [N_pad, D] int8 at the build scale (amax)
    gids: torch.Tensor        # [N_pad] int32 train row ids, -1 padding
    offsets: torch.Tensor     # [L] int32 list start in ``flat``
    lengths: torch.Tensor     # [L] int32 real rows per list
    amax: torch.Tensor        # [] f32 max |y| over real rows (int8 scale)
    nlist: int
    probe_pad: int            # the largest padded list span
    n_real: int
    n_attrs: int
    n_cat_bins: int
    seed: int

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def d(self) -> int:
        return int(self.flat.shape[1])


def _build_lists(encoded: np.ndarray, assign: np.ndarray, nlist: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            int]:
    """Host assembly of the bucket-padded flat layout: (flat [N_pad, D],
    gids [N_pad], offsets [L], lengths [L], probe_pad). Rows keep their
    id order within each list (stable argsort)."""
    n, d = encoded.shape
    order = np.argsort(assign, kind="stable")
    lengths = np.bincount(assign, minlength=nlist).astype(np.int32)
    padded = np.asarray([bucket_rows(int(c), _LIST_FLOOR) for c in lengths],
                        np.int64)
    offsets = np.zeros(nlist, np.int64)
    offsets[1:] = np.cumsum(padded)[:-1]
    n_pad = int(padded.sum())
    flat = np.zeros((n_pad, d), np.float32)
    gids = np.full(n_pad, -1, np.int32)
    starts = np.zeros(nlist, np.int64)
    starts[1:] = np.cumsum(lengths.astype(np.int64))[:-1]
    for li in range(nlist):
        c = int(lengths[li])
        if c == 0:
            continue
        rows = order[starts[li]:starts[li] + c]
        flat[offsets[li]:offsets[li] + c] = encoded[rows]
        gids[offsets[li]:offsets[li] + c] = rows
    probe_pad = int(padded.max()) if nlist else _LIST_FLOOR
    return flat, gids, offsets.astype(np.int32), lengths, probe_pad


def build_ivf(y_num: Optional[ArrayLike], y_cat: Optional[ArrayLike] = None,
              *, n_cat_bins: int = 0, nlist: int = 0, n_iters: int = 15,
              seed: int = 0, init_centroids: Optional[np.ndarray] = None,
              device: DeviceLike = "cuda") -> IvfIndex:
    """The IVF index over normalized train features on ``device``.
    ``nlist=0`` sizes it to ~√N lists. The same ``seed`` gives the same
    index; ``init_centroids`` starts the k-means from them (the live
    index's rebuild)."""
    dev = resolve_device(device)
    y_num, y_cat = as_tensor(y_num, dev), as_tensor(y_cat, dev)
    y = encode_mixed(y_num, y_cat, n_cat_bins)
    n = int(y.shape[0])
    if n == 0:
        raise ValueError("cannot build an IVF index over an empty train "
                         "table")
    if nlist == 0:
        nlist = default_nlist(n)
    cents, assign = train_coarse_quantizer(y, nlist, n_iters=n_iters,
                                           seed=seed,
                                           init_centroids=init_centroids)
    encoded = y.cpu().numpy()
    flat, gids, offsets, lengths, probe_pad = _build_lists(
        encoded, assign, nlist)
    amax = torch.tensor(float(np.max(np.abs(encoded))), dtype=torch.float32,
                        device=dev)
    n_attrs = ((y_num.shape[1] if y_num is not None else 0) +
               (y_cat.shape[1] if y_cat is not None else 0))
    flat_dev = torch.from_numpy(flat).to(dev)
    return IvfIndex(
        centroids=cents, cent_valid=torch.ones(nlist, dtype=torch.bool,
                                               device=dev),
        flat=flat_dev, qflat=_q8(flat_dev, int8_scale(amax)),
        gids=torch.from_numpy(gids).to(dev),
        offsets=torch.from_numpy(offsets).to(dev),
        lengths=torch.from_numpy(lengths).to(dev), amax=amax, nlist=nlist,
        probe_pad=probe_pad, n_real=n, n_attrs=n_attrs,
        n_cat_bins=n_cat_bins, seed=seed)


# ---------------------------------------------------------------------------
# query path: probe -> gathered candidate scan -> exact re-rank
# ---------------------------------------------------------------------------

def ann_core(x: torch.Tensor, cents: torch.Tensor, cvalid: torch.Tensor,
             flat: torch.Tensor, build_qflat: torch.Tensor,
             gids: torch.Tensor, offsets: torch.Tensor,
             lengths: torch.Tensor, amax: torch.Tensor, *, n_probe: int,
             probe_pad: int, kprime: int, k_out: int, n_attrs: int,
             qdtype: str, tail_flat: Optional[torch.Tensor] = None,
             tail_qflat: Optional[torch.Tensor] = None,
             tail_gids: Optional[torch.Tensor] = None,
             tail_lengths: Optional[torch.Tensor] = None,
             tail_cap: int = 0, in_range: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe selection, the per-probe gathered candidate scan with the
    running (metric, id) top-k′, and the exact f32 re-rank. Returns the
    PRE-finalize sorted key: exact f32 metric with ``BIG`` sentinels,
    train ids with ``INT_BIG`` sentinels, ``k_out`` columns.

    Overflow tails (``tail_cap > 0``): ``tail_flat`` / ``tail_qflat`` are
    ``[L·tail_cap, D]``, list ``li``'s tail the rows ``[li·tail_cap,
    (li+1)·tail_cap)``, ``tail_gids`` −1 on padding as the main spans,
    ``tail_lengths[li]`` its real rows. A probed list's tail enters the
    same merge as its main span; its positions ride as ``n_pad_rows +
    tail row``, so the re-rank reads them from the tail table.
    ``tail_cap = 0`` is the frozen index's query.

    ``in_range`` (int8): whether ``max|x| <= amax``, known to a caller
    that holds the queries on the host; None reads it from the card."""
    dev = x.device
    n_pad_rows = flat.shape[0]
    last_row = max(n_pad_rows - 1, 0)

    # 1. the n_probe nearest valid centroids; a stable sort keeps ties in
    # centroid-id order
    c2 = (cents * cents).sum(dim=1).reshape(1, -1)
    cd = c2 - 2.0 * (x @ cents.T)                          # [M, L]
    cd = torch.where(cvalid.reshape(1, -1), cd, torch.full_like(cd, BIG))
    probe_ids = torch.sort(cd, dim=1, stable=True).indices[:, :n_probe]

    # 2. candidate scan at the JOINT scale (train amax ∨ this chunk's):
    # while the chunk stays within the train's magnitudes the joint scale
    # is the build scale and the prebuilt int8 tables serve as they are
    # (a live index keeps amax over its base and tail rows)
    tail_q = tail_flat
    if qdtype == "int8":
        amax_x = x.abs().max() if x.numel() else torch.zeros_like(amax)
        s = int8_scale(torch.maximum(amax, amax_x))
        xq = _q8(x, s)
        if in_range is None:
            in_range = bool(amax_x <= amax)
        qflat = build_qflat if in_range else _q8(flat, s)
        if tail_cap:
            tail_q = tail_qflat if in_range else _q8(tail_flat, s)
    else:
        xq, qflat = x, flat          # bf16 rounding inside the metric
    iota = torch.arange(probe_pad, device=dev).reshape(1, -1)
    t_iota = torch.arange(tail_cap, device=dev).reshape(1, -1)
    sentinel = order_key(torch.tensor(BIG, device=dev),
                         torch.tensor(INT_BIG, device=dev))

    def scan(r0: int, r1: int) -> Tuple[torch.Tensor, torch.Tensor]:
        best = sentinel.expand(r1 - r0, kprime)
        best_p = torch.zeros((r1 - r0, kprime), dtype=torch.long,
                             device=dev)
        for p in range(n_probe):
            pid = probe_ids[r0:r1, p]
            pos = torch.clamp(offsets[pid].long().reshape(-1, 1) + iota, 0,
                              last_row)                     # [rows, LP]
            g = gids[pos]
            metric = gathered_candidate_metric(xq[r0:r1], qflat[pos],
                                               qdtype)
            # a slot is a candidate only within its own list's real rows:
            # past a short list the gather reads the next list, whose rows
            # would otherwise enter twice
            found = (iota < lengths[pid].reshape(-1, 1)) & (g >= 0)
            keys = torch.where(found,
                               order_key(metric, torch.clamp(g, min=0)),
                               sentinel)
            if tail_cap:
                tpos = pid.long().reshape(-1, 1) * tail_cap + t_iota
                tg = tail_gids[tpos]
                tmetric = gathered_candidate_metric(xq[r0:r1], tail_q[tpos],
                                                    qdtype)
                tfound = ((t_iota < tail_lengths[pid].reshape(-1, 1))
                          & (tg >= 0))
                tkeys = torch.where(
                    tfound, order_key(tmetric, torch.clamp(tg, min=0)),
                    sentinel)
                keys = torch.cat([keys, tkeys], dim=1)
                pos = torch.cat([pos, n_pad_rows + tpos], dim=1)
            best, at = merge_keys(best, keys, kprime)
            best_p = torch.gather(torch.cat([best_p, pos], dim=1), 1, at)

        # 3. exact f32 re-rank of the survivors, the flat-table position
        # riding with each id (past n_pad_rows: a tail row)
        cand_g = key_ids(best)
        found = best < sentinel
        yc = flat[torch.clamp(best_p, 0, last_row)]         # [rows, K', D]
        if tail_cap:
            in_tail = (best_p >= n_pad_rows).unsqueeze(-1)
            tail_yc = tail_flat[torch.clamp(best_p - n_pad_rows, 0,
                                            max(tail_flat.shape[0] - 1, 0))]
            yc = torch.where(in_tail, tail_yc, yc)
        em = exact_candidate_metric(x[r0:r1], yc, n_attrs)
        em = torch.where(found, em, torch.full_like(em, BIG))
        gkey = torch.where(found, cand_g, torch.full_like(cand_g, INT_BIG))
        return sort_pairs(em, gkey, k_out)

    # test rows in chunks of at most SLAB gathered elements
    parts = [scan(r0, r1) for r0, r1 in
             row_chunks(x.shape[0],
                        (probe_pad + tail_cap) * max(flat.shape[1], 1))]
    if not parts:
        empty = torch.empty((0, k_out), device=dev)
        return empty, empty.to(torch.int32)
    return (torch.cat([m for m, _ in parts]),
            torch.cat([g for _, g in parts]))


def _k_sizes(n: int, k: int, oversample: int) -> Tuple[int, int]:
    """(k_eff, kprime) for ``n`` indexed rows."""
    k_eff = max(min(k, n), 1)
    return k_eff, min(max(oversample * k_eff, k_eff), max(n, 1))


def ann_topk(index: IvfIndex, x_num: Optional[ArrayLike],
             x_cat: Optional[ArrayLike] = None, *, k: int,
             n_probe: int = 0, oversample: int = 4, qdtype: str = "int8",
             distance_scale: int = 1000
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query the index on its device: a drop-in for
    ``quantized.quantized_topk`` over the same normalized features —
    (scaled-int distances [M, min(k, N)], train row ids, (INT_BIG, -1)
    where the probed lists held too few rows). ``n_probe=0`` takes
    :func:`default_nprobe`; ``n_probe == nlist`` probes every list and
    gives the brute-force quantized result (int8)."""
    check_params(qdtype, oversample)
    if n_probe == 0:
        n_probe = default_nprobe(index.nlist)
    if not 1 <= n_probe <= index.nlist:
        raise ValueError(
            f"n_probe must be in [1, nlist={index.nlist}], got {n_probe}")
    x_num, x_cat = (as_tensor(a, index.device) for a in (x_num, x_cat))
    x = encode_mixed(x_num, x_cat, index.n_cat_bins)
    k_eff, kprime = _k_sizes(index.n_real, k, oversample)
    return finalize_quantized(
        *ann_core(x, index.centroids, index.cent_valid, index.flat,
                  index.qflat, index.gids, index.offsets, index.lengths,
                  index.amax, n_probe=n_probe, probe_pad=index.probe_pad,
                  kprime=kprime, k_out=k_eff, n_attrs=index.n_attrs,
                  qdtype=qdtype),
        distance_scale)


def live_ann_topk(index: IvfIndex, x: torch.Tensor, tail_flat: torch.Tensor,
                  tail_qflat: torch.Tensor, tail_gids: torch.Tensor,
                  tail_lengths: torch.Tensor, *, tail_cap: int, n_rows: int,
                  k: int, n_probe: int, oversample: int = 4,
                  qdtype: str = "int8", distance_scale: int = 1000,
                  in_range: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live index's query (``_live_ann_query`` of the JAX package):
    :func:`ann_topk` over the base index and its overflow tails, on
    encoded queries ``x`` on the index's device. ``n_rows`` counts the
    base and tail rows (k and k′ are sized by it); appended rows carry
    ids ``n_real .. n_rows − 1``. With empty tails the result is the
    frozen index's."""
    k_eff, kprime = _k_sizes(n_rows, k, oversample)
    return finalize_quantized(
        *ann_core(x, index.centroids, index.cent_valid, index.flat,
                  index.qflat, index.gids, index.offsets, index.lengths,
                  index.amax, n_probe=n_probe, probe_pad=index.probe_pad,
                  kprime=kprime, k_out=k_eff, n_attrs=index.n_attrs,
                  qdtype=qdtype, tail_flat=tail_flat, tail_qflat=tail_qflat,
                  tail_gids=tail_gids, tail_lengths=tail_lengths,
                  tail_cap=tail_cap, in_range=in_range),
        distance_scale)
