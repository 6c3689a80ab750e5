"""The live ANN index: an IVF index that takes appended rows while it
serves queries.

Counterpart of ``avenir_tpu/models/live_ann.py`` (its numpy parts
copied). ``ops/ivf.py`` builds a frozen index, which any growth of the
table would rebuild in full. This index lives, with three mechanisms:

- **Overflow tails** (:meth:`LiveAnnIndex.append`): new rows land in
  per-list tails, ``tail_cap`` rows a list (a power of two, doubled on
  overflow), padded with id −1 as the main spans, and probed with them
  (``ivf.ann_core``'s tail arguments). The tails keep a host copy and
  buffers on the index's device: an append writes its rows into those
  buffers, and only a doubling allocates and uploads them again. The
  int8 tail is quantized at the index's scale; an appended row that
  raises ``max|y|`` re-quantizes the base and the tails once at the new
  joint scale, so full probing equals a fresh ``build_ivf`` over the
  union table exactly.
- **Background rebuild** (:meth:`LiveAnnIndex.make_train_fn`,
  :meth:`maybe_swap`): a lifecycle ``RetrainDaemon`` wave re-clusters
  the grown table (from the serving centroids when the list count holds)
  on a CUDA stream of its own and publishes it through the
  ``SnapshotRegistry`` while queries go on over the old index. The
  serving thread adopts the snapshot between query batches: the base
  swaps, the tails empty, and the rows appended after the snapshot was
  taken replay into the new tails, none lost, none twice.
- **Drift trigger**: every append feeds two signals to a
  ``lifecycle.drift.DriftMonitor``: the tails' fill (appended rows over
  the tail budget) and the list skew (the largest list over the mean,
  from the batch's list counts, K1 on the card through
  ``ivf.assign_counts``). A threshold crossed requests a wave. A batch
  too large for any legal tail rebuilds the index inline: the index
  never refuses rows.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import replace as _dc_replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live as _hub_gauges
from avenir_tpu_torch.ops import ivf
from avenir_tpu_torch.ops.distance import _INV_SQRT2, encode_mixed
from avenir_tpu_torch.ops.quantized import (
    ArrayLike, _q8, as_tensor, check_params, int8_scale)
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

#: snapshot leaf names in the registry's flatten order (sorted keys): the
#: registry stores leaves by position, so pack and unpack agree on it
_IVF_LEAVES = ("amax", "cent_valid", "centroids", "flat", "gids",
               "lengths", "offsets", "qflat")
_LEAF_DTYPES = {"amax": np.float32, "cent_valid": np.bool_,
                "centroids": np.float32, "flat": np.float32,
                "gids": np.int32, "lengths": np.int32, "offsets": np.int32,
                "qflat": np.int8}

#: manifest kind of a published index: a learner-state publisher sharing
#: the registry is never taken for an index
IVF_SNAPSHOT_KIND = "ivf-index"


def pack_ivf_index(index: ivf.IvfIndex) -> Dict[str, np.ndarray]:
    """The registry payload of an index: its tensors as host arrays (the
    statics ride in the manifest's ``extra``, :func:`ivf_index_extra`)."""
    return {name: np.asarray(getattr(index, name).cpu().numpy(),
                             _LEAF_DTYPES[name]) for name in _IVF_LEAVES}


def ivf_index_extra(index: ivf.IvfIndex) -> Dict[str, int]:
    """The index's statics for the snapshot manifest."""
    return {"nlist": int(index.nlist), "probe_pad": int(index.probe_pad),
            "n_real": int(index.n_real), "n_attrs": int(index.n_attrs),
            "n_cat_bins": int(index.n_cat_bins), "seed": int(index.seed)}


def unpack_ivf_index(leaves: Any, extra: Dict[str, Any],
                     device: DeviceLike = "cuda") -> ivf.IvfIndex:
    """An :class:`~avenir_tpu_torch.ops.ivf.IvfIndex` on ``device`` from a
    restored snapshot: ``leaves`` is the packed dict or the leaf list
    ``Snapshot.restore()`` returns (flatten order, sorted keys), ``extra``
    the manifest's statics."""
    dev = resolve_device(device)
    if isinstance(leaves, dict):
        arrs = {name: leaves[name] for name in _IVF_LEAVES}
    else:
        if len(leaves) != len(_IVF_LEAVES):
            raise ValueError(
                f"ivf-index snapshot has {len(leaves)} leaves, expected "
                f"{len(_IVF_LEAVES)}")
        arrs = dict(zip(_IVF_LEAVES, leaves))

    def leaf(name):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(arrs[name], _LEAF_DTYPES[name]))).to(dev)
    return ivf.IvfIndex(
        centroids=leaf("centroids"), cent_valid=leaf("cent_valid"),
        flat=leaf("flat"), qflat=leaf("qflat"), gids=leaf("gids"),
        offsets=leaf("offsets"), lengths=leaf("lengths"),
        amax=leaf("amax").reshape(()),
        nlist=int(extra["nlist"]), probe_pad=int(extra["probe_pad"]),
        n_real=int(extra["n_real"]), n_attrs=int(extra["n_attrs"]),
        n_cat_bins=int(extra["n_cat_bins"]), seed=int(extra["seed"]))


def _pow2_at_least(n: int, floor: int) -> int:
    m = max(int(floor), 1)
    while m < n:
        m *= 2
    return m


def _host(a: Optional[ArrayLike], dtype=None) -> Optional[np.ndarray]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def _encoded_amax(x_num: Optional[np.ndarray], x_cat: Optional[np.ndarray],
                  n_cat_bins: int) -> float:
    """``max|encode_mixed(x_num, x_cat)|`` from host arrays: the numeric
    magnitudes, and the one-hot's 1/√2 where any code is in range."""
    amax = 0.0
    if x_num is not None and x_num.size:
        amax = float(np.max(np.abs(x_num.astype(np.float32))))
    if x_cat is not None and x_cat.size and bool(
            np.any((x_cat >= 0) & (x_cat < n_cat_bins))):
        amax = max(amax, _INV_SQRT2)
    return amax


class LiveAnnIndex:
    """An IVF index on ``device`` that takes appends while it serves.

    One writer: ``append``, ``maybe_swap``, ``adopt`` and ``query`` run
    on the serving thread; the rebuild's ``train_fn`` (a
    ``RetrainDaemon`` worker) only reads the row ledger, under ``_lock``.
    The serving state is one tuple (:attr:`_live`) that a query reads
    once; an append writes its rows into the tail buffers in the serving
    stream's order, after every query queued before it."""

    def __init__(self, y_num: Optional[ArrayLike],
                 y_cat: Optional[ArrayLike] = None, *, n_cat_bins: int = 0,
                 nlist: int = 0, n_iters: int = 15, seed: int = 0,
                 tail_budget: int = 1024,
                 rebuild_tail_fill: float = 0.5,
                 rebuild_skew: float = 8.0,
                 cooldown_s: float = 0.0,
                 registry=None, device: DeviceLike = "cuda"):
        from avenir_tpu_torch.lifecycle.drift import (
            DriftMonitor, ThresholdDetector)
        if tail_budget < ivf._LIST_FLOOR:
            raise ValueError(
                f"tail_budget must be >= {ivf._LIST_FLOOR}, got "
                f"{tail_budget}")
        self.device = resolve_device(device)
        self._nlist_cfg = int(nlist)
        self._n_iters = int(n_iters)
        self._seed = int(seed)
        self._n_cat_bins = int(n_cat_bins)
        self.tail_budget = _pow2_at_least(tail_budget, ivf._LIST_FLOOR)
        self._lock = threading.RLock()
        self._tel = telemetry.tracer()
        self._chunks: List[Tuple[Optional[np.ndarray],
                                 Optional[np.ndarray], int]] = []
        self.version = 0
        self.swaps = 0
        self.appended_rows = 0
        self.inline_rebuilds = 0
        self.rebuild_requests = 0
        # tail buffers allocated and uploaded whole (an install, a
        # doubling); an append that fits writes its rows only
        self.tail_uploads = 0
        self._on_rebuild = None
        self._watcher = None
        self._registry = registry
        # the rebuild's own stream, and its finish event the serving
        # stream waits on before it reads an adopted index
        self._wave_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._wave_done: Optional[torch.cuda.Event] = None
        if registry is not None:
            self._watcher = registry.subscribe()
        self.monitor = DriftMonitor(
            {"ann.tail_fill": ThresholdDetector(rebuild_tail_fill),
             "ann.list_skew": ThresholdDetector(rebuild_skew)},
            on_drift=self._request_rebuild, cooldown_s=cooldown_s)
        self._push_ledger(y_num, y_cat)
        index = ivf.build_ivf(
            y_num, y_cat, n_cat_bins=n_cat_bins, nlist=self._nlist_cfg,
            n_iters=n_iters, seed=seed, device=self.device)
        self._install_base(index)

    # -- wiring --------------------------------------------------------------

    def bind_daemon(self, daemon) -> None:
        """Route drift-triggered rebuild requests to a RetrainDaemon (its
        ``request`` wakes the background wave)."""
        self._on_rebuild = daemon.request

    def _request_rebuild(self) -> None:
        self.rebuild_requests += 1
        _hub_gauges({"ann.rebuild_requests": self.rebuild_requests})
        if self._on_rebuild is not None:
            self._on_rebuild()

    # -- row ledger ----------------------------------------------------------

    def _push_ledger(self, y_num, y_cat) -> int:
        num = _host(y_num, np.float32)
        cat = _host(y_cat)
        n = int((num if num is not None else cat).shape[0])
        if self._chunks:
            head_num, head_cat, _ = self._chunks[0]
            if (head_num is None) != (num is None) or \
                    (head_cat is None) != (cat is None):
                raise ValueError(
                    "appended batch feature split (numeric/categorical) "
                    "does not match the table this index was built over")
        self._chunks.append((num, cat, n))
        return n

    def _ledger_rows(self, start: int
                     ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Rows ``[start:]`` of the ledger as concatenated host arrays."""
        nums, cats = [], []
        off = 0
        for num, cat, n in self._chunks:
            lo = max(start - off, 0)
            if lo < n:
                if num is not None:
                    nums.append(num[lo:])
                if cat is not None:
                    cats.append(cat[lo:])
            off += n
        return (np.concatenate(nums) if nums else None,
                np.concatenate(cats) if cats else None)

    # -- device state --------------------------------------------------------

    def _install_base(self, index: ivf.IvfIndex,
                      tail_cap: Optional[int] = None) -> None:
        """Adopt ``index`` as the serving base with empty tails."""
        cap = _pow2_at_least(tail_cap or ivf._LIST_FLOOR, ivf._LIST_FLOOR)
        L, d = index.nlist, index.d
        self._t_flat = np.zeros((L, cap, d), np.float32)
        self._t_gids = np.full((L, cap), -1, np.int32)
        self._t_len = np.zeros(L, np.int32)
        self._tail_cap = cap
        self._amax = float(index.amax.cpu())
        self._counts = index.lengths.cpu().numpy().astype(np.int64)
        self._upload_tails(index)

    def _upload_tails(self, index: ivf.IvfIndex) -> None:
        """Allocate the tail buffers on the device from the host tails and
        publish the serving tuple (an install, a doubling)."""
        L, cap = self._t_len.shape[0], self._tail_cap
        flat = torch.from_numpy(self._t_flat.reshape(L * cap, -1)) \
            .to(self.device)
        qflat = _q8(flat, int8_scale(index.amax))
        gids = torch.from_numpy(self._t_gids.reshape(L * cap)) \
            .to(self.device)
        lens = torch.from_numpy(self._t_len.copy()).to(self.device)
        self.tail_uploads += 1
        self._publish(index, flat, qflat, gids, lens)

    def _publish(self, index, flat, qflat, gids, lens) -> None:
        self._live = (index, flat, qflat, gids, lens, self._tail_cap,
                      self._amax, index.n_real + int(self._t_len.sum()))

    @property
    def index(self) -> ivf.IvfIndex:
        return self._live[0]

    @property
    def tail_cap(self) -> int:
        return self._live[5]

    @property
    def n_total(self) -> int:
        return self.index.n_real + int(self._t_len.sum())

    @property
    def tail_fill(self) -> float:
        """The share of the tail budget in use: the rebuild pressure
        (monotone between rebuilds)."""
        L = self._t_len.shape[0]
        return float(self._t_len.sum()) / float(L * self.tail_budget)

    @property
    def list_skew(self) -> float:
        """The largest list over the mean: the imbalance signal."""
        total = int(self._counts.sum())
        if total <= 0:
            return 0.0
        return float(self._counts.max()) * len(self._counts) / total

    # -- append path ---------------------------------------------------------

    def append(self, y_num: Optional[ArrayLike],
               y_cat: Optional[ArrayLike] = None) -> Dict[str, Any]:
        """File a batch of new rows into the overflow tails: host
        placement of the batch and a write of its rows into the tail
        buffers, no rebuild (unless the batch overflows the tail budget,
        which rebuilds inline). Returns the append's stats with the drift
        signals."""
        with self._lock:
            n_batch = self._push_ledger(y_num, y_cat)
        with telemetry.span("knn.ann.live.append"):
            return self._append_tail(_host(y_num, np.float32), _host(y_cat),
                                     n_batch)

    def _append_tail(self, y_num: Optional[np.ndarray],
                     y_cat: Optional[np.ndarray],
                     n_batch: int) -> Dict[str, Any]:
        index = self.index
        y = encode_mixed(as_tensor(y_num, self.device),
                         as_tensor(y_cat, self.device), index.n_cat_bins)
        assign_d, _counts_d = ivf.assign_counts(y, index.centroids)
        assign = assign_d.cpu().numpy().astype(np.int64)
        encoded = y.cpu().numpy()
        with self._lock:
            L = index.nlist
            batch_counts = np.bincount(assign, minlength=L)
            new_fill = self._t_len + batch_counts
            needed = _pow2_at_least(int(new_fill.max()), self._tail_cap)
            if needed > self.tail_budget:
                # no legal tail holds the batch: rebuild the base over the
                # union inline
                self._request_rebuild()
                self._rebuild_inline()
                return self._stats(n_batch, inline=True)
            grown = needed > self._tail_cap
            if grown:
                old = self._tail_cap
                grown_f = np.zeros((L, needed, encoded.shape[1]),
                                   np.float32)
                grown_g = np.full((L, needed), -1, np.int32)
                grown_f[:, :old] = self._t_flat
                grown_g[:, :old] = self._t_gids
                self._t_flat, self._t_gids = grown_f, grown_g
                self._tail_cap = needed
            # each list's rows in batch order: ids ascend within a tail
            order = np.argsort(assign, kind="stable")
            starts = np.zeros(L, np.int64)
            starts[1:] = np.cumsum(batch_counts)[:-1]
            gid0 = self.n_total
            gids_new = gid0 + np.arange(n_batch, dtype=np.int64)
            slots = np.empty(n_batch, np.int64)
            for li in np.nonzero(batch_counts)[0]:
                c = int(batch_counts[li])
                rows = order[starts[li]:starts[li] + c]
                base = int(self._t_len[li])
                self._t_flat[li, base:base + c] = encoded[rows]
                self._t_gids[li, base:base + c] = gids_new[rows]
                slots[rows] = li * self._tail_cap + base + np.arange(c)
            self._t_len = (self._t_len + batch_counts).astype(np.int32)
            self._counts += batch_counts
            self.appended_rows += n_batch
            bmax = float(np.max(np.abs(encoded))) if n_batch else 0.0
            rescaled = bmax > self._amax
            if rescaled:
                # the joint scale: re-quantize the base at the union's max,
                # so its int8 bytes are a fresh build's over the union
                self._amax = bmax
                amax = torch.tensor(bmax, dtype=torch.float32,
                                    device=self.device)
                index = _dc_replace(index, amax=amax,
                                    qflat=_q8(index.flat, int8_scale(amax)))
            if grown:
                self._upload_tails(index)
            else:
                self._write_rows(index, slots, y, gids_new, rescaled)
            return self._stats(n_batch, inline=False)

    def _write_rows(self, index: ivf.IvfIndex, slots: np.ndarray,
                    y: torch.Tensor, gids_new: np.ndarray,
                    rescaled: bool) -> None:
        """The batch's rows into the tail buffers, in place."""
        _, flat, qflat, gids, lens, _, _, _ = self._live
        at = torch.from_numpy(slots).to(self.device)
        flat[at] = y
        scale = int8_scale(index.amax)
        if rescaled:
            qflat = _q8(flat, scale)
        else:
            qflat[at] = _q8(y, scale)
        gids[at] = torch.from_numpy(gids_new.astype(np.int32)) \
            .to(self.device)
        lens.copy_(torch.from_numpy(self._t_len))
        self._publish(index, flat, qflat, gids, lens)

    def _stats(self, n_batch: int, *, inline: bool) -> Dict[str, Any]:
        fill, skew = self.tail_fill, self.list_skew
        self.monitor.observe("ann.tail_fill", fill)
        self.monitor.observe("ann.list_skew", skew)
        _hub_gauges({"ann.tail_fill": fill, "ann.list_skew": skew,
                     "ann.tail_rows": float(self._t_len.sum()),
                     "ann.index_version": float(self.version),
                     "ann.rows_total": float(self.n_total)})
        return {"appended": n_batch, "tail_fill": fill, "list_skew": skew,
                "tail_cap": self._tail_cap, "inline_rebuild": inline,
                "n_total": self.n_total}

    # -- rebuild and swap ----------------------------------------------------

    def _rebuild_inline(self) -> None:
        index = self._build_union_from(*self._ledger_rows(0))
        self.inline_rebuilds += 1
        self.version += 1
        self._install_base(index)

    def make_train_fn(self):
        """The RetrainDaemon's wave: copy the ledger under the lock,
        re-cluster on the wave's own stream (from the serving centroids
        when the list count holds), and hand the registry the index's
        host arrays and the manifest's statics. It never touches the
        serving state."""
        def train() -> Dict[str, Any]:
            with self._lock:
                num, cat = self._ledger_rows(0)
                n_snap = self.n_total
            stream = contextlib.nullcontext()
            if self._wave_stream is not None:
                # the wave starts behind what the serving stream queued
                # (the centroids it reads), then runs beside it
                self._wave_stream.wait_stream(
                    torch.cuda.default_stream(self.device))
                stream = torch.cuda.stream(self._wave_stream)
            with stream:
                index = self._build_union_from(num, cat)
                pytree = pack_ivf_index(index)
                if self._wave_stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._wave_stream)
                    self._wave_done = done
            extra = ivf_index_extra(index)
            extra["n_snapshot"] = n_snap
            return {"pytree": pytree, "train_rows": n_snap,
                    "kind": IVF_SNAPSHOT_KIND, "extra": extra}
        return train

    def _build_union_from(self, num, cat) -> ivf.IvfIndex:
        n = int((num if num is not None else cat).shape[0])
        nlist = self._nlist_cfg or ivf.default_nlist(n)
        index = self.index
        init = (index.centroids.cpu().numpy()
                if nlist == index.nlist else None)
        return ivf.build_ivf(
            num, cat, n_cat_bins=self._n_cat_bins, nlist=nlist,
            n_iters=self._n_iters, seed=self._seed, init_centroids=init,
            device=self.device)

    def maybe_swap(self) -> Optional[int]:
        """Poll the registry for a rebuilt index and adopt it: call it
        between query batches, where a learner's state would swap. Returns
        the adopted version or None."""
        if self._watcher is None:
            return None
        snap = self._watcher.poll()
        if snap is None or snap.manifest.get("kind") != IVF_SNAPSHOT_KIND:
            return None
        t0 = time.perf_counter()
        self.adopt(snap.restore(), snap.manifest.get("extra") or {},
                   version=snap.version)
        from avenir_tpu_torch.lifecycle.swap import record_swap
        record_swap(self._tel, t0, snap.version, self.swaps)
        return snap.version

    def adopt(self, leaves: Any, extra: Dict[str, Any],
              version: Optional[int] = None) -> None:
        """Install a rebuilt index: swap the base, empty the tails, and
        replay every ledger row appended after the rebuild's snapshot
        into the new tails. A query queued before holds the old tuple;
        the next one reads the new."""
        if self._wave_done is not None:
            # the serving stream reads nothing the wave's stream may
            # still be writing
            torch.cuda.current_stream(self.device).wait_event(
                self._wave_done)
        index = unpack_ivf_index(leaves, extra, self.device)
        n_snap = int(extra.get("n_snapshot", index.n_real))
        with self._lock:
            replay_num, replay_cat = self._ledger_rows(n_snap)
            self._install_base(index)
            self.version = (version if version is not None
                            else self.version + 1)
            self.swaps += 1
        n_replay = 0
        if replay_num is not None or replay_cat is not None:
            n_replay = int((replay_num if replay_num is not None
                            else replay_cat).shape[0])
        if n_replay:
            self._append_tail(replay_num, replay_cat, n_replay)

    # -- query path ----------------------------------------------------------

    def query(self, x_num: Optional[ArrayLike],
              x_cat: Optional[ArrayLike] = None, *, k: int,
              n_probe: int = 0, oversample: int = 4, qdtype: str = "int8",
              distance_scale: int = 1000
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ivf.ann_topk`` over the base and the tails, with its checks,
        sizing and result (scaled-int distances, row ids; appended rows
        number ``n_base .. n_total − 1`` in append order, their rows in
        the union table). With no appends every tail candidate masks out
        and the result is the frozen index's. Queries given as host arrays
        read nothing back from the card."""
        index, t_flat, t_qflat, t_gids, t_len, cap, amax, n = self._live
        check_params(qdtype, oversample)
        if n_probe == 0:
            n_probe = ivf.default_nprobe(index.nlist)
        if not 1 <= n_probe <= index.nlist:
            raise ValueError(
                f"n_probe must be in [1, nlist={index.nlist}], got "
                f"{n_probe}")
        in_range = None
        if not isinstance(x_num, torch.Tensor) and \
                not isinstance(x_cat, torch.Tensor):
            in_range = _encoded_amax(x_num, x_cat, index.n_cat_bins) <= amax
        x = encode_mixed(as_tensor(x_num, self.device),
                         as_tensor(x_cat, self.device), index.n_cat_bins)
        return ivf.live_ann_topk(
            index, x, t_flat, t_qflat, t_gids, t_len, tail_cap=cap,
            n_rows=n, k=k, n_probe=n_probe, oversample=oversample,
            qdtype=qdtype, distance_scale=distance_scale, in_range=in_range)

    # -- provenance ----------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """The index's provenance for ``--explain`` and reports."""
        index = self.index
        return {"nlist": int(index.nlist), "version": int(self.version),
                "tail_fill": round(self.tail_fill, 6),
                "tail_rows": int(self._t_len.sum()),
                "tail_cap": int(self.tail_cap), "swaps": int(self.swaps),
                "n_rows": int(self.n_total),
                "rebuild_requests": int(self.rebuild_requests),
                "inline_rebuilds": int(self.inline_rebuilds)}


# ---------------------------------------------------------------------------
# the CLI's live slot: one slot, as models/knn.py's staged IVF cache
# ---------------------------------------------------------------------------

#: one-slot live-index cache of the CLI verb: the part-file loop scores
#: many test shards against one train table, and the live index (its
#: version, its tails) lives across them
_LIVE_SLOT: dict = {}


def live_index_for(train, config) -> LiveAnnIndex:
    """Build (or reuse) the live index of this train table and config,
    keyed as ``models.knn._staged_ann_index`` plus the tail budget."""
    from avenir_tpu_torch.models.knn import (
        _resolved_ann_params, _split_features)
    nlist, _ = _resolved_ann_params(train, config)
    key = (id(train), nlist, config.ann_iters, config.ann_seed,
           config.ann_live_tail_budget)
    hit = _LIVE_SLOT.get(key)
    if hit is not None and hit[0] is train:
        return hit[1]
    tr_num, tr_cat, n_bins = _split_features(train)
    with telemetry.span("knn.ann.build"):
        live = LiveAnnIndex(
            tr_num, tr_cat, n_cat_bins=n_bins, nlist=nlist,
            n_iters=config.ann_iters, seed=config.ann_seed,
            tail_budget=config.ann_live_tail_budget, device=train.device)
    _LIVE_SLOT.clear()
    _LIVE_SLOT[key] = (train, live)
    return live


def peek_live_index() -> Optional[LiveAnnIndex]:
    """The live index in the slot, if any (``--explain``'s provenance)."""
    for _key, (_train, live) in _LIVE_SLOT.items():
        return live
    return None
