"""Rows to the device: the threaded ``DeviceFeed``, the shard stage and
the power-of-two row buckets.

Counterpart of ``avenir_tpu/parallel/pipeline.py`` (``DeviceFeed``,
``FeedChunk``, ``FeedStats``, ``bucket_rows``, ``pad_rows``,
``stage_table``; the IVF index pads each inverted list to a bucket,
``ops/ivf.py``). Its ``submit`` pool comes with its callers, the JAX
package's multi-device layer (``parallel/data.py``, ``collective.py``).

:class:`DeviceFeed` stages chunk n+1 while the consumer computes on chunk
n: ``depth`` background threads, each bound to the feed's device, copy a
chunk's host arrays into pinned buffers of their own (kept from chunk to
chunk), copy those on a side stream of their own, and wait on that
copy's event (the JAX feed's ``block_until_ready``, on the staging
thread, never on the compute stream). The consumer's stream waits on the
same event and marks each array used by it (``record_stream``), so the
caching allocator hands no block back before the consumer's kernels
have read it; the host never waits for the compute stream. An error on a
staging thread re-raises in the consumer. Order is kept.

The JAX feed pads each chunk to a power-of-two bucket so its jit cache
stays small. PyTorch compiles nothing per shape, so chunks keep their real
row count.

Each staged chunk records a ``feed.h2d`` span, each consumer step a
``feed.compute`` span, and exhaustion publishes the ``feed.overlap_fraction``
gauge (the share of staging time hidden behind compute) to the telemetry
hub when it is live.

``stage_table`` moves a whole shard's table to the card on the prefetching
loader's worker thread (``native/prefetch.py``), on a stream of its own,
and ``claim_table`` hands it to the consumer's stream.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

#: the shape-bucket floor of the JAX package's staging paths (a
#: staged-table fingerprint carries it, ``plan/fingerprint.py``)
BUCKET_FLOOR = 512


def bucket_rows(n: int, floor: int = BUCKET_FLOOR) -> int:
    """Smallest power of two ≥ ``max(n, floor)``."""
    if n < 0:
        raise ValueError(f"negative row count {n}")
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def pad_rows(a: np.ndarray, bucket: int) -> np.ndarray:
    """``a`` with its leading axis zero-padded to ``bucket`` rows."""
    n = a.shape[0]
    if n == bucket:
        return a
    if n > bucket:
        raise ValueError(f"chunk of {n} rows exceeds bucket {bucket}")
    width = ((0, bucket - n),) + ((0, 0),) * (a.ndim - 1)
    return np.pad(a, width)


def _source(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` ready to be copied to ``device``: pinned when it lies on the
    host and the device is a card."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.contiguous().pin_memory()
    return t


@dataclass(frozen=True)
class FeedChunk:
    """One staged chunk: ``arrays`` on the feed's device, ``n_rows`` rows
    each."""

    arrays: Tuple[Optional[torch.Tensor], ...]
    n_rows: int
    index: int
    event: Optional[Any] = None     # the copy's CUDA event, None on the CPU


@dataclass
class FeedStats:
    """Transfer and compute accounting of one exhausted :class:`DeviceFeed`."""

    chunks: int = 0
    h2d_ms: float = 0.0      # staging time (pin + copy + its event)
    wait_ms: float = 0.0     # consumer time blocked on an unfinished stage
    compute_ms: float = 0.0  # consumer time between takes

    @property
    def overlap_fraction(self) -> float:
        """Share of staging time hidden behind consumer compute."""
        if self.h2d_ms <= 0.0:
            return 1.0
        return min(max(1.0 - self.wait_ms / self.h2d_ms, 0.0), 1.0)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


class DeviceFeed:
    """Iterate host chunks as :class:`FeedChunk`s on ``device``, ``depth``
    staged ahead on background threads.

    ``chunks`` yields tuples of per-chunk arrays (numpy or torch; ``None``
    entries pass through) sharing their leading (row) axis. An array
    already on ``device`` is handed through as it is. Single pass: iterate
    once, then read :meth:`stats`."""

    def __init__(self, chunks: Iterable[Sequence[Optional[Any]]], *,
                 depth: int = 2, device: DeviceLike = "cuda",
                 span_prefix: str = "feed"):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._chunks = iter(chunks)
        self._depth = depth
        self._device = resolve_device(device)
        self._prefix = span_prefix
        self._stats = FeedStats()
        self._stats_lock = threading.Lock()   # depth threads stage at once
        self._local = threading.local()
        self._consumed = False

    @classmethod
    def from_arrays(cls, arrays: Sequence[Optional[Any]], chunk_rows: int,
                    **kw) -> "DeviceFeed":
        """A feed over consecutive ``chunk_rows`` row ranges of
        ``arrays`` (the chunked-scoring entry)."""
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        present = [a for a in arrays if a is not None]
        if not present:
            raise ValueError("no arrays to feed")
        m = present[0].shape[0]
        if any(a.shape[0] != m for a in present):
            raise ValueError("feed arrays disagree on leading axis")

        def cut():
            for lo in range(0, m, chunk_rows):
                yield tuple(None if a is None else a[lo:lo + chunk_rows]
                            for a in arrays)
        return cls(cut(), **kw)

    # -- background stage ---------------------------------------------------
    def _bind_thread(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)

    def _side_stream(self):
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(
                device=self._device)
        return stream

    def _pinned(self, slot: int, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into this staging thread's pinned buffer of array
        ``slot``, grown as needed. A thread stages one chunk at a time and
        waits for its copy's event before the next, so the buffer is free
        again when the next chunk comes."""
        # every torch call here lets go of the GIL, and under busy Python
        # threads each one waits up to a switch interval (5 ms) to take it
        # back: the typed view of a (dtype, shape) is made once
        slots = getattr(self._local, "pinned", None)
        if slots is None:
            slots = self._local.pinned = {}
        buf, views = slots.get(slot, (None, {}))
        key = (t.dtype, tuple(t.shape))
        out = views.get(key)
        if out is None:
            nbytes = t.numel() * t.element_size()
            if buf is None or buf.numel() < nbytes:
                buf, views = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                         pin_memory=True), {}
                slots[slot] = (buf, views)
            out = views[key] = buf[:nbytes].view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    def _stage(self, chunk: Sequence[Optional[Any]], index: int) -> FeedChunk:
        t0 = time.perf_counter()
        tensors = [None if a is None else _as_tensor(a) for a in chunk]
        present = [t for t in tensors if t is not None]
        if not present:
            raise ValueError(f"feed chunk {index} has no arrays")
        n = int(present[0].shape[0])
        dev = self._device
        event = None
        if dev.type == "cuda":
            stream = self._side_stream()
            with torch.cuda.stream(stream):
                staged = tuple(
                    None if t is None else
                    t if t.device == dev else
                    self._pinned(slot, t).to(dev, non_blocking=True)
                    for slot, t in enumerate(tensors))
                event = torch.cuda.Event()
                event.record(stream)
            event.synchronize()   # this thread only: the chunk is resident
        else:
            staged = tuple(None if t is None else t.to(dev) for t in tensors)
        ms = (time.perf_counter() - t0) * 1e3
        tracer = telemetry.tracer()
        if tracer.enabled:
            tracer.record(f"{self._prefix}.h2d", ms)
        with self._stats_lock:
            self._stats.h2d_ms += ms
        return FeedChunk(arrays=staged, n_rows=n, index=index, event=event)

    def _claim(self, chunk: FeedChunk) -> FeedChunk:
        """The consumer's stream waits on the copy and owns its arrays."""
        if chunk.event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(chunk.event)
            for t in chunk.arrays:
                if t is not None and t.is_cuda:
                    t.record_stream(current)
        return chunk

    # -- consumer side ------------------------------------------------------
    def __iter__(self) -> Iterator[FeedChunk]:
        if self._consumed:
            raise RuntimeError("DeviceFeed is single-pass; build a new one")
        self._consumed = True
        tracer = telemetry.tracer()
        pending: list = []
        index = 0
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self._depth, thread_name_prefix="avenir-feed",
                initializer=self._bind_thread) as pool:
            try:
                for chunk in self._chunks:
                    pending.append(pool.submit(self._stage, chunk, index))
                    index += 1
                    if len(pending) >= self._depth:
                        break
                last_yield = None
                while pending:
                    fut = pending.pop(0)
                    t0 = time.perf_counter()
                    staged = fut.result()   # a staging error raises here
                    t1 = time.perf_counter()
                    self._stats.wait_ms += (t1 - t0) * 1e3
                    if last_yield is not None:
                        compute = (t0 - last_yield) * 1e3
                        self._stats.compute_ms += compute
                        if tracer.enabled:
                            tracer.record(f"{self._prefix}.compute", compute)
                    self._stats.chunks += 1
                    # top back up to depth before handing over control
                    # (never more: staged chunks hold device memory)
                    if len(pending) < self._depth:
                        nxt = next(self._chunks, None)
                        if nxt is not None:
                            pending.append(
                                pool.submit(self._stage, nxt, index))
                            index += 1
                    yield self._claim(staged)
                    last_yield = time.perf_counter()
            finally:
                for fut in pending:
                    fut.cancel()
                self._publish()

    def _publish(self) -> None:
        """Exhaustion hook: the overlap gauge to the hub when it is live."""
        if not telemetry.tracer().enabled:
            return
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        set_hub_gauges_if_live({f"{self._prefix}.overlap_fraction":
                                self._stats.overlap_fraction})

    def stats(self) -> FeedStats:
        return self._stats


def stage_table(table, device: DeviceLike = "cuda", bucket: bool = False):
    """``table`` with its arrays (binned, numeric, labels) on ``device``;
    ``n_rows`` and the host-side fields unchanged. Runs on the loader's
    worker thread: on a card, each array is pinned on the host and copied
    on a stream of this call's own, inside ``torch.cuda.device``, and the
    call returns once that stream has finished, so the table it hands over
    is whole (the JAX stage's ``block_until_ready``) while the copy
    overlaps the consumer's kernels on its stream. The consumer passes the
    table through :func:`claim_table` before it computes on it.

    ``bucket`` is the JAX stage's power-of-two row padding, which keeps its
    jit cache small. It pads nothing here: PyTorch compiles nothing per
    shape, and padded rows would cost K2 work on rows that are dropped.
    Each row is scored on its own, so the outputs are the same."""
    dev = resolve_device(device)
    arrays = (table.binned, table.numeric, table.labels)
    if dev.type == "cuda":
        stream = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            staged = [None if t is None else
                      _source(t, dev).to(dev, non_blocking=True)
                      for t in arrays]
        stream.synchronize()
    else:
        staged = [None if t is None else t.to(dev) for t in arrays]
    return replace(table, binned=staged[0], numeric=staged[1],
                   labels=staged[2], n_rows=table.n_rows)


def claim_table(table):
    """Mark a staged table's card arrays as used on the current stream, so
    that the caching allocator hands their blocks to no later copy before
    the kernels queued here have read them (they were allocated on the
    stage's stream)."""
    for t in (table.binned, table.numeric, table.labels):
        if t is not None and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
    return table
