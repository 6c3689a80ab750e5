"""Test rows to the device: the chunked feed, the shard stage and the
power-of-two row buckets.

Counterpart of ``bucket_rows``, ``pad_rows`` and ``stage_table`` of
``avenir_tpu/parallel/pipeline.py`` (the IVF index pads each inverted list
to a bucket, ``ops/ivf.py``) and of its chunk loop (``DeviceFeed``) as
``models/knn.py`` uses it (``feed.chunk.rows``): test
rows reach the device in chunks. A table kept on the host is pinned once
and each chunk leaves it with a ``non_blocking`` copy, so a chunk's
transfer is queued on the stream ahead of its kernel instead of blocking
the host; a table already on the device is sliced. The JAX package pads
chunks to power-of-two buckets to keep its jit cache flat; PyTorch
compiles nothing per shape, so chunks keep their real row count. The
threaded, double buffered ``DeviceFeed`` is later work.

``stage_table`` moves a whole shard's table to the card on the prefetching
loader's worker thread (``native/prefetch.py``), on a stream of its own,
and ``claim_table`` hands it to the consumer's stream.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

#: the shape-bucket floor of the JAX package's staging paths
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
    """``t`` ready to be cut into chunks bound for ``device``: pinned when
    it lies on the host and the device is a card."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.contiguous().pin_memory()
    return t


def iter_chunks(tensors: Sequence[Optional[torch.Tensor]], chunk_rows: int,
                device: torch.device
                ) -> Iterator[Tuple[Optional[torch.Tensor], ...]]:
    """Yield the chunks, on ``device``, of consecutive row ranges of
    ``tensors`` (``None`` entries pass through)."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    sources = [None if t is None else _source(t, device) for t in tensors]
    n = next(t.shape[0] for t in sources if t is not None)
    for r0 in range(0, n, chunk_rows):
        yield tuple(None if t is None else
                    t[r0:r0 + chunk_rows].to(device, non_blocking=True)
                    for t in sources)


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
