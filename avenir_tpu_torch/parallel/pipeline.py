"""Chunked feed of test rows to the device, and the power-of-two row
buckets.

Counterpart of ``bucket_rows`` and ``pad_rows`` of
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
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

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
