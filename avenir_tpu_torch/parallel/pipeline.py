"""Chunked feed of test rows to the device.

Counterpart of the chunk loop of ``avenir_tpu/parallel/pipeline.py``
(``DeviceFeed``) as ``models/knn.py`` uses it (``feed.chunk.rows``): test
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

import torch


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
