"""Class-balancing and bagging samplers on torch tensors.

Counterpart of ``avenir_tpu/explore/sampling.py`` (``under_sample``,
``_streaming_keep_probs``, ``under_sample_streaming``, ``bagging_sample``):

- ``under_sample``: UnderSamplingBalancer — majority-class rows are kept
  with probability minClassCount/classCount, from the exact class counts
  of the whole table, in one vectorized draw;
- ``under_sample_streaming``: the reference's running-count semantics
  (``streaming.bootstrap=true``): the first ``bootstrap_rows`` rows use
  the counts as of the bootstrap row, every later row its own prefix
  counts. DEVIATION (documented, as in the JAX package): the reference's
  held-batch drain emits the current row for every held row; here each
  held row is emitted as itself, corrected to intent;
- ``bagging_sample``: BaggingSampler — within each consecutive
  ``batch_size`` window, ``batch_size`` rows drawn with replacement.

The draws are JAX's threefry bits (``utils/jrandom.py``), so for the same
seed the same rows survive as in the JAX package. The class counts are
int64 (the JAX package sums an f32 one-hot, exact below 2^24 rows a
class); the keep probability divides them in f32, as JAX does, so the
comparison with the uniform draw sees the same float.
"""

from __future__ import annotations

import torch

from avenir_tpu_torch.utils import jrandom


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def under_sample(labels: torch.Tensor, key: torch.Tensor,
                 n_classes: int) -> torch.Tensor:
    """Boolean keep-mask balancing classes toward the minority count."""
    counts = torch.bincount(labels.long(), minlength=n_classes)[:n_classes]
    present = counts > 0
    min_count = counts[present].min()
    keep_prob = torch.where(counts > min_count,
                            _f32(min_count) / _f32(counts),
                            torch.ones_like(_f32(counts)))
    row_prob = keep_prob[labels.long()]
    return jrandom.uniform(key, tuple(labels.shape)) < row_prob


def _streaming_keep_probs(labels: torch.Tensor, n_classes: int,
                          bootstrap_rows: int) -> torch.Tensor:
    """Per-row keep probabilities under the reference's streaming
    bootstrap (UnderSamplingBalancer.java:92-131): the first
    ``bootstrap_rows`` rows are held and use the class counts as of the
    bootstrap row; every later row uses the running prefix counts at its
    own position. minCount at each point is the smallest count among the
    classes seen so far."""
    labels = labels.long()
    n = labels.shape[0]
    oh = torch.nn.functional.one_hot(labels, n_classes)
    cum = torch.cumsum(oh, dim=0)                    # counts AFTER each row
    b = min(max(bootstrap_rows - 1, 0), max(n - 1, 0))
    pos = torch.clamp(torch.arange(n, device=labels.device), min=b)
    eff = cum[pos]                                   # [N, C]
    big = torch.iinfo(torch.int32).max
    min_count = torch.where(eff > 0, eff, torch.full_like(eff, big)
                            ).min(dim=1).values
    cnt = eff.gather(1, labels.reshape(-1, 1))[:, 0]
    return torch.where(cnt > min_count, _f32(min_count) / _f32(cnt),
                       torch.ones_like(_f32(cnt)))


def under_sample_streaming(labels: torch.Tensor, key: torch.Tensor,
                           n_classes: int, bootstrap_rows: int
                           ) -> torch.Tensor:
    """Keep-mask with the reference's streaming-bootstrap count estimates
    (``streaming.bootstrap=true``)."""
    probs = _streaming_keep_probs(labels, n_classes, bootstrap_rows)
    return jrandom.uniform(key, tuple(labels.shape)) < probs


def bagging_sample(n_rows: int, key: torch.Tensor,
                   batch_size: int = 10000) -> torch.Tensor:
    """Row indices (int64, on ``key``'s device): per window of
    ``batch_size``, uniform with replacement within the window (the last
    partial window samples within itself)."""
    n_full = n_rows // batch_size
    rem = n_rows - n_full * batch_size
    key_full, key_rem = jrandom.split(key)
    parts = []
    if n_full:
        # one draw for all full windows, offset per window
        idx = jrandom.randint(key_full, (n_full, batch_size), 0,
                              batch_size).long()
        offsets = torch.arange(n_full, device=key.device).reshape(-1, 1)
        parts.append((idx + offsets * batch_size).reshape(-1))
    if rem:
        idx = jrandom.randint(key_rem, (rem,), 0, rem).long()
        parts.append(n_full * batch_size + idx)
    return (torch.cat(parts) if parts
            else torch.zeros((0,), dtype=torch.int64, device=key.device))
