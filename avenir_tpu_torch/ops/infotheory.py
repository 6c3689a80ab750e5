"""Information-theoretic statistics over count tensors, log0-safe.

Counterpart of ``avenir_tpu/ops/infotheory.py`` (``xlogx``, ``entropy``,
``mutual_information``): f32 torch on the counts' device, with the same
``where`` masking, so empty segments and classes contribute exactly 0.
The split statistics (gini, Hellinger, confidence ratio) come with the
tree slice.
"""

from __future__ import annotations

import math

import torch

LOG2 = math.log(2.0)


def xlogx(p: torch.Tensor) -> torch.Tensor:
    """p * log2(p) with 0*log0 := 0."""
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return torch.where(p > 0, p * torch.log(safe) / LOG2,
                       torch.zeros_like(p))


def entropy(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy (bits) of count vectors along ``dim``
    (AttributeSplitStat.java:387-394)."""
    total = counts.sum(dim=dim, keepdim=True)
    p = counts / torch.where(total > 0, total, torch.ones_like(total))
    return -xlogx(p).sum(dim=dim)


def mutual_information(joint: torch.Tensor) -> torch.Tensor:
    """I(X;Y) in bits from a [..., X, Y] joint count tensor — the pairwise
    MI of MutualInformation's reducer cleanup
    (MutualInformation.java:598-678)."""
    total = joint.sum(dim=(-2, -1), keepdim=True)
    p = joint / torch.where(total > 0, total, torch.ones_like(total))
    px = p.sum(dim=-1, keepdim=True)
    py = p.sum(dim=-2, keepdim=True)
    denom = px * py
    ok = (p > 0) & (denom > 0)
    safe_ratio = torch.where(
        ok, p / torch.where(denom > 0, denom, torch.ones_like(denom)),
        torch.ones_like(p))
    return torch.where(p > 0, p * torch.log(safe_ratio) / LOG2,
                       torch.zeros_like(p)).sum(dim=(-2, -1))
