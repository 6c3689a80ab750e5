"""JAX's threefry2x32 random bits, computed with torch integer ops.

The JAX package draws with ``jax.random`` (under its defaults: the
``threefry2x32`` implementation, ``jax_threefry_partitionable`` on, 64-bit
types off). Where a draw chooses what a job writes (the rows an
under-sampler keeps, the rows a bagging window repeats), the port must
compute the same bits to write the same file. This module computes them:

- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)``;
- ``split(key, num)``: ``jax.random.split``;
- ``random_bits(key, shape)``: 32 random bits a position;
- ``uniform(key, shape)``: f32 in [0, 1);
- ``randint(key, shape, lo, hi)``: int32 in [lo, hi) (``hi`` may be a
  tensor, broadcast against ``shape``);
- ``gumbel(key, shape)``: f32 standard Gumbel draws (JAX's default
  ``mode="low"``);
- ``categorical(key, logits)``: the Gumbel-max draw along the last axis;
- ``choice(key, n, p)``: ``jax.random.choice`` of one index of
  ``arange(n)`` with probabilities ``p``, with replacement.

A key is a ``[2]`` int64 tensor holding two unsigned 32-bit words. Each
word is held in an int64 and masked to 32 bits after every add and shift,
so the bits are the same on every device: on the card the draw runs where
its tensors live, and on the CPU it is the same function.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.utils.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
# threefry's key-schedule parity constant and the 2x32 rotations, as
# Salmon et al. (SC'11) give them and JAX uses them
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(d) for d in shape)


def prng_key(seed: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: JAX takes a Python int as an int64
    and, with 64-bit types off, keeps its low 32 bits, so the key is
    ``[0, seed mod 2^32]``."""
    seed = int(np.int64(seed))      # beyond int64 raises, as JAX does
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block of 20 rounds on the word pairs (x0, x1)
    under ``key``: five groups of four rounds, each group followed by the
    injection of the next key-schedule words and the group's number. The
    key schedule is built from the key's elements as tensor ops where the
    key lives, so a draw never reads its key to the host (on the card it
    never waits for the card)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK
    return x0, x1


def _counter_bits(key: torch.Tensor, shape: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words of threefry over the partitionable counter: the
    row-major position of each element as a 64-bit count, its high word in
    x0 and its low word in x1."""
    n = int(np.prod(shape, dtype=np.int64))
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, count >> 32, count & _MASK)
    return b0.reshape(shape), b1.reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a ``[num, 2]`` tensor of keys."""
    b0, b1 = _counter_bits(key, (num,))
    return torch.stack([b0, b1], dim=1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits a position (int64 in [0, 2^32)): the two words of
    the position's block XORed."""
    b0, b1 = _counter_bits(key, _shape(shape))
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1), the top 23 bits
    as the mantissa of a float in [1, 2), less one: exactly those 23 bits
    times 2^-23 (computed so, with no dtype view, which
    ``torch.func.vmap`` cannot map on every torch)."""
    return (random_bits(key, shape) >> 9).to(torch.float32) * 2.0 ** -23


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32: 64
    random bits a position (two subkeys' draws) reduced modulo the span
    with the 32-bit unsigned arithmetic JAX uses, whose products and sums
    wrap at 2^32. ``maxval`` may be an int32 tensor broadcast against
    ``shape`` (a bound a position, as a per-arm ring buffer's length)."""
    lo = int(np.int32(minval))
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    if isinstance(maxval, torch.Tensor):
        hi = maxval.to(torch.int64).to(higher.device)
        span = torch.where(hi > lo, (hi - lo) & _MASK,
                           torch.ones_like(hi))
        multiplier = (2 ** 16) % span
        multiplier = ((multiplier * multiplier) & _MASK) % span
    else:
        hi = int(np.int32(maxval))
        span = (hi - lo) & _MASK if hi > lo else 1
        multiplier = (2 ** 16) % span
        multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (offset + lo).to(torch.int32)


#: the smallest normal f32, the low end of the uniform a Gumbel draw takes
_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in JAX's default ``mode="low"``:
    ``-log(-log(u))`` of a uniform ``u`` in [tiny, 1), the logs XLA's CPU
    logarithm (``ops.infotheory.xla_log``), as the compiled draw rounds
    them."""
    from avenir_tpu_torch.ops.infotheory import xla_log
    u = uniform(key, shape) + _TINY
    u = torch.clamp(u, min=_TINY)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    first index of the largest ``gumbel + logits`` (int64)."""
    g = gumbel(key, tuple(logits.shape)).to(logits.device)
    return torch.argmax(g + logits, dim=-1)


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)``, one draw with replacement (a
    0-d int64): the compiled f32 cumulative sum of ``p`` (XLA's order,
    ``ops.infotheory.xla_cumsum``), its last element times ``1 - u``, and
    the count of cumulative sums below that (``searchsorted``, left, in
    JAX's sort order, where a NaN lies above every number: a NaN draw,
    from a NaN probability, counts every sum that is not NaN; no sum of
    probabilities is +inf)."""
    from avenir_tpu_torch.ops.infotheory import xla_cumsum
    if p.shape != (n,):
        raise ValueError(f"p must be a vector of {n} probabilities, "
                         f"got shape {tuple(p.shape)}")
    cum = xla_cumsum(p.float())
    r = cum[-1] * (1.0 - uniform(key, ()).to(cum.device))
    return (cum < torch.nan_to_num(r, nan=math.inf)).sum()
