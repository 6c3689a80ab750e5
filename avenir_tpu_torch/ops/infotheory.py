"""Information-theoretic statistics over count tensors, log0-safe.

Counterpart of ``avenir_tpu/ops/infotheory.py``: ``xlogx``, ``entropy``,
``mutual_information``, and the decision tree's split statistics
(``gini``, ``weighted_segment_stat``, ``split_info_content``,
``intrinsic_info_content``, ``hellinger_distance``,
``class_confidence_ratio``, ``split_stat``). f32 torch on the counts'
device, with the same ``where`` masking, so empty segments and classes
contribute exactly 0.

Every statistic rounds each f32 operation as eager JAX does, and gives
the same bits on the CPU and on the GPU:

- ``log`` is XLA's CPU logarithm (``xla_log``: the Cephes polynomial with
  its fused multiply-adds, each computed in float64, where the product of
  two f32 values is exact, and rounded once), not torch's, which differs
  from it in the last bit for about one input in eight;
- sums over the short axes (classes, segments) run sequentially from
  index 0, so their order does not depend on the device; ``xla_sum``
  sums a long axis in the windows of XLA's compiled reduction;
- ``sqrt`` goes through float64, and the division by ln 2 divides by a
  tensor on the device, so both round correctly on the GPU too.

JAX's compiled kernels (``jit``) round differently: XLA contracts a
product into the add that consumes it and reduces a short minor axis as a
vector tree, so the JAX package's own jitted and eager statistics differ
in the last bit. The port's equal the eager ones exactly and the jitted
ones within a few ulps (the tree's level selection reproduces the
compiled gain ratio itself, ``models/tree._level_select``).

Boosting's compiled elementwise functions are reproduced bit for bit:
``xla_exp`` (XLA's CPU exponential), ``xla_sigmoid`` (its fusion, whose
last multiply contracts into the add of one) and ``xla_softplus``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG2 = math.log(2.0)

# XLA's CPU logarithm (the Cephes single-precision polynomial)
_MIN_NORM = 1.17549435e-38
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a hardware FMA rounds it.

    The product of two f32 values is exact in float64; the float64 sum is
    not when ``c`` lies far from it, and rounding that sum to f32 is a
    second rounding. It differs from the single one only where the sum
    lands exactly on a midpoint between two f32 values (its low 29
    mantissa bits 1 then zeros) while its TwoSum error is nonzero: there
    the sum steps one float64 ulp toward the error first (its bits move by
    the sign of error × sum), so the tie breaks the way the exact value
    lies. A subnormal addend counts as a zero of its sign, as XLA's CPU
    code reads it; a Python number stands for the f32 value it names.
    Under ``torch.func.vmap`` the same bits come from ``_fma_round_mapped``,
    which views no bits as another dtype."""
    a, b, c = _f64(a), _f64(b), _f64(c)
    if isinstance(c, torch.Tensor):
        c = c * (c.abs() >= _MIN_NORM)
    p = a * b
    s = torch.as_tensor(p + c)
    bp = s - c                                   # TwoSum: s + err == p + c
    err = (p - bp) + (c - (s - bp))
    if _mapped(s):
        return _fma_round_mapped(s, err)
    bits = s.view(torch.int64)
    tie = (bits & _F32_DROPPED) == _F32_HALF
    step = (tie * torch.sign(err * s)).to(torch.int64)
    return (bits + step).view(torch.float64).float()


def _fma_round_mapped(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """``fma``'s last rounding for tensors under ``torch.func.vmap``, which
    has no rule for a dtype view on every torch; the same bits. The sum
    lies midway between two f32 values iff its ``frexp`` mantissa times
    2^25 is an odd integer, and the step is a ``nextafter``."""
    tie = torch.remainder(torch.frexp(s)[0] * _F32_HALF_SCALE, 2.0) == 1.0
    step = torch.sign(err * s)                  # +1 away from 0, -1 toward
    away = torch.copysign(torch.full_like(s, math.inf), s)
    moved = torch.nextafter(s, torch.where(step > 0, away,
                                           torch.zeros_like(s)))
    return torch.where(tie & (step != 0), moved, s).float()


def _f64(x):
    """A tensor as float64; a Python number as the f32 value it names, kept
    a Python float (exact in float64), so it costs no tensor op."""
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


# the float64 mantissa bits an f32 rounding drops, and their midpoint
_F32_DROPPED, _F32_HALF = (1 << 29) - 1, 1 << 28
# the midpoint as _fma_round_mapped reads it: the frexp mantissa (53 bits
# in [0.5, 1)) times 2^25 is an odd integer
_F32_HALF_SCALE = float(1 << 25)

# a tensor that ``torch.func.vmap`` maps (its batched wrapper)
_mapped = torch._C._functorch.is_batchedtensor


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal f32 ``x``, bit for bit as XLA's CPU
    backend computes it: the mantissa in [sqrt(1/2), sqrt(2)) less one,
    a degree-8 polynomial in fused multiply-adds, the exponent added back
    in two parts of ln 2. NaN and +inf come back as themselves, as XLA
    gives them; a smaller ``x`` counts as the smallest normal f32."""
    x = torch.clamp(x.float(), min=_MIN_NORM)
    if _mapped(x):
        m, e = torch.frexp(x)               # m in [0.5, 1), x = m · 2^e
        e = e.float()
    else:
        bits = x.view(torch.int32)
        e = ((bits >> 23) - 126).float()
        m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < torch.full((), _SQRTHF, dtype=torch.float32)
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = fma(fma(m, p[0], p[1]), m, p[2])
    y1 = fma(fma(m, p[3], p[4]), m, p[5])
    y2 = fma(fma(m, p[6], p[7]), m, p[8])
    y = fma(fma(y, m3, y1), m3, y2)
    y = fma(y, m3, _LOG_Q1 * e)
    m = fma(-m2, 0.5, m)
    out = fma(_LOG_Q2, e, m + y)
    return torch.where(x < math.inf, out, x)


# XLA's CPU exponential (the Cephes single-precision polynomial)
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269502162933349609375
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 0.5)


def _xla_exp_parts(x: torch.Tensor):
    """(y, 2^n) with ``exp(x) = y · 2^n`` as XLA's CPU backend computes
    them: x clamped to [-87.8, 88.8], n = floor(x·log2 e + 0.5) clamped to
    [-127, 127] (2^-127 becomes 0 through the exponent bits, as there), the
    remainder reduced in two parts of ln 2 and a degree-5 polynomial in
    fused multiply-adds, plus one."""
    x = torch.clamp(x.float(), min=_EXP_LO, max=_EXP_HI)
    fx = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), min=-127.0,
                     max=127.0)
    r = fma(-fx, _EXP_C1, x)
    r = fma(-fx, _EXP_C2, r)
    y = torch.full_like(r, _EXP_P[0])
    for p in _EXP_P[1:]:
        y = fma(y, r, p)
    y = fma(y, r * r, r) + 1.0
    if _mapped(fx):
        # NaN (whose y is NaN) looks up 2^0
        n = torch.nan_to_num(fx, nan=0.0) + 127.0
        return y, _pow2_table(fx.device)[n.long()]
    pow2n = ((fx.to(torch.int32) << 23) + (127 << 23)).view(torch.float32)
    return y, pow2n


_POW2: dict = {}


def _pow2_table(device: torch.device) -> torch.Tensor:
    """2^n for n in [-127, 127] as the f32 whose exponent field is n + 127
    and whose mantissa is 0 (so 2^-127 is 0), on ``device``: the bits
    ``_xla_exp_parts`` builds, looked up under ``torch.func.vmap``, which
    has no rule for a dtype view on every torch."""
    table = _POW2.get(device)
    if table is None:
        host = np.ldexp(np.float32(1.0), np.arange(-127, 128)).astype(
            np.float32)
        host[0] = 0.0
        table = _POW2[device] = torch.from_numpy(host).to(device)
    return table


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of f32 ``x``, bit for bit as XLA's CPU backend computes it
    (``jnp.exp`` under ``jit``; a result below the smallest normal f32 is
    flushed to 0, as XLA's CPU code runs); torch's and CUDA's differ from
    it in the last bit for about one input in ten."""
    y, pow2n = _xla_exp_parts(x)
    out = y * pow2n
    return torch.where(out < _MIN_NORM, torch.zeros_like(out), out)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` under ``jit`` on the CPU, bit for bit: XLA fuses
    ``negate → exponential → add → divide``, and the exponential's last
    multiply contracts with the add of one into a fused multiply-add; a
    quotient below the smallest normal f32 is flushed to 0. The divisor is
    a tensor, so the CUDA division rounds correctly too."""
    y, pow2n = _xla_exp_parts(-x.float())
    out = torch.ones_like(y) / fma(y, pow2n, 1.0)
    return torch.where(out < _MIN_NORM, torch.zeros_like(out), out)


def xla_softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as XLA compiles it: ``max(x, 0) +
    log1p(exp(-|x|))`` (NaN passed through), with XLA's exponential; its
    ``log1p`` is torch's, which may differ from XLA's in the last bit."""
    x = x.float()
    out = torch.clamp(x, min=0.0) + torch.log1p(xla_exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def _sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sequential f32 sum along ``dim`` from index 0 (0 over an empty
    axis)."""
    x = x.movedim(dim, -1)
    acc = x.new_zeros(x.shape[:-1])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


#: XLA's CPU backend sums a reduced axis longer than this in windows of it
_XLA_REDUCE_WINDOW = 32


def _reduce_lanes(rows: int, inner: int) -> int:
    """The vector width XLA's CPU code gives the outer axis of a reduction
    over two or more axes (each at most 32 long): ``rows`` outer rows of
    ``inner`` elements each. Read off ``jnp.sum`` for every ``rows`` up to
    32 and ``inner`` from 2 to 12: none from 9 elements a row on; else 2,
    4 or 8 at that many rows, none for the other rows below 16, 4 from 16
    rows when a row holds 7 or 8 elements, and otherwise 8 except 4 at 20
    to 23 rows (and at 28 to 31 for 3 or more elements a row)."""
    if inner >= 9:
        return 1
    if rows in (2, 4, 8):
        return rows
    if rows < 16:
        return 1
    if inner >= 7 or 20 <= rows <= 23 or (28 <= rows <= 31
                                           and inner >= 3):
        return 4
    return 8


def xla_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """f32 sum over ``dim`` (an axis or a tuple of axes) in the order XLA's
    CPU backend compiles a reduction. Where every reduced axis holds at most
    32 elements, the elements are added one by one from 0 in row-major
    order, or over two or more axes with the outer one in vector lanes
    where XLA's code has them (``_reduce_lanes``). Otherwise its tree-reduction rewrite cuts each
    reduced axis into windows: an axis longer than 32 is padded with zeros
    to a multiple of 32 (half the pad in front) and cut in 32s, a shorter
    one is one window; each window block is summed in row-major order,
    then the block sums the same way."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = sorted(d % x.dim() for d in dims)
    k = len(dims)
    x = x.movedim(dims, list(range(x.dim() - k, x.dim())))
    sizes = x.shape[x.dim() - k:]
    w = _XLA_REDUCE_WINDOW
    if all(n <= w for n in sizes):
        rows = x.reshape(x.shape[:x.dim() - k]
                         + (sizes[0], math.prod(sizes[1:])))
        inner = rows.shape[-1]
        lanes = _reduce_lanes(sizes[0], inner) if inner > 1 else 1
        if lanes == 1:
            return _sum(rows.flatten(-2), -1)
        # the outer axis vectorized: row r adds into lane r % lanes, each
        # row's elements in order; the lanes are halved pairwise, and the
        # rows left over after the last full vector follow one by one
        main = sizes[0] - sizes[0] % lanes
        acc = rows.new_zeros(rows.shape[:-2] + (lanes,))
        for r in range(0, main, lanes):
            for c in range(inner):
                acc = acc + rows[..., r:r + lanes, c]
        while acc.shape[-1] > 1:
            half = acc.shape[-1] // 2
            acc = acc[..., :half] + acc[..., half:]
        acc = acc[..., 0]
        for r in range(main, sizes[0]):
            for c in range(inner):
                acc = acc + rows[..., r, c]
        return acc
    lead = x.shape[:x.dim() - k]
    pad, split = [], []
    for n in sizes:
        total = -(-n // w) * w if n > w else n
        front = (total - n) // 2
        pad = [front, total - n - front] + pad
        split += [total // min(n, w), min(n, w)]
    x = torch.nn.functional.pad(x, pad).reshape(lead + tuple(split))
    nl = len(lead)
    order = (list(range(nl)) + [nl + 2 * i for i in range(k)]
             + [nl + 2 * i + 1 for i in range(k)])
    blocks = x.permute(order)
    blocks = _sum(blocks.reshape(blocks.shape[:nl + k] + (-1,)), -1)
    return xla_sum(blocks, tuple(range(nl, nl + k)))


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with subnormal values flushed to a zero of their sign, as
    XLA's CPU code runs (its floating-point mode flushes every subnormal
    result)."""
    return torch.where(x.abs() < _MIN_NORM, x * 0.0, x)


def _ftz_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ftz(a * b)


def xla_prod(x: torch.Tensor) -> torch.Tensor:
    """f32 product over the last axis in the order of XLA's compiled CPU
    reduction, as ``xla_sum`` adds: an axis of at most 32 elements one by
    one from 1, a longer one padded with ones to a multiple of 32 (half
    the pad in front), each window of 32 in order, then the windows'
    products the same way; subnormal products flush to 0 (``ftz``)."""
    n = x.shape[-1]
    w = _XLA_REDUCE_WINDOW
    if n <= w:
        acc = torch.ones_like(x[..., 0])
        for i in range(n):
            acc = _ftz_mul(acc, x[..., i])
        return acc
    total = -(-n // w) * w
    front = (total - n) // 2
    x = torch.nn.functional.pad(x, [front, total - n - front], value=1.0)
    return xla_prod(xla_prod(x.reshape(x.shape[:-1] + (total // w, w))))


#: XLA's CPU backend rewrites a cumulative reduction longer than this into
#: blocks of it (its reduce-window rewriter's base length)
_XLA_SCAN_BASE = 16


def _xla_scan(x: torch.Tensor, op, identity: float) -> torch.Tensor:
    """Inclusive scan over the last axis as XLA's CPU code compiles
    ``jnp.cumsum``/``jnp.cumprod`` (a reduce-window): up to 16 elements in
    order from the identity; a longer axis padded at its end with the
    identity to a multiple of 16, scanned in rows of 16, the rows' last
    elements scanned the same way (recursively) and shifted one row, and
    each row's elements combined with the scan of the rows before it."""
    n = x.shape[-1]
    b = _XLA_SCAN_BASE
    if n <= b:
        out, acc = [], torch.full_like(x[..., 0], identity)
        for i in range(n):
            acc = op(acc, x[..., i])
            out.append(acc)
        return torch.stack(out, dim=-1)
    rows = -(-n // b)
    x = torch.nn.functional.pad(x, [0, rows * b - n], value=identity)
    within = _xla_scan(x.reshape(x.shape[:-1] + (rows, b)), op, identity)
    before = _xla_scan(within[..., -1], op, identity)
    before = torch.cat([torch.full_like(before[..., :1], identity),
                        before[..., :-1]], dim=-1)
    out = op(within, before[..., None])
    return out.reshape(x.shape)[..., :n]


def xla_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.cumsum`` along ``dim`` as XLA's CPU code compiles it
    (``_xla_scan``)."""
    return _xla_scan(x.movedim(dim, -1), torch.add, 0.0).movedim(-1, dim)


def xla_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.cumprod`` along ``dim`` as XLA's CPU code compiles it
    (``_xla_scan``), subnormal products flushed to 0 (``ftz``)."""
    return _xla_scan(x.movedim(dim, -1), _ftz_mul, 1.0).movedim(-1, dim)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 square root, correctly rounded on every device (through float64:
    CUDA's f32 ``sqrt`` differs from the CPU's in the last bit)."""
    return torch.sqrt(x.double()).float()


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0, t, torch.ones_like(t))


def _over_log2(x: torch.Tensor) -> torch.Tensor:
    """``x / ln 2``, correctly rounded: the divisor is a tensor on ``x``'s
    device, since CUDA divides by a host scalar as a multiply by its
    reciprocal, which the CPU does not."""
    return x / torch.full((), LOG2, dtype=x.dtype, device=x.device)


def xlogx(p: torch.Tensor) -> torch.Tensor:
    """p * log2(p) with 0*log0 := 0."""
    return torch.where(p > 0, _over_log2(p * xla_log(_nonzero(p))),
                       torch.zeros_like(p))


def entropy(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy (bits) of count vectors along ``dim``
    (AttributeSplitStat.java:387-394)."""
    total = counts.sum(dim=dim, keepdim=True)
    return -xla_sum(xlogx(counts / _nonzero(total)), dim)


def gini(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gini index 1 - sum(p^2) (AttributeSplitStat.java:396-407)."""
    total = counts.sum(dim=dim, keepdim=True)
    p = counts / _nonzero(total)
    return 1.0 - _sum(p * p, dim)


def info(counts: torch.Tensor, algorithm: str) -> torch.Tensor:
    """The node information of ``split.algorithm``: entropy for
    ``entropy``, else gini (the root and parent information)."""
    return entropy(counts) if algorithm == "entropy" else gini(counts)


def weighted_segment_stat(seg_stats: torch.Tensor, seg_counts: torch.Tensor,
                          dim: int = -1) -> torch.Tensor:
    """Count-weighted average of per-segment stats — the split-level roll-up
    (SplitInfoContent.processStat, AttributeSplitStat.java:191-218)."""
    total = seg_counts.sum(dim=dim)
    return _sum(seg_stats * seg_counts, dim) / _nonzero(total)


def split_info_content(counts: torch.Tensor, algorithm: str = "entropy"
                       ) -> torch.Tensor:
    """Weighted entropy/gini over segments: ``counts`` [..., S, C] per-segment
    class counts -> [...] stats."""
    stat_fn = {"entropy": entropy, "giniIndex": gini}[algorithm]
    return weighted_segment_stat(stat_fn(counts, dim=-1),
                                 counts.sum(dim=-1), dim=-1)


def intrinsic_info_content(counts: torch.Tensor) -> torch.Tensor:
    """Entropy of the segment-size distribution — denominator of gain ratio
    (SplitStat.getInfoContent, AttributeSplitStat.java:153-170)."""
    return entropy(counts.sum(dim=-1), dim=-1)


def hellinger_distance(counts: torch.Tensor,
                       reference_absent: bool = False) -> torch.Tensor:
    """Hellinger distance between per-class segment distributions,
    ``counts`` [..., S, C]: the mean over class pairs of
    sqrt(sum over segments of (sqrt(n_sa/n_a) - sqrt(n_sb/n_b))^2), which
    is the reference's binary formula at C = 2
    (AttributeSplitStat.java:244-282). Pairs with an absent class are left
    out of the mean unless ``reference_absent``
    (``hellinger.absent.class.value=reference``), which keeps the
    reference's constant 1.0 in that edge (the JAX package's docstring
    gives the reasoning)."""
    class_tot = counts.sum(dim=-2, keepdim=True)             # [..., 1, C]
    root = _sqrt(counts / _nonzero(class_tot))               # [..., S, C]
    diff = root[..., :, None] - root[..., None, :]           # [..., S, C, C]
    pair_d = _sqrt(_sum(diff * diff, -3))                    # [..., C, C]
    c = counts.shape[-1]
    triu = torch.triu(torch.ones((c, c), dtype=counts.dtype,
                                 device=counts.device), diagonal=1)
    if reference_absent:
        pairs = triu.expand(pair_d.shape)
    else:
        present = (class_tot[..., 0, :] > 0).to(counts.dtype)
        pairs = triu * present[..., :, None] * present[..., None, :]
    n_pairs = torch.clamp(_sum(pairs.flatten(-2), -1), min=1.0)
    return _sum((pair_d * pairs).flatten(-2), -1) / n_pairs


def class_confidence_ratio(counts: torch.Tensor) -> torch.Tensor:
    """Weighted entropy of per-segment class-confidence ratios
    (SplitClassCofidenceRatio.processStat, AttributeSplitStat.java:298-336):
    confidence(s, c) = n_sc / n_c, normalized within each segment."""
    class_tot = counts.sum(dim=-2, keepdim=True)
    conf = counts / _nonzero(class_tot)                      # [..., S, C]
    ratio = conf / _nonzero(_sum(conf, -1)[..., None])
    seg_entropy = -_sum(xlogx(ratio), -1)                    # [..., S]
    return weighted_segment_stat(seg_entropy, counts.sum(dim=-1), dim=-1)


SPLIT_ALGORITHMS = ("entropy", "giniIndex", "hellingerDistance",
                    "classConfidenceRatio")


def split_stat(counts: torch.Tensor, algorithm: str) -> torch.Tensor:
    """Dispatch on the reference's ``split.algorithm`` values;
    ``hellingerDistance:reference`` is the absent-class compat variant
    (``hellinger.absent.class.value=reference``)."""
    if algorithm in ("entropy", "giniIndex"):
        return split_info_content(counts, algorithm)
    if algorithm == "hellingerDistance":
        return hellinger_distance(counts)
    if algorithm == "hellingerDistance:reference":
        return hellinger_distance(counts, reference_absent=True)
    if algorithm == "classConfidenceRatio":
        return class_confidence_ratio(counts)
    raise ValueError(f"unknown split algorithm {algorithm!r}")


def mutual_information(joint: torch.Tensor) -> torch.Tensor:
    """I(X;Y) in bits from a [..., X, Y] joint count tensor — the pairwise
    MI of MutualInformation's reducer cleanup
    (MutualInformation.java:598-678). The marginals and the terms sum in
    ``xla_sum``'s order (the terms as one reduction over both axes), so
    the bits equal the JAX package's and the card's equal the CPU's."""
    total = joint.sum(dim=(-2, -1), keepdim=True)
    p = joint / _nonzero(total)
    px = xla_sum(p, -1).unsqueeze(-1)
    py = xla_sum(p, -2).unsqueeze(-2)
    denom = px * py
    ok = (p > 0) & (denom > 0)
    safe_ratio = torch.where(ok, p / _nonzero(denom), torch.ones_like(p))
    terms = torch.where(p > 0, _over_log2(p * xla_log(safe_ratio)),
                        torch.zeros_like(p))
    return xla_sum(terms, (-2, -1))
