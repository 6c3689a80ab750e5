"""Roofline decomposition of the KNN kernel on the card.

Times K2, the production distance top-k, beside kernels that each isolate
one part of its work, at the JAX decomposition's shape, and reports each
against the H100's ceilings:

  full        K2 (``ops.cuda_distance.topk_raw``): f32 dot + exact top-k
  full-sweep  K2 without its selection (``topk_sweep_min``): K2's launch,
              tiles and product sweep, one running minimum per row
  full-nodot  K2 without its product (``topk_nodot_raw``): K2's launch,
              top-k lists, splits and merge over ``|y2[col] − Σ x[r]|``,
              whose order of the columns differs from row to row
  dotmin      K7: the bf16-rounded dot with the cheapest consumption, one
              minimum per (row, column), no index
  nodot       K8: the indexed bucket fold and extraction, the product
              replaced by a broadcast ``y2[col] + Σ x[r]``
  tpose       K9: the bucket fold over feature-major operands
  plain       ``ops.distance.pairwise_topk(mode="fast")``, the plain
              PyTorch path (it stands where the JAX script's ``xla``
              stood); it repeats the arithmetic and is no yardstick of speed
  library     ``torch.cdist`` + ``torch.topk``, timed beside the kernels
              and never called by the port

A ``full-sweep`` close to ``full`` puts K2's time in its product sweep, a
``full-nodot`` close to ``full`` in its selection. ``dotmin``, ``nodot``
and ``tpose`` split the JAX experiment's fold kernels the same way, with
designs of their own (``csrc/fold.cu``), so they speak of the fold
family, not of K2. All three run on one tile of the tensor-core body (128
test rows × 64 buckets a block, the fold on the accumulator fragments):
``dotmin`` the bf16 ``mma.sync`` product and a minimum, ``tpose`` K6's
product and indexed fold over feature-major operands (so ``tpose`` beside
K6 is the cost of that layout), ``nodot`` the indexed fold with an add in
place of the product (so K6 − ``nodot`` is the product's share).

Each variant is read against the ceilings of the units that do its work
(``WORK``, the table ``chip_smoke.py`` bounds its kernels with): its
product on the f32 CUDA cores at 67 TFLOP/s (K2's variants, ``plain``,
``library``: ``67e12 / (2·D)`` pairs/s) or the bf16 tensor cores at 989
TFLOP/s over the padded contraction (``dotmin``, ``tpose``: ``989e12 /
(2·16·tc_steps(D))``); its instructions a pair on the CUDA cores at SMs ×
128 lanes × the maximum SM clock (``nvidia-smi``); and device memory at
3.35 TB/s over the bytes it must move (inputs read once, outputs written
once — the train set's re-reads are served by the 50 MB L2 where it
fits). A ceiling that does not apply to a variant prints "—".
On the card each fold variant's device time a call is also split kernel
by kernel (``torch.profiler``): the pack, sweep and extraction of
``dotmin``, ``nodot`` and ``tpose``.

    python -m avenir_tpu_torch.scripts.roofline_knn [--device cpu] ...
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_distance, cuda_fold
from avenir_tpu_torch.ops.distance import pairwise_topk, row_sq_norm
from avenir_tpu_torch.ops.fold import LANES
from avenir_tpu_torch.scripts._timing import chain_ms, clock_label
from avenir_tpu_torch.utils.device import resolve_device

N_TRAIN = 65536
M_TEST = 8192
D = 9
K = 5
TILE_N, N_ACC = 4096, 4
VARIANTS = ("full", "full-sweep", "full-nodot", "dotmin", "nodot", "tpose",
            "plain", "library")
#: the variants whose wrappers launch more than one kernel
SPLIT_VARIANTS = ("dotmin", "nodot", "tpose")

# H100 SXM (NVIDIA data sheet): f32 off the tensor cores, bf16 on them
# (f32 sums), HBM3, L2
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
#: lanes of an SM that each run one f32 or int32 instruction a clock
LANES_PER_SM = 128

#: what each kernel does a (row, column) pair, as its bound counts it: the
#: type of its product — "f32" on the CUDA cores, "bf16" (bf16-rounded
#: operands, f32 sums) on the tensor cores, None where it computes none —
#: and its instructions a pair on the CUDA cores beside the product (the
#: metric, then the compare and two selects of an indexed fold, or the
#: one minimum that consumes it; 0 where none is counted). ``chip_smoke.py``
#: bounds these kernels with the same table.
WORK = {"K2": ("f32", 0), "K2-sweep": ("f32", 2), "K2-nodot": (None, 2),
        "K6": ("bf16", 4), "K7": ("bf16", 2), "K8": (None, 4),
        "K9": ("bf16", 4)}
#: the kernel each variant runs; ``plain`` and ``library`` do the f32
#: product on the CUDA cores and count no instructions a pair
VARIANT_KERNELS = {"full": "K2", "full-sweep": "K2-sweep",
                   "full-nodot": "K2-nodot", "dotmin": "K7", "nodot": "K8",
                   "tpose": "K9"}


def variant_work(variant: str):
    """(product type, instructions a pair) of ``variant``."""
    return WORK[VARIANT_KERNELS[variant]] if variant in VARIANT_KERNELS \
        else ("f32", 0)


def launch(variant: str, x: torch.Tensor, y: torch.Tensor, *,
           y2: Optional[torch.Tensor] = None,
           xt: Optional[torch.Tensor] = None,
           yt: Optional[torch.Tensor] = None):
    """One call of ``variant`` on test x ``[M, D]`` and train y ``[N, D]``
    (``y2 = |y|²`` and the feature-major ``xt``, ``yt`` are derived when not
    given): its outputs, (values, ids or None)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    if y2 is None:
        y2 = row_sq_norm(y)
    if variant == "full":
        return cuda_distance.topk_raw(x, y, y2, K)
    if variant == "full-sweep":
        return cuda_distance.topk_sweep_min(x, y, y2), None
    if variant == "full-nodot":
        return cuda_distance.topk_nodot_raw(x, y2, K)
    if variant == "dotmin":
        return cuda_fold.dotmin(x, y, y2), None
    if variant == "nodot":
        return cuda_fold.nodot_fold(x, y2, k=K, n_acc=N_ACC, tile_n=TILE_N)
    if variant == "tpose":
        xt = x.T.contiguous() if xt is None else xt
        yt = y.T.contiguous() if yt is None else yt
        return cuda_fold.tpose_fold(xt, yt, y2, k=K, n_acc=N_ACC,
                                    tile_n=TILE_N)
    if variant == "plain":
        return pairwise_topk(x, y, k=K, mode="fast")
    values, ids = torch.topk(torch.cdist(x, y), K, dim=1, largest=False)
    return values, ids


def moved_bytes(variant: str, m: int, n: int, d: int) -> float:
    """Bytes the variant must move: each input read once, each output
    written once."""
    x_bytes, y_bytes, y2_bytes = m * d * 4, n * d * 4, n * 4
    if variant == "full-sweep":
        return x_bytes + y_bytes + y2_bytes + m * 4
    if variant == "full-nodot":
        return x_bytes + y2_bytes + m * K * 8
    if variant == "dotmin":
        return x_bytes + y_bytes + y2_bytes + m * LANES * 4
    if variant == "nodot":
        return x_bytes + y2_bytes + m * LANES * 8
    if variant == "tpose":
        return x_bytes + y_bytes + y2_bytes + m * LANES * 8
    return x_bytes + y_bytes + y2_bytes + m * K * 8


def max_sm_clock_hz(dev: torch.device) -> float:
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def lane_ops_per_s(dev: torch.device) -> float:
    """f32 instructions a second on the card's CUDA cores: SMs × 128 lanes
    × the maximum SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * LANES_PER_SM * max_sm_clock_hz(dev)


def product_pairs_per_s(product: Optional[str], d: int) -> Optional[float]:
    """Pairs a second the unit that computes a product of ``product``'s
    type could give: f32 on the CUDA cores over 2·d flops a pair, bf16 on
    the tensor cores over the padded contraction 2·16·tc_steps(d); None
    without a product."""
    if product == "f32":
        return PEAK_F32_FLOPS / (2 * d)
    if product == "bf16":
        return PEAK_BF16_FLOPS / (2 * 16 * cuda_fold.tc_steps(d))
    return None


def shares(sms: int, clock_hz: float, variant: str, m: int, n: int, d: int,
           ms: float) -> dict:
    """The shares of the card's ceilings a run of ``variant`` over m × n
    pairs of d features reaches in ``ms``: ``product`` (its product's
    unit), ``ops`` (its instructions a pair at ``sms`` × 128 lanes ×
    ``clock_hz``) and ``memory``; None where a ceiling does not apply."""
    product, ops = variant_work(variant)
    pairs_per_s = m * n / (ms / 1e3)
    dot = product_pairs_per_s(product, d)
    lanes = sms * LANES_PER_SM * clock_hz
    return {"product": None if dot is None else pairs_per_s / dot,
            "ops": pairs_per_s * ops / lanes if ops else None,
            "memory": (moved_bytes(variant, m, n, d) / PEAK_BYTES_PER_S)
            / (ms / 1e3)}


def share_text(share: Optional[float]) -> str:
    return "     —" if share is None else f"{share:6.1%}"


def kernel_name(demangled: str) -> str:
    """A kernel's name without its return type, namespaces and parameters:
    ``tc_sweep_kernel<true, 1>`` of ``void (anonymous namespace)::tc::
    tc_sweep_kernel<true, 1>(float const*, (anonymous namespace)::tc::
    Strides, ...)``."""
    name = re.sub(r"^void ", "", demangled.replace("(anonymous namespace)::",
                                                   ""))
    depth, start, end = 0, 0, len(name)
    for i, ch in enumerate(name):     # outside template arguments only
        if ch in "<>":
            depth += 1 if ch == "<" else -1
        elif depth == 0 and ch == "(":
            end = i
            break
        elif depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:end].strip()


def kernel_split(fn, calls: int = 20) -> List[Tuple[str, float]]:
    """Device µs a call of ``fn`` spends in each kernel or copy it
    launches: ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(kernel_name(e.key), e.device_time_total / calls)
            for e in prof.key_averages() if e.device_time_total > 0]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=M_TEST)
    p.add_argument("--n", type=int, default=N_TRAIN)
    p.add_argument("--d", type=int, default=D)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, d = args.m, args.n, args.d
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dev)
    x = torch.from_numpy(rng.random((m, d), dtype=np.float32)).to(dev)
    operands = {"y2": row_sq_norm(y), "xt": x.T.contiguous(),
                "yt": y.T.contiguous()}
    card = None
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        card = (sms, lane_ops_per_s(dev) / (sms * LANES_PER_SM))
    train_mb = n * d * 4 / 1e6
    print(f"# roofline_knn: {m} test x {n} train, D={d}, k={K}, n_acc="
          f"{N_ACC}, tile_n={TILE_N}; {clock_label(dev)}", flush=True)
    if card:
        print(f"# ceilings: product on the f32 CUDA cores "
              f"{product_pairs_per_s('f32', d):.3e} pairs/s (67 TFLOP/s / "
              f"2D), on the bf16 tensor cores "
              f"{product_pairs_per_s('bf16', d):.3e} pairs/s (989 TFLOP/s / "
              f"2*16*{cuda_fold.tc_steps(d)}); instructions "
              f"{card[0] * LANES_PER_SM * card[1]:.3e}/s ({card[0]} SMs x "
              f"{LANES_PER_SM} lanes x {card[1] / 1e9:.3f} GHz); memory 3.35 "
              f"TB/s; train set {train_mb:.1f} MB "
              f"{'in' if train_mb * 1e6 <= L2_BYTES else 'beyond'} the "
              "50 MB L2", flush=True)
    results = []
    for variant in VARIANTS:
        ms = chain_ms(lambda: launch(variant, x, y, **operands), dev)
        pairs = m * n / (ms / 1e3)
        row = {"variant": variant, "ms": ms, "rows_per_s": m / (ms / 1e3),
               "pairs_per_s": pairs}
        line = (f"{variant:10s} {ms:9.4f} ms  {row['rows_per_s'] / 1e6:8.3f} "
                f"M rows/s  {pairs:.3e} pairs/s")
        if card:
            got = shares(*card, variant, m, n, d, ms)
            row.update({f"{key}_share": v for key, v in got.items()})
            product, ops = variant_work(variant)
            line += (f"  {share_text(got['product'])} "
                     f"{product or 'no'}-product  "
                     f"{share_text(got['ops'])} ops ({ops} a pair)  "
                     f"{got['memory']:6.2%} memory")
        else:
            line += "  shares not measured (cpu)"
        if variant == "plain":
            line += "  (plain PyTorch, no yardstick)"
        elif variant == "library":
            line += "  (cdist + topk, never called by the port)"
        print(line, flush=True)
        results.append(row)
    if not card:
        print("# split by kernel: not measured (cpu)", flush=True)
    for variant in SPLIT_VARIANTS if card else ():
        parts = kernel_split(lambda: launch(variant, x, y, **operands))
        print(f"# split {variant} (device us a call): " + "; ".join(
            f"{name} {us:.2f}" for name, us in parts), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
