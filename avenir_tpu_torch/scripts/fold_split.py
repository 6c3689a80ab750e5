"""Where a fold kernel's device time goes: one call of each lane-bucket
fold configuration, split kernel by kernel (pack, sweep, extraction) by
``torch.profiler`` on the card.

The configurations: K6 with bf16 rounding at n_acc 1, 4 and 8 (the
experiment's), K8 at n_acc 4 and K9 at n_acc 8, K10 at the three
configurations the kernel-restructure sweeps launch (``augbf16`` and
``augv2`` on bf16 tensors, whose widening to f32 shows as its own kernel,
and ``tpose_aug`` feature-major), and K11 and K12 at the six (``int8epi``,
``int8aug``, ``int8rr``, ``int8pk``, ``int8pk8``, ``int8pk16``), on the
sweeps' data (8,192 test x 65,536 train x 9) and operand encoders. One
line a configuration, in µs a call:

    int8pk pack_kernel 2.5; tc_int8_sweep_kernel<2> 81.6; tc_extract_kernel<int, 512> 28.3

It needs a CUDA device: on the CPU the plain versions would run, and their
split says nothing of the kernels.

    python -m avenir_tpu_torch.scripts.fold_split [--m M] [--n N]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from avenir_tpu_torch.ops import cuda_fold
from avenir_tpu_torch.ops.distance import row_sq_norm
from avenir_tpu_torch.scripts import _sweep as S
from avenir_tpu_torch.scripts.roofline_knn import kernel_split


def configurations(x: torch.Tensor, y: torch.Tensor
                   ) -> Dict[str, Callable[[], object]]:
    """label → one call of the configuration on test x and train y."""
    y2 = row_sq_norm(y)
    xt, yt = x.T.contiguous(), y.T.contiguous()
    calls: Dict[str, Callable[[], object]] = {
        f"K6 n_acc={a}": (lambda a=a: cuda_fold.acc_fold(x, y, y2, k=S.K,
                                                         n_acc=a))
        for a in (1, 4, 8)}
    calls["K8 n_acc=4"] = lambda: cuda_fold.nodot_fold(x, y2, k=S.K, n_acc=4)
    calls["K9 n_acc=8"] = lambda: cuda_fold.tpose_fold(xt, yt, y2, k=S.K,
                                                       n_acc=8)
    ones = torch.ones((x.shape[0], 1), device=x.device)
    xa, ya = S.aug_operands(x, y)
    for label, xr, yr, tpose in (
            ("augbf16", torch.cat([x, ones], 1).to(torch.bfloat16),
             torch.cat([-2.0 * y, y2.reshape(-1, 1)], 1).to(torch.bfloat16),
             False),
            ("augv2", xa.to(torch.bfloat16), ya.to(torch.bfloat16), False),
            ("tpose_aug", xa.T.contiguous(), ya.T.contiguous(), True)):
        calls[label] = (lambda xr=xr, yr=yr, tpose=tpose: cuda_fold.raw_fold(
            xr, yr, k=S.K, n_acc=S.N_ACC, tile_n=S.TILE_N, tpose=tpose))
    x8, y8, _ = S.quant(x, y, 127.0)
    y8_sq = S._int8_sq_norm(y8)
    xa8, ya8, _ = S.int8_aug_operands(x, y)
    xc8, yc8, _ = S.int8_centered_operands(x, y)
    for label, xa, ya, kw in (
            ("int8epi", x8, y8, dict(k=S.K, y2=y8_sq)),
            ("int8aug", xa8, ya8, dict(k=S.K)),
            ("int8rr", xa8, ya8, dict(k=S.K_CAND)),
            ("int8pk", xa8, ya8, dict(k=S.K_CAND, packed=True)),
            ("int8pk8", xc8, yc8, dict(k=8, packed=True, n_acc=8)),
            ("int8pk16", xc8, yc8, dict(k=16, packed=True, n_acc=16))):
        calls[label] = (lambda xa=xa, ya=ya, kw=kw:
                        S.launch_fold(xa, ya, **kw))
    return calls


def main(argv: Optional[List[str]] = None
         ) -> Dict[str, List[Tuple[str, float]]]:
    dev, m, n = S.parse_args(__doc__, argv)
    if dev.type != "cuda":
        raise RuntimeError(f"fold_split times kernels on a CUDA device, "
                           f"got device {dev.type}")
    x, y = S.make_data(m, n, dev)
    print(f"# fold_split: {m} test x {n} train, D={S.D}; "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    splits = {}
    for label, call in configurations(x, y).items():
        splits[label] = kernel_split(call)
        print(label, "; ".join(f"{name} {us:.1f}"
                               for name, us in splits[label]), flush=True)
    return splits


if __name__ == "__main__":
    main()
