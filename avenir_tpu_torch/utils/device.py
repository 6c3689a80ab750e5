"""The device an entry point runs on.

Every library entry point takes ``device=`` (default ``"cuda"``) and the
CLI takes ``--device {cuda,cpu}``. With no GPU, ``"cuda"`` raises: the
port never carries on on the CPU unless the caller asks for it.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present. On CUDA, float32 matmuls of the plain ops stay
    full f32 (no TF32): the distance cross term must not lose precision."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "avenir_tpu_torch runs on CUDA by default but no CUDA device "
                "is available; pass --device cpu (CLI) or device='cpu' "
                "(library) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
