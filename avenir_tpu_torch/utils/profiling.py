"""Tracing, step timing and structured logging.

Counterpart of ``avenir_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` trace of the block, CPU and
  CUDA activities, written as Chrome JSON (``trace-<pid>.json``) into
  ``log_dir``; Perfetto and ``chrome://tracing`` open it. The JAX package
  writes an XLA trace there. It logs a warning where the port's kernels
  launched and the trace holds no kernel event.
- ``StepTimer``: wall time a step, with mean/min/max and nearest-rank
  p50/p95/p99; ``block_on`` waits for the card's queued work first.
- ``get_logger(name, debug_on)``: the reference's ``debug.on`` switch:
  DEBUG level when on, WARNING otherwise, one stderr handler, structured
  ``key=value`` text, with its environment override renamed
  ``AVENIR_TPU_TORCH_LOG_LEVEL``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Iterator, Optional

from avenir_tpu_torch.obs.telemetry import percentiles


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile everything inside the block into ``log_dir`` as a Chrome
    trace: host ops, and the card's kernels and copies where a card is
    present. Logs a warning if the port's kernels launched inside the
    block and the written trace names no kernel event: in a process that
    ran profiler sessions before, ``torch.profiler`` can drop the card's
    records whose timestamps it places outside the session (PERF.md §7),
    and a trace that silently lacks the card's work would mislead whoever
    reads it. The job's own results do not depend on the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    launched = kernel_launches()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            # the card's last kernels reach the trace only once they ran
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
    if cuda:
        missing = check_kernel_events(path, kernel_launches() - launched)
        if missing:
            get_logger("profiling").warning(missing)


def check_kernel_events(path: str, launched: int) -> Optional[str]:
    """The warning for a Chrome trace at ``path`` that names no kernel
    event though ``launched`` > 0 kernel launches went into the block it
    covers; None where it names one or nothing was launched."""
    if launched <= 0:
        return None
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    if any(e.get("cat") == "kernel" for e in events):
        return None
    return (f"torch.profiler wrote {path} with no kernel event, though the "
            f"port's kernels launched {launched} times inside it")


def kernel_launches() -> int:
    """The launches that the port's kernel wrappers (each function of an
    imported ``ops.cuda_*`` module that keeps a ``launches`` count) have
    counted so far in this process."""
    total = 0
    for name, module in list(sys.modules.items()):
        if module is None or not name.startswith("avenir_tpu_torch.ops.cuda_"):
            continue
        for fn in vars(module).values():
            count = getattr(fn, "launches", None)
            if callable(fn) and isinstance(count, int):
                total += count
    return total


class StepTimer:
    """Wall time per step. ``block_on`` waits until the card has run what
    was queued, for callers that time device work; the CLI times the
    verb's host wall, as the JAX CLI does.

    >>> timer = StepTimer("train")
    >>> with timer.step():
    ...     out = train_step(batch)
    ...     timer.block_on(out)
    >>> timer.summary()   # {'train.steps': N, 'train.mean_ms': ..., ...}
    """

    def __init__(self, name: str = "step"):
        self.name = name
        self.times_ms: list = []

    @contextlib.contextmanager
    def step(self) -> Iterator["StepTimer"]:
        t0 = time.perf_counter()
        yield self
        self.times_ms.append((time.perf_counter() - t0) * 1e3)

    @staticmethod
    def block_on(tree: Any) -> Any:
        """Wait for the card's streams on every device that holds a tensor
        of ``tree`` (nested lists, tuples, dicts)."""
        import torch
        devices = set()

        def walk(v):
            if isinstance(v, torch.Tensor):
                if v.is_cuda:
                    devices.add(v.device)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(x)
            elif isinstance(v, dict):
                for x in v.values():
                    walk(x)
        walk(tree)
        for dev in devices:
            torch.cuda.synchronize(dev)
        return tree

    def summary(self) -> Dict[str, float]:
        if not self.times_ms:
            return {f"{self.name}.steps": 0}
        arr = self.times_ms
        pct = percentiles(arr)
        return {
            f"{self.name}.steps": len(arr),
            f"{self.name}.mean_ms": sum(arr) / len(arr),
            f"{self.name}.min_ms": min(arr),
            f"{self.name}.max_ms": max(arr),
            f"{self.name}.p50_ms": pct[50],
            f"{self.name}.p95_ms": pct[95],
            f"{self.name}.p99_ms": pct[99],
        }


def get_logger(name: str,
               debug_on: Optional[bool] = None) -> logging.Logger:
    """The reference's per-class ``debug.on`` switch as a logger factory.

    ``debug_on=None`` leaves an already-configured logger's level alone
    (first configuration defaults to WARNING). A process whose ROOT logger
    already has handlers gets no handler from here: records propagate to
    the root and are emitted once. ``AVENIR_TPU_TORCH_LOG_LEVEL``
    (DEBUG/INFO/WARNING/ERROR), when set to a valid level name, pins the
    level and wins over ``debug_on``.
    """
    logger = logging.getLogger(f"avenir_tpu_torch.{name}")
    if not getattr(logger, "_avenir_configured", False):
        if logging.getLogger().handlers:
            logger.propagate = True
        else:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s level=%(levelname)s logger=%(name)s "
                "%(message)s"))
            logger.addHandler(handler)
            logger.propagate = False
        logger.setLevel(logging.WARNING)
        logger._avenir_configured = True  # type: ignore[attr-defined]
    env_level = getattr(
        logging,
        os.environ.get("AVENIR_TPU_TORCH_LOG_LEVEL", "").strip().upper(),
        None)
    if isinstance(env_level, int):
        logger.setLevel(env_level)
    elif debug_on is not None:
        logger.setLevel(logging.DEBUG if debug_on else logging.WARNING)
    return logger
