"""Runtime collectors: kernel builds, host RSS, device memory.

Counterpart of ``avenir_tpu/obs/runtime.py``. Three collectors, none on
the hot path:

- **Compile tracking.** The JAX package listens to ``jax.monitoring``'s
  compile events. The port compiles nothing per shape; what it compiles is
  its kernels: ``ops/_build.py``'s ``nvcc`` build of ``csrc/*.cu`` and the
  ``ctypes`` load of the library, and ``native/``'s ``g++`` build of the
  CSV encoder. Each reports its count and seconds here
  (:func:`record_compile`); :class:`CompileTracker` snapshots the deltas
  from a ``start()`` baseline, so one job's report shows its own builds.
  The report keeps JAX's ``compile`` section, with the port's keys.
- **Host RSS** from ``/proc/self/status`` (``VmRSS``/``VmHWM``).
- **Device memory**: ``torch.cuda.memory_stats`` of the entry point's
  device (:func:`set_device`); None on the CPU.

:class:`RuntimeSampler` polls RSS on a daemon thread with idempotent
start and stop, into a bounded ring.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# compile tracking (the port's kernel builds and loads)
# ---------------------------------------------------------------------------

_COMPILE_TOTALS = {
    "nvcc_build_count": 0,
    "nvcc_build_secs": 0.0,
    "library_load_count": 0,
    "library_load_secs": 0.0,
    "native_build_count": 0,
    "native_build_secs": 0.0,
}
_COMPILE_LOCK = threading.Lock()

_KINDS = ("nvcc_build", "library_load", "native_build")


def record_compile(kind: str, secs: float) -> None:
    """Count one build or load of ``kind`` (``nvcc_build``,
    ``library_load``, ``native_build``) taking ``secs``."""
    if kind not in _KINDS:
        raise ValueError(f"unknown compile kind {kind!r}")
    with _COMPILE_LOCK:
        _COMPILE_TOTALS[f"{kind}_count"] += 1
        _COMPILE_TOTALS[f"{kind}_secs"] += float(secs)


def compile_totals() -> Dict[str, float]:
    with _COMPILE_LOCK:
        return dict(_COMPILE_TOTALS)


class CompileTracker:
    """Delta view over the process compile totals: ``start()`` pins a
    baseline, ``snapshot()`` reports activity since then."""

    def __init__(self):
        self._baseline: Dict[str, float] = dict.fromkeys(_COMPILE_TOTALS, 0)
        self.available = True

    def start(self) -> None:
        self._baseline = compile_totals()

    def snapshot(self) -> Dict[str, float]:
        now = compile_totals()
        out: Dict[str, float] = {
            k: (round(v - self._baseline[k], 6)
                if isinstance(v, float) else v - self._baseline[k])
            for k, v in now.items()}
        out["available"] = self.available
        return out


# ---------------------------------------------------------------------------
# host + device memory
# ---------------------------------------------------------------------------

def read_proc_status() -> Dict[str, int]:
    """``{"rss_kb": VmRSS, "hwm_kb": VmHWM}`` from /proc/self/status;
    empty where procfs is unavailable."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["rss_kb"] = int(line.split()[1])
                elif line.startswith("VmHWM:"):
                    out["hwm_kb"] = int(line.split()[1])
    except OSError:
        pass
    return out


# the entry point's device (cli/main.py sets it); None reads no device
_DEVICE = None


def set_device(device) -> None:
    """Name the device whose memory :func:`device_memory_stats` reads."""
    global _DEVICE
    _DEVICE = device


def device_memory_stats() -> Optional[Dict[str, float]]:
    """``torch.cuda.memory_stats`` of the entry point's device (allocated
    and reserved bytes, current and peak); None on the CPU or when no
    device was named."""
    dev = _DEVICE
    if dev is None or getattr(dev, "type", str(dev)) != "cuda":
        return None
    try:
        import torch
        stats = torch.cuda.memory_stats(dev)
    except Exception:
        return None
    keys = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
            "reserved_bytes.all.current", "reserved_bytes.all.peak")
    out = {k: float(stats[k]) for k in keys if k in stats}
    return out or None


class RuntimeSampler:
    """Background RSS sampler with clean start/stop.

    Samples ``(t_monotonic, rss_kb)`` every ``interval_s`` into a bounded
    ring. ``start`` while running and ``stop`` while stopped are no-ops; a
    stopped sampler starts again on a fresh thread, its samples kept.
    """

    def __init__(self, interval_s: float = 0.25, max_samples: int = 2048):
        self.interval_s = interval_s
        self._samples: Deque[Tuple[float, int]] = collections.deque(
            maxlen=max_samples)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _run(self) -> None:
        while not self._stop.is_set():
            status = read_proc_status()
            if status:
                self._samples.append(
                    (time.monotonic(), status.get("rss_kb", 0)))
            self._stop.wait(self.interval_s)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "RuntimeSampler":
        with self._lock:
            if self.running:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="avenir-obs-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            self._stop.set()
            thread.join(timeout=5.0)
            self._thread = None
        # one last sample: a start/stop shorter than interval_s still
        # leaves the report an RSS number
        status = read_proc_status()
        if status:
            self._samples.append((time.monotonic(), status.get("rss_kb", 0)))

    def snapshot(self) -> Dict:
        samples: List[Tuple[float, int]] = list(self._samples)
        out: Dict = {"samples": len(samples),
                     "interval_s": self.interval_s}
        if samples:
            rss = [s[1] for s in samples]
            out.update(rss_kb_last=rss[-1], rss_kb_max=max(rss),
                       rss_kb_min=min(rss))
        status = read_proc_status()
        if "hwm_kb" in status:
            out["vm_hwm_kb"] = status["hwm_kb"]
        dev = device_memory_stats()
        if dev is not None:
            out["device_memory"] = dev
        return out
