"""Whether ``torch.profiler`` keeps the card's kernels in a process's later
sessions.

Each session profiles a 1024 x 1024 matmul with its sum and one K1 launch
(``class_feature_bin_counts``, 1,048,576 x 8 bins), twice, then the
card's queue drains and the session stops. A line a session gives the
kernel events its Chrome trace names, the count of each event category,
and each kernel's start less its launch's (ms): a few microseconds where
the profiler's clocks agree. Two modes, each a set of processes side by
side on one card:

1. ``gap``: a session at the start (``A``), ``--seconds`` of card work (or
   of sleep), then three sessions in a row (``B``, ``C``, ``D``). The
   processes: ``default``; ``pad`` (``B`` and ``D`` sleep 1 s before the
   work and after the drain); ``noteardown`` (``TEARDOWN_CUPTI=0``);
   ``sleep`` (the gap sleeps); ``noA`` (no session before the gap).
2. ``rounds``: a session at the start, then five rounds of 22 s of card
   work and one traced "job": 1.5 s of host work, then the kernels. Two
   processes of each: ``none`` (the job's session alone), ``tiny`` (a
   session of one small kernel first) and ``calib`` (a first session of
   0.3 s, and 20 ms of sleep at each end of the job's). A summary line
   each: the sessions out of 5 whose trace names a kernel.
3. ``clock``: sessions at 0, 5, 20, 45 and 90 s after the first (card
   work between them), in three processes side by side: ``default`` (a
   profiler a session, started and stopped), ``warmup`` (a profiler a
   session under a one-step warm-up ``schedule``) and ``keepalive`` (one
   profiler for the process, each session an active step of its
   ``schedule``). A line a session: the seconds since the first, the
   kernel events kept, the first launch's trace time less the host's
   wall clock read just before it (ms; the host side's offset), the
   kernels' start less their launch's (ms; the card side's) and where
   the kept kernels lie in the session's trace window.
4. ``flush``: the ``clock`` schedule with a profiler a session, in four
   processes side by side, each acting on the CUPTI activity buffers that
   kineto fills: ``default``; ``forced`` (``cuptiActivityFlushAll`` with
   ``CUPTI_ACTIVITY_FLAG_FLUSH_FORCED`` after the drain, before
   ``stop``, through the libcupti the process has loaded); ``completed``
   (the same call with flag 0, which returns only full buffers); and
   ``config`` (``KINETO_CONFIG`` naming a file that raises
   ``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB`` to 512). A line a session: the
   seconds since the first and the kernel events kept, then a summary.

Run from the root of a checkout, on the card::

    python -m avenir_tpu_torch.scripts.profiler_sessions gap --seconds 150
    python -m avenir_tpu_torch.scripts.profiler_sessions rounds
    python -m avenir_tpu_torch.scripts.profiler_sessions clock
    python -m avenir_tpu_torch.scripts.profiler_sessions flush
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

GAP_VARIANTS = (("default", "work", 0.0, {}), ("pad", "work", 1.0, {}),
                ("noteardown", "work", 0.0, {"TEARDOWN_CUPTI": "0"}),
                ("sleep", "sleep", 0.0, {}), ("noA", "work-noA", 0.0, {}))
ROUND_VARIANTS = ("none", "tiny", "calib")
ROUND_WORK_S = 22
ROUNDS = 5
CLOCK_AT_S = (0, 5, 20, 45, 90)
CLOCK_VARIANTS = ("default", "warmup", "keepalive")
FLUSH_VARIANTS = ("default", "forced", "completed", "config")


def loaded_cupti() -> Optional[str]:
    """The path of the libcupti this process has loaded (kineto's), from
    its own memory map; None before a profiler loaded one."""
    with open("/proc/self/maps") as fh:
        for line in fh:
            path = line.split()[-1]
            if "libcupti" in os.path.basename(path):
                return path
    return None


def cupti_flush(forced: bool) -> Optional[str]:
    """``cuptiActivityFlushAll`` on the loaded libcupti (the handle dlopen
    gives for a loaded path is that library's): flag 1 forces partly
    filled buffers out, 0 returns only full ones. Returns the library's
    path, or None where none is loaded."""
    import ctypes
    path = loaded_cupti()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    status = lib.cuptiActivityFlushAll(ctypes.c_uint32(1 if forced else 0))
    if status != 0:
        raise RuntimeError(f"cuptiActivityFlushAll: CUPTI status {status}")
    return path


class _Card:
    """The profiled work and the reading of a session's trace."""

    def __init__(self):
        import torch
        from avenir_tpu_torch.ops import cuda_histogram
        self.torch, self.hist = torch, cuda_histogram
        dev = torch.device("cuda")
        g = torch.Generator(device="cpu").manual_seed(0)
        self.bins = torch.randint(0, 10, (1 << 20, 8), generator=g,
                                  dtype=torch.int32).to(dev)
        self.labels = torch.randint(0, 2, (1 << 20,), generator=g,
                                    dtype=torch.int32).to(dev)
        self.a = torch.randn(1024, 1024, device=dev)

    def work(self):
        (self.a @ self.a).sum()
        self.hist.class_feature_bin_counts(self.bins, self.labels, 2, 10)

    def profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    @staticmethod
    def read(path):
        """(kernel events, category counts, names, start less launch ms)."""
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        launches = {e["args"].get("correlation"): e for e in events
                    if e.get("cat") == "cuda_runtime" and "args" in e}
        offsets = [round((e["ts"] - launches[e["args"]["correlation"]]
                          ["ts"]) / 1e3, 3) for e in kernels
                   if e.get("args", {}).get("correlation") in launches]
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        names = sorted({e["name"][:40] for e in kernels})
        return len(kernels), cats, names, offsets


def _gap_worker(variant, gap_kind, gap_s, pad, out):
    card = _Card()
    torch = card.torch

    def session(name, pad_s):
        path = os.path.join(out, f"{variant}-{name}.json")
        prof = card.profile()
        prof.start()
        if pad_s:
            time.sleep(pad_s)
        card.work()
        card.work()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
        prof.stop()
        prof.export_chrome_trace(path)
        n, cats, names, offsets = card.read(path)
        print(f"[{variant}] {name}: kernels {n} {names} cats {cats} "
              f"kernel-minus-launch ms {offsets[:8]}", flush=True)

    print(f"[{variant}] torch {torch.__version__} cuda {torch.version.cuda} "
          f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}", flush=True)
    card.work()
    torch.cuda.synchronize()
    if gap_kind != "work-noA":
        session("A", 0)
    t_end = time.time() + gap_s
    rounds = 0
    while time.time() < t_end:
        if gap_kind.startswith("work"):
            for _ in range(20):
                card.work()
            torch.cuda.synchronize()
            rounds += 1
        else:
            time.sleep(1)
    print(f"[{variant}] gap {gap_kind} {gap_s}s, {rounds} rounds, K1 "
          f"launches {card.hist.class_feature_bin_counts.launches}",
          flush=True)
    session("B", pad)
    session("C", 0)
    session("D", pad)


def _round_worker(variant, tag, out):
    card = _Card()
    torch = card.torch

    def traced(i):
        if variant in ("tiny", "calib"):
            with card.profile():
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                if variant == "calib":
                    time.sleep(0.3)
        prof = card.profile()
        prof.start()
        if variant == "calib":
            time.sleep(0.02)
        time.sleep(1.5)          # the job's host work
        card.work()
        torch.cuda.synchronize()
        if variant == "calib":
            time.sleep(0.02)
        prof.stop()
        path = os.path.join(out, f"{variant}{tag}-{i}.json")
        prof.export_chrome_trace(path)
        n, _, _, offsets = card.read(path)
        print(f"[{variant}{tag}] round {i}: kernels {n} kernel-minus-launch "
              f"ms {offsets[:3]}", flush=True)
        return n

    card.work()
    torch.cuda.synchronize()
    with card.profile():
        card.work()
        torch.cuda.synchronize()
    kept = 0
    for i in range(ROUNDS):
        t_end = time.time() + ROUND_WORK_S
        while time.time() < t_end:
            for _ in range(20):
                card.work()
            torch.cuda.synchronize()
        kept += traced(i) > 0
    print(f"[{variant}{tag}] SUMMARY {kept}/{ROUNDS} sessions with kernels",
          flush=True)


def _clock_worker(variant, out):
    from torch.profiler import ProfilerActivity, profile, schedule
    card = _Card()
    torch = card.torch
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    card.work()
    torch.cuda.synchronize()
    paths = []
    keepalive = None
    if variant == "keepalive":
        keepalive = profile(
            activities=activities,
            schedule=schedule(wait=1, warmup=1, active=1),
            on_trace_ready=lambda p: p.export_chrome_trace(paths[-1]))
        keepalive.start()
    t_first = None
    for i, at in enumerate(CLOCK_AT_S):
        while t_first is not None and time.time() < t_first + at:
            for _ in range(20):
                card.work()
            torch.cuda.synchronize()
        paths.append(os.path.join(out, f"clock-{variant}-{i}.json"))
        if variant == "keepalive":
            keepalive.step()                  # warm-up
            keepalive.step()                  # active
            prof = None
        elif variant == "warmup":
            prof = profile(activities=activities,
                           schedule=schedule(wait=0, warmup=1, active=1),
                           on_trace_ready=lambda p: p.export_chrome_trace(
                               paths[-1]))
            prof.start()
            prof.step()                       # active
        else:
            prof = card.profile()
            prof.start()
        host_us = time.time_ns() / 1e3
        if t_first is None:
            t_first = time.time()
        card.work()
        torch.cuda.synchronize()
        if variant == "keepalive":
            keepalive.step()                  # the trace is written
        elif variant == "warmup":
            prof.step()
            prof.stop()
        else:
            prof.stop()
            prof.export_chrome_trace(paths[-1])
        with open(paths[-1]) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(paths[-1])
        stamps = [e["ts"] for e in events if "ts" in e]
        launches = sorted(e["ts"] for e in events
                          if e.get("cat") == "cuda_runtime"
                          and "Launch" in str(e.get("name", "")))
        kernels = [e for e in events if e.get("cat") == "kernel"]
        by_corr = {e["args"].get("correlation"): e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime" and "args" in e}
        offsets = [round((e["ts"] - by_corr[e["args"]["correlation"]])
                         / 1e3, 3) for e in kernels
                   if e.get("args", {}).get("correlation") in by_corr]
        host_ms = (round((launches[0] - host_us) / 1e3, 3) if launches
                   else None)
        span = ((min(stamps), max(stamps)) if stamps else (0, 0))
        where = [round((e["ts"] - span[0]) / 1e3, 3) for e in kernels][:4]
        print(f"[clock {variant}] session {i} at "
              f"{time.time() - t_first:.1f} s: kernels {len(kernels)}, "
              f"first launch less host wall {host_ms} ms, kernel less "
              f"launch ms {offsets[:4]}, kernels at ms {where} of a "
              f"{(span[1] - span[0]) / 1e3:.3f} ms window", flush=True)
    if keepalive is not None:
        keepalive.stop()


def _flush_worker(variant, out):
    card = _Card()
    torch = card.torch
    card.work()
    torch.cuda.synchronize()
    t_first = None
    kept = []
    lib = None
    for i, at in enumerate(CLOCK_AT_S):
        while t_first is not None and time.time() < t_first + at:
            for _ in range(20):
                card.work()
            torch.cuda.synchronize()
        path = os.path.join(out, f"flush-{variant}-{i}.json")
        prof = card.profile()
        prof.start()
        if t_first is None:
            t_first = time.time()
        card.work()
        card.work()
        torch.cuda.synchronize()
        if variant in ("forced", "completed"):
            lib = cupti_flush(variant == "forced")
        prof.stop()
        prof.export_chrome_trace(path)
        n, _, _, offsets = card.read(path)
        kept.append(n)
        print(f"[flush {variant}] session {i} at "
              f"{time.time() - t_first:.1f} s: kernels {n}, kernel less "
              f"launch ms {offsets[:3]}", flush=True)
    print(f"[flush {variant}] SUMMARY kernels kept a session {kept} "
          f"(of {kept[0] if kept else 0} in the first); libcupti {lib}; "
          f"KINETO_CONFIG={os.environ.get('KINETO_CONFIG')}", flush=True)


def _spawn(worker_args, env_extra, out):
    env = dict(os.environ, **env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "avenir_tpu_torch.scripts.profiler_sessions",
         "--out", out, "worker"] + worker_args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("gap", "rounds", "clock", "flush",
                                     "worker"))
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("worker_args", nargs="*")
    args = ap.parse_args(argv)
    if args.mode == "worker":
        kind, *rest = args.worker_args
        if kind == "gap":
            variant, gap_kind, gap_s, pad = rest
            _gap_worker(variant, gap_kind, float(gap_s), float(pad),
                        args.out)
        elif kind == "clock":
            _clock_worker(rest[0], args.out)
        elif kind == "flush":
            _flush_worker(rest[0], args.out)
        else:
            _round_worker(rest[0], rest[1], args.out)
        return 0
    import torch
    from avenir_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("profiler_sessions needs the card", file=sys.stderr)
        return 2
    _build.build()
    with tempfile.TemporaryDirectory() as out:
        if args.mode == "gap":
            procs = [_spawn(["gap", v, kind, str(args.seconds), str(pad)],
                            env, out)
                     for v, kind, pad, env in GAP_VARIANTS]
        elif args.mode == "clock":
            procs = [_spawn(["clock", v], {}, out)
                     for v in CLOCK_VARIANTS]
        elif args.mode == "flush":
            conf = os.path.join(out, "kineto.conf")
            with open(conf, "w") as fh:
                fh.write("ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=512\n")
            procs = [_spawn(["flush", v],
                            {"KINETO_CONFIG": conf} if v == "config"
                            else {}, out)
                     for v in FLUSH_VARIANTS]
        else:
            procs = [_spawn(["round", v, str(t)], {}, out)
                     for v in ROUND_VARIANTS for t in (1, 2)]
        try:
            lines = [p.communicate()[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for text in lines:
        sys.stdout.write(text)
    return max(p.returncode for p in procs)


if __name__ == "__main__":
    sys.exit(main())
