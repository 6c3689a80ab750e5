"""Host wall of the chunked KNN job, and where a ``DeviceFeed`` chunk's
staging time goes.

Two parts, on the card (``--device cuda``, the default):

1. The NearestNeighbor CLI job on seeded elearn rows (100,000 train,
   20,000 test, the shape of ``chip_smoke.py`` phase 3): staged (K2), and
   with ``feed.chunk.rows=4096`` (K3) at each ``--depths`` entry
   (``default`` passes no ``feed.depth`` key, so the script also runs
   against a package that refuses the key). ``--rounds`` rounds, the jobs
   in turn within a round, each with a cold staged-table cache; one JSON
   line a job and round.
2. ``--stage`` (needs ``parallel.pipeline.DeviceFeed``): the staging of
   4096 x 9 f32 chunks alone, step by step (host array to tensor, copy
   into the thread's pinned buffer, the copy's queueing, the wait on its
   event) and the feed's own staging call on the same chunk, with 0 and
   with ``--busy`` Python threads that hold the GIL between short
   sleeps, as the split-ingest pool's workers do while they cut ids. One
   JSON line for each count of busy threads.

Run from the root of a checkout::

    python -m avenir_tpu_torch.scripts.feed_walls --rounds 3 --stage

or, to time another checkout's package with this script, put that
checkout first on ``PYTHONPATH`` and run this file by its path.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch

TRAIN, TEST, CHUNK, SEED = 100_000, 20_000, 4096, 20261016


def _write_csv(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")


def _jobs(work: str, depths):
    from avenir_tpu_torch.datagen import generators as G
    rows = G.elearn_rows(TRAIN + TEST, seed=SEED)
    p = lambda name: os.path.join(work, name)  # noqa: E731
    _write_csv(p("train.csv"), rows[:TRAIN])
    _write_csv(p("test.csv"), rows[TRAIN:])
    with open(p("elearn.json"), "w") as fh:
        json.dump(G.elearn_schema_json(), fh)
    with open(p("knn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\n"
                 f"feature.schema.file.path={p('elearn.json')}\n"
                 f"train.data.path={p('train.csv')}\n"
                 "top.match.count=5\nkernel.function=none\n"
                 "distance.scale=1000\nvalidation.mode=true\n"
                 "positive.class.value=fail\n")
    base = ["NearestNeighbor", p("test.csv"), None, "--conf",
            p("knn.properties")]
    jobs = {"staged": []}
    for depth in depths:
        keys = ["-D", f"feed.chunk.rows={CHUNK}"]
        if depth != "default":
            keys += ["-D", f"feed.depth={depth}"]
        jobs[f"chunked depth={depth}"] = keys
    return base, jobs


def _cold_cache() -> None:
    """Empty the staged-table cache where the package has one, so each
    job encodes its tables as a job in a process of its own does."""
    try:
        from avenir_tpu_torch.plan import reset_cache
    except ImportError:
        return
    reset_cache()


def job_walls(device: str, rounds: int, depths) -> None:
    from avenir_tpu_torch.cli.main import main
    with tempfile.TemporaryDirectory() as work:
        base, jobs = _jobs(work, depths)
        outputs = {}
        for r in range(rounds + 1):       # round 0 warms the kernels up
            for name, keys in jobs.items():
                out = os.path.join(work, f"{name.replace(' ', '_')}.txt")
                args = list(base)
                args[2] = out
                buf = io.StringIO()
                _cold_cache()
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = main(args + keys + ["--device", device])
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise SystemExit(f"{name}: the job returned {rc}")
                with open(out, "rb") as fh:
                    outputs.setdefault(name, fh.read())
                if r:
                    print(json.dumps({"job": name, "round": r,
                                      "wall_s": round(wall, 4)}),
                          flush=True)
        first = next(iter(outputs.values()))
        if any(o != first for o in outputs.values()):
            raise SystemExit("the jobs' prediction files differ")


def _busy(stop: threading.Event) -> None:
    """Hold the GIL in pure Python for ~1 ms, then sleep briefly."""
    while not stop.is_set():
        t_end = time.perf_counter() + 1e-3
        x = 0
        while time.perf_counter() < t_end:
            x += 1
        time.sleep(1e-5)


def stage_steps(device: str, busy_counts, chunks: int) -> None:
    from avenir_tpu_torch.parallel.pipeline import DeviceFeed
    dev = torch.device(device)
    host = np.random.default_rng(SEED).random((chunks * CHUNK, 9),
                                              dtype=np.float32)
    for busy in busy_counts:
        stop = threading.Event()
        threads = [threading.Thread(target=_busy, args=(stop,), daemon=True)
                   for _ in range(busy)]
        for t in threads:
            t.start()
        steps = {"as_tensor": [], "pinned_copy": [], "queue_h2d": [],
                 "event_wait": [], "stage_call": []}
        try:
            feed = DeviceFeed([], depth=1, device=dev)
            feed._bind_thread()
            stream = feed._side_stream()
            for i, lo in enumerate(range(0, host.shape[0], CHUNK)):
                t0 = time.perf_counter()
                t = torch.from_numpy(np.ascontiguousarray(
                    host[lo:lo + CHUNK]))
                t1 = time.perf_counter()
                pinned = feed._pinned(0, t)
                t2 = time.perf_counter()
                with torch.cuda.stream(stream):
                    staged = pinned.to(dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                t3 = time.perf_counter()
                event.synchronize()
                t4 = time.perf_counter()
                del staged
                # the feed's own staging call on the same chunk
                feed._stage((host[lo:lo + CHUNK],), i)
                t5 = time.perf_counter()
                for key, a, b in (("as_tensor", t0, t1),
                                  ("pinned_copy", t1, t2),
                                  ("queue_h2d", t2, t3),
                                  ("event_wait", t3, t4),
                                  ("stage_call", t4, t5)):
                    steps[key].append((b - a) * 1e3)
        finally:
            stop.set()
            for t in threads:
                t.join()
        print(json.dumps({
            "busy_threads": busy, "chunks": len(steps["as_tensor"]),
            "median_ms": {k: round(statistics.median(v), 4)
                          for k, v in steps.items()},
            "mean_ms": {k: round(statistics.fmean(v), 4)
                        for k, v in steps.items()}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--depths", default="default",
                    help="comma-separated feed.depth values or 'default'")
    ap.add_argument("--stage", action="store_true")
    ap.add_argument("--busy", default="0,8",
                    help="comma-separated counts of GIL-holding threads")
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--no-jobs", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("feed_walls: no CUDA device", file=sys.stderr)
        return 2
    if not args.no_jobs:
        job_walls(args.device, args.rounds, args.depths.split(","))
    if args.stage:
        stage_steps(args.device, [int(b) for b in args.busy.split(",")],
                    args.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
