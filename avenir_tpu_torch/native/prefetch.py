"""The prefetching shard reader: shard files featurized (and staged to the
card) on worker threads while the caller computes on the shard before,
with the task semantics of a Hadoop job: bounded retries, per-shard
deadlines and speculative duplicates of stragglers.

Counterpart of ``avenir_tpu/native/prefetch.py``.

- Shard n+1, and more up to ``depth``, featurizes on attempt threads,
  each file through the multi-threaded C++ encoder, while the consumer
  works on shard n. Order is kept: the iterator yields shard i before
  shard i+1 whatever order the attempts finish in.
- A failed attempt reaches the consuming iterator as a
  :class:`ShardError` naming the shard, after ``retries`` re-attempts;
  attempts are daemon threads the consumer only observes, so a failure
  cannot deadlock it.
- ``shard_timeout_s`` bounds one attempt's wall time: an attempt past it
  is replaced (budget permitting) without waiting for it.
- ``speculate``: once ``speculative_min_samples`` shards have finished, a
  shard running longer than ``speculative_factor`` × the p99 of finished
  attempts gets a duplicate on a spare slot. The first result wins; the
  loser's is dropped and counted (``LoaderStats.duplicates_discarded``).
  The bytes stay the same because each attempt is deterministic: both
  featurize and stage the same bytes.

The bad-row policy (``on_bad_row``, ``max_bad_fraction``,
``quarantine_dir``) goes to ``loader.transform_file`` with one shared
:class:`~avenir_tpu_torch.native.loader.ParseStats`, whose ``per_file``
counts are exact across shards.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from avenir_tpu_torch.native.loader import ParseStats, transform_file
from avenir_tpu_torch.parallel.pipeline import claim_table, stage_table
from avenir_tpu_torch.utils.dataset import EncodedTable, Featurizer
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device


class ShardError(RuntimeError):
    """A shard spent its attempt budget. ``path`` names the shard; the
    failing attempt's exception is chained as ``__cause__``."""

    def __init__(self, path: str, message: str):
        super().__init__(message)
        self.path = path


@dataclass
class LoaderStats:
    """Retry and speculation accounting of one exhausted loader."""

    shards: int = 0                  # shards yielded
    shard_retries: int = 0           # re-attempts (failure or deadline)
    speculative_launches: int = 0    # straggler duplicates launched
    speculative_wins: int = 0        # duplicates that finished first
    duplicates_discarded: int = 0    # losing attempts (result dropped)
    attempt_durations_s: List[float] = dc_field(default_factory=list)


class _ShardTask:
    """One shard's attempts: result slot, errors, timing.

    ``budget_used`` counts the launches that are not speculative (the
    retry budget); ``inflight`` counts attempts still running. A spent
    budget with an attempt still racing means wait, not raise: the first
    result wins, and a losing duplicate's error must not kill a shard
    whose other attempt is about to land."""

    __slots__ = ("path", "index", "cond", "result", "done", "won_spec",
                 "errors", "errors_seen", "attempts", "budget_used",
                 "inflight", "spec_launched", "first_start", "deadline")

    def __init__(self, path: str, index: int):
        self.path = path
        self.index = index
        self.cond = threading.Condition()
        self.result = None
        self.done = False
        self.won_spec = False
        self.errors: list = []
        self.errors_seen = 0
        self.attempts = 0
        self.budget_used = 0
        self.inflight = 0
        self.spec_launched = False
        self.first_start: Optional[float] = None
        self.deadline: Optional[float] = None


class PrefetchLoader:
    """Iterate the ``EncodedTable`` of each shard file, ``depth`` ahead.

    The featurizer must be fitted; the loader only transforms. Tables are
    featurized on the host. ``to_device=True`` adds the stage
    ``parallel.pipeline.stage_table`` on the worker thread, so shard n+1's
    copy to ``device`` (default ``"cuda"``, which raises without a card)
    overlaps shard n's compute, and the iterator hands each staged table
    to the consumer's stream (``claim_table``). ``bucket`` is accepted
    with ``to_device`` and pads nothing (``stage_table``). ``stage``
    replaces the default stage with any callable run on the worker thread.

    Resilience (module docstring): ``retries`` (default 1: Hadoop's
    maxattempts=2), ``shard_timeout_s`` (default None: no deadline),
    ``speculate``, ``speculative_factor``, ``speculative_min_samples``,
    ``speculative_min_wait_s``, and the bad-row policy. Read
    :attr:`stats` and :attr:`parse_stats` once the iterator is exhausted.
    """

    def __init__(self, fz: Featurizer, paths: Sequence[str],
                 delim_regex: str = ",", with_labels: bool = True,
                 depth: int = 2, n_threads: int = 0,
                 force_python: bool = False, to_device: bool = False,
                 bucket: bool = False, device: DeviceLike = "cuda",
                 stage: Optional[Callable[[EncodedTable], object]] = None,
                 retries: int = 1,
                 shard_timeout_s: Optional[float] = None,
                 speculate: bool = True,
                 speculative_factor: float = 4.0,
                 speculative_min_samples: int = 3,
                 speculative_min_wait_s: float = 2.0,
                 on_bad_row: str = "raise",
                 max_bad_fraction: float = 0.1,
                 quarantine_dir: Optional[str] = None,
                 parse_stats: Optional[ParseStats] = None):
        if not fz.fitted:
            raise RuntimeError("fit the Featurizer before prefetching")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        if stage is not None and to_device:
            raise ValueError("pass to_device=True OR a custom stage, "
                             "not both")
        if bucket and not to_device:
            raise ValueError("bucket=True only applies to the to_device "
                             "stage; pass to_device=True (or bucket in "
                             "your custom stage)")
        self._fz = fz
        self._paths: List[str] = list(paths)
        self._delim = delim_regex
        self._with_labels = with_labels
        self._depth = depth
        self._n_threads = n_threads
        self._force_python = force_python
        self._to_device = to_device
        if to_device:
            dev = resolve_device(device)
            stage = lambda t: stage_table(t, device=dev,  # noqa: E731
                                          bucket=bucket)
        self._stage = stage
        self._retries = retries
        self._timeout_s = shard_timeout_s
        self._speculate = speculate
        self._spec_factor = speculative_factor
        self._spec_min_samples = max(speculative_min_samples, 1)
        self._spec_min_wait_s = speculative_min_wait_s
        self._on_bad_row = on_bad_row
        self._max_bad_fraction = max_bad_fraction
        self._quarantine_dir = quarantine_dir
        self.parse_stats = (parse_stats if parse_stats is not None
                            else ParseStats())
        self.stats = LoaderStats()
        self._stats_lock = threading.Lock()
        # first attempts hold at most `depth` slots (each parse is already
        # multi-threaded in C++); relaunches (speculative, past a deadline,
        # or a retry while the first may still hold its slot) take ONE
        # spare slot, so a wedged attempt never starves its replacement
        self._sem = threading.Semaphore(depth)
        self._spare_sem = threading.Semaphore(1)

    def _load(self, path: str) -> EncodedTable:
        table = transform_file(self._fz, path, self._delim,
                               self._with_labels,
                               force_python=self._force_python,
                               n_threads=self._n_threads,
                               on_bad_row=self._on_bad_row,
                               max_bad_fraction=self._max_bad_fraction,
                               quarantine_dir=self._quarantine_dir,
                               parse_stats=self.parse_stats, device="cpu")
        if self._stage is not None:
            table = self._stage(table)
        return table

    def __len__(self) -> int:
        return len(self._paths)

    # -- attempt threads ----------------------------------------------------
    def _launch(self, task: _ShardTask, spare: bool,
                speculative: bool = False) -> None:
        with task.cond:
            task.attempts += 1
            task.inflight += 1
            if not speculative:
                task.budget_used += 1
            if task.first_start is None:
                task.first_start = time.perf_counter()
                if self._timeout_s:
                    task.deadline = task.first_start + self._timeout_s
        sem = self._spare_sem if spare else self._sem
        t = threading.Thread(target=self._attempt,
                             args=(task, sem, speculative),
                             name=f"avenir-shard-{task.index}", daemon=True)
        t.start()

    def _attempt(self, task: _ShardTask, sem: threading.Semaphore,
                 speculative: bool) -> None:
        table = None
        error = None
        with sem:
            t0 = time.perf_counter()
            try:
                table = self._load(task.path)
            except BaseException as exc:   # re-raised at the consumer
                error = exc
            dt = time.perf_counter() - t0
        with task.cond:
            task.inflight -= 1
            if error is not None:
                task.errors.append(error)
            elif task.done:
                # the first result won already; this duplicate is dropped
                with self._stats_lock:
                    self.stats.duplicates_discarded += 1
            else:
                task.result = table
                task.done = True
                task.won_spec = speculative
                with self._stats_lock:
                    self.stats.attempt_durations_s.append(dt)
            task.cond.notify_all()

    def _spec_threshold_s(self) -> Optional[float]:
        """The straggler bar: ``speculative_factor`` × the p99 of finished
        attempts, once there are enough, and never below the least
        wait."""
        with self._stats_lock:
            samples = list(self.stats.attempt_durations_s)
        if len(samples) < self._spec_min_samples:
            return None
        p99 = float(np.percentile(np.asarray(samples), 99))
        return max(self._spec_factor * p99, self._spec_min_wait_s)

    # -- consumer side ------------------------------------------------------
    def __iter__(self) -> Iterator[EncodedTable]:
        if not self._paths:
            return
        tasks = [_ShardTask(p, i) for i, p in enumerate(self._paths)]
        launched = 0

        def top_up(consumed: int) -> None:
            nonlocal launched
            while launched < len(tasks) and launched < consumed + self._depth:
                self._launch(tasks[launched], spare=False)
                launched += 1

        top_up(0)
        for i, task in enumerate(tasks):
            while True:
                relaunch = False
                launch_spec = False
                with task.cond:
                    if task.done:
                        result = task.result
                        task.result = None    # the loader keeps no shard
                        won_spec = task.won_spec
                        break
                    if len(task.errors) > task.errors_seen:
                        # a failed attempt: retry within the budget; with
                        # the budget spent and another attempt still
                        # racing, wait (first result wins); raise only
                        # once nothing runs
                        task.errors_seen = len(task.errors)
                        exc = task.errors[-1]
                        if task.budget_used <= self._retries:
                            relaunch = True
                            if self._timeout_s:   # a fresh attempt gets a
                                task.deadline = (time.perf_counter()
                                                 + self._timeout_s)
                        elif task.inflight == 0:
                            raise ShardError(
                                task.path,
                                f"shard {task.path} failed after "
                                f"{task.attempts} attempt(s): "
                                f"{exc!r}") from exc
                    else:
                        now = time.perf_counter()
                        elapsed = (now - task.first_start
                                   if task.first_start is not None else 0.0)
                        # the per-shard deadline: a stuck attempt is
                        # replaced (budget permitting), never waited out
                        if task.deadline is not None and now > task.deadline:
                            if task.budget_used <= self._retries:
                                relaunch = True
                                task.deadline = now + self._timeout_s
                            elif task.spec_launched:
                                # a replacement races already: extend
                                # rather than launch a second
                                task.deadline = now + self._timeout_s
                            else:
                                raise ShardError(
                                    task.path,
                                    f"shard {task.path} exceeded its "
                                    f"{self._timeout_s}s deadline on all "
                                    f"{task.attempts} attempt(s)")
                        if not relaunch and (self._speculate
                                             and not task.spec_launched):
                            bar = self._spec_threshold_s()
                            if bar is not None and elapsed > bar:
                                task.spec_launched = True
                                launch_spec = True
                        if not relaunch and not launch_spec:
                            task.cond.wait(timeout=0.05)
                            continue
                # relaunch outside task.cond: a thread start and a
                # semaphore must not run under the lock
                if relaunch:
                    with self._stats_lock:
                        self.stats.shard_retries += 1
                    self._launch(task, spare=True)
                if launch_spec:
                    with self._stats_lock:
                        self.stats.speculative_launches += 1
                    self._launch(task, spare=True, speculative=True)
            if won_spec:
                with self._stats_lock:
                    self.stats.speculative_wins += 1
            with self._stats_lock:
                self.stats.shards += 1
            top_up(i + 1)
            yield claim_table(result) if self._to_device else result
        self._publish()

    def _publish(self) -> None:
        """Exhaustion hook: the exact counters to the hub when it is
        live (``set_hub_gauges_if_live`` never raises)."""
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        set_hub_gauges_if_live({
            "loader.shard_retries": float(self.stats.shard_retries),
            "loader.speculative_wins": float(self.stats.speculative_wins),
            "loader.duplicates_discarded":
                float(self.stats.duplicates_discarded),
        })
