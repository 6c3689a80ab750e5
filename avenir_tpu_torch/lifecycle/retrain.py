"""Retraining beside a live serving engine.

Counterpart of ``avenir_tpu/lifecycle/retrain.py``. The reference
retrains by hand: run the MapReduce trainer again, copy the model file,
restart the Storm topology. Here the same wave, a batch retrain over the
data gathered so far, runs in a background thread next to the engine,
publishes its result to the ``SnapshotRegistry``, and the engine swaps it
in at its next batch boundary (``swap.py``) with no event dropped.

``RetrainDaemon`` owns the cadence (an interval, and :meth:`request`,
from a drift detector or an operator), the telemetry spans
(``lifecycle.retrain`` around the train function, ``lifecycle.publish``
around the commit), the ``lifecycle.model_version`` hub gauge, and the
rule that a failed wave never takes serving down; the ``train_fn`` is
the wave. It returns ``{"pytree": state}`` or ``{"file_path": path}``,
with ``train_rows``, ``kind`` and ``extra`` where it has them.
:func:`bandit_refit_train_fn` is the online path's own wave,
:func:`boost_refit_train_fn` boosted serving's.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from avenir_tpu_torch.lifecycle.registry import Snapshot, SnapshotRegistry
from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.obs.exporters import (
    set_hub_gauges_if_live as _set_hub_gauges)
from avenir_tpu_torch.utils.device import DeviceLike


def bandit_refit_train_fn(learner_type: str, actions, config: Dict[str, Any],
                          reward_source: Callable[[], list],
                          seed: int = 0, device: DeviceLike = "cuda"
                          ) -> Callable[[], Dict[str, Any]]:
    """A retrain wave of the online path: a fresh learner on ``device``,
    refit from the reward ledger (``reward_source()`` returns the
    ``(action_id, reward)`` pairs gathered so far: a file, a broker
    sweep, a list). The snapshot is the learner's state, which a serving
    engine swaps in; the fold goes through ``set_reward_batch``, the
    serving path's own."""
    from avenir_tpu_torch.models.bandits.learners import Learner

    def train() -> Dict[str, Any]:
        learner = Learner(learner_type, list(actions), dict(config),
                          seed=seed, device=device)
        pairs = list(reward_source())
        if pairs:
            learner.set_reward_batch(pairs)
        return {"pytree": learner.state, "train_rows": len(pairs),
                "kind": "learner-state",
                "extra": {"learner_type": learner_type}}
    return train


def boost_refit_train_fn(table_source: Callable[[], Any],
                         config) -> Callable[[], Dict[str, Any]]:
    """A retrain wave of boosted-forest serving: a fresh boosted ensemble
    (``models.boost.grow_boosted``, K1's integer mode on the table's
    device) over whatever ``table_source()`` hands back (the gathered or
    refreshed ``EncodedTable``), published as its
    :func:`~avenir_tpu_torch.models.boost.serving_tables`. The budgets are
    the config's own bounds, the round count and ``(max_depth + 1) ×
    device_node_budget`` (no grown tree has more BFS nodes: the level
    program caps every level at the node budget), so every wave's tables
    have the same shapes and pass ``install_state``'s check however the
    retrained trees differ. The snapshot's kind is
    ``boost-serving-tables``, as the JAX package's."""
    from avenir_tpu_torch.models import boost as _boost

    def train() -> Dict[str, Any]:
        table = table_source()
        model = _boost.grow_boosted(table, config)
        tables = _boost.serving_tables(
            model, table, rounds_budget=config.n_rounds,
            node_budget=((config.tree.max_depth + 1)
                         * config.tree.device_node_budget))
        return {"pytree": tables, "train_rows": int(table.n_rows),
                "kind": "boost-serving-tables",
                "extra": {"rounds": len(model.trees),
                          "depth": config.tree.max_depth}}
    return train


class RetrainDaemon:
    """Background retrain waves that publish to a registry.

    ``start()`` starts the worker thread; a wave runs every
    ``interval_s`` seconds and whenever :meth:`request` fires. A wave that
    raises is counted (``errors``, ``last_error``) and never reaches the
    serving process. :meth:`run_once` runs one wave on the caller's thread
    (the CLI verb, tests)."""

    def __init__(self, registry: SnapshotRegistry,
                 train_fn: Callable[[], Dict[str, Any]],
                 interval_s: Optional[float] = None,
                 kind: str = "model"):
        self.registry = registry
        self.train_fn = train_fn
        self.interval_s = interval_s
        self.kind = kind
        self.waves = 0
        self.errors = 0
        self.last_version: Optional[int] = None
        self.last_error: Optional[BaseException] = None
        self._tel = telemetry.tracer()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- wave --------------------------------------------------------------

    def run_once(self) -> Optional[Snapshot]:
        """One retrain-and-publish wave: the committed snapshot, or None
        when the wave failed (the error counted)."""
        try:
            with self._tel.span("lifecycle.retrain"):
                result = self.train_fn()
            with self._tel.span("lifecycle.publish"):
                snap = self.registry.publish(
                    result.get("pytree"), file_path=result.get("file_path"),
                    kind=result.get("kind", self.kind),
                    train_rows=result.get("train_rows", 0),
                    extra=result.get("extra"))
        except Exception as exc:
            self.errors += 1
            self.last_error = exc
            _set_hub_gauges({"lifecycle.retrain_errors": self.errors})
            return None
        with self._lock:
            self.waves += 1
            self.last_version = snap.version
        _set_hub_gauges({"lifecycle.model_version": snap.version,
                         "lifecycle.retrain_waves": self.waves})
        return snap

    def request(self) -> None:
        """Ask for a wave now. Requests that land while a wave runs fold
        into one wave after it."""
        self._wake.set()

    # -- thread ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            fired = self._wake.wait(timeout=self.interval_s)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
            elif self.interval_s is None:
                continue
            self.run_once()

    def start(self) -> "RetrainDaemon":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lifecycle-retrain")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        self._thread = None

    def wait_for_waves(self, n: int, timeout: float = 60.0) -> bool:
        """Wait until ``n`` waves have completed: True, or False at the
        timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.waves >= n:
                    return True
            time.sleep(0.01)
        return False

    def __enter__(self) -> "RetrainDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
