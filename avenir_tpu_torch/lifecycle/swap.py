"""Hot swap: install a published snapshot at a batch boundary.

Counterpart of ``avenir_tpu/lifecycle/swap.py``. The reference swaps
models by restarting the Storm topology, dropping or replaying every
in-flight tuple. Here the serving engine and the online loop take a
snapshot through ``swap_state(state, version)`` at a batch boundary, and
that is the same as stopping, restoring the snapshot and resuming: a
batch already queued on the card holds its actions (tensors computed
from the old state), the next one reads the new state, and no event is
dropped or served twice.

:func:`install_state` installs a copy: the learner's updates return new
tensors and never write into the installed ones, and the copy keeps the
snapshot (a registry payload, a second engine's state) apart from the
learner.

:class:`LifecycleClient` is the subscriber half a serving process runs:
it polls a ``RegistryWatcher`` on its own cadence and swaps every target
whose state schema matches the new snapshot (a mismatch is counted, not
raised: a publisher rolling out a new learner shape must not take the
servers down).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from avenir_tpu_torch.lifecycle.registry import (
    SnapshotRegistry, state_schema_hash, tree_flatten, tree_unflatten_like)
from avenir_tpu_torch.models.bandits.learners import FIELDS, LearnerState
from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.obs.exporters import (
    set_hub_gauges_if_live as _hub_gauges)


def install_state(learner, snapshot: Any) -> None:
    """Replace ``learner.state`` with a copy of ``snapshot`` on the
    learner's device, in the live state's dtypes.

    The snapshot's structure and every leaf's shape are checked against
    the live state before anything is installed: a mismatch raises here
    with the state untouched, not inside the next step. A ``LearnerState``
    takes a ``LearnerState`` or a dict of exactly its fields (host arrays
    such as ``LearnerState.to_numpy``'s, or tensors). A learner with an
    ``install_state(snapshot)`` method of its own gets the snapshot
    handed to it, and validates it itself."""
    hook = getattr(learner, "install_state", None)
    if callable(hook):
        hook(snapshot)
        return
    live = learner.state
    if (isinstance(live, LearnerState) and isinstance(snapshot, dict)
            and set(snapshot) == {name for name, _ in FIELDS}):
        snapshot = LearnerState(**snapshot)
    ref_leaves, ref_def = tree_flatten(live, host=False)
    new_leaves, new_def = tree_flatten(snapshot, host=False)
    if ref_def != new_def:
        raise ValueError(f"snapshot structure {new_def} does not match "
                         f"live state {ref_def}")
    names = ([name for name, _ in FIELDS] if isinstance(live, LearnerState)
             else None)
    for i, (ref, new) in enumerate(zip(ref_leaves, new_leaves)):
        if tuple(np.shape(new)) != tuple(np.shape(ref)):
            what = f"field {names[i]}" if names else f"leaf {i}"
            raise ValueError(f"snapshot {what} shape "
                             f"{tuple(np.shape(new))} != live state shape "
                             f"{tuple(np.shape(ref))}")
    learner.state = tree_unflatten_like(live, new_leaves)


def record_swap(tel, t0: float, version: Optional[int],
                swap_count: int) -> float:
    """The swap's telemetry: the ``lifecycle.swap`` latency span, and the
    ``lifecycle.swap_total`` and ``lifecycle.model_version`` hub gauges.
    Returns the ms since ``t0``."""
    ms = (time.perf_counter() - t0) * 1e3
    if tel.enabled:
        tel.record("lifecycle.swap", ms)
    gauges: Dict[str, float] = {"lifecycle.swap_total": swap_count}
    if version is not None:
        gauges["lifecycle.model_version"] = version
    _hub_gauges(gauges)
    return ms


class BoundaryStopQueues:
    """A queue adapter that stops at an exact count of popped events: the
    replay half of the swap's parity contract.

    A live swap at batch boundary b swaps, then folds: rewards queued at
    the boundary fold into the new state. A replay through
    ``run(max_events=...)`` would fold that backlog into the state about
    to be replaced on its way out (``run``'s exit drain), so this wrapper
    models the stop: once ``budget`` events have been popped, pops and
    reward drains come back empty (a stopped process folds nothing), and
    the boundary's rewards wait for the restored engine's first fold, in
    the live order. ``set_budget(None)`` reopens it for the last leg.

    Budgets land on batch boundaries (multiples of the engine's pop cap),
    so the pops, and with them the draws' chunking, match the live
    run's."""

    def __init__(self, queues):
        self.queues = queues
        self._budget: Optional[int] = None
        self._popped = 0

    def set_budget(self, budget: Optional[int]) -> None:
        self._budget = budget
        self._popped = 0

    @property
    def _gate_open(self) -> bool:
        return self._budget is None or self._popped < self._budget

    def pop_events(self, max_n: int) -> list:
        if not self._gate_open:
            return []
        if self._budget is not None:
            max_n = min(max_n, self._budget - self._popped)
        out = self.queues.pop_events(max_n)
        self._popped += len(out)
        return out

    def pop_event(self):
        if not self._gate_open:
            return None
        event_id = self.queues.pop_event()
        if event_id is not None:
            self._popped += 1
        return event_id

    def drain_rewards(self, max_items: Optional[int] = None) -> list:
        if not self._gate_open:
            return []
        return self.queues.drain_rewards(max_items)

    def __getattr__(self, name):
        return getattr(self.queues, name)


class LifecycleClient:
    """Registry subscription and swap fan-out for a serving process.

    ``targets`` maps a name (a group id, or anything) to an object with
    ``swap_state(state, version=)`` and a live ``learner.state`` (a
    ``ServingEngine``, an ``OnlineLearnerLoop``). :meth:`poll_and_swap`
    runs on the caller's cadence: one registry read a call, no work while
    the head stays. A snapshot naming a ``group`` in its manifest's extra
    swaps only that target; otherwise every target swaps."""

    def __init__(self, registry_or_dir, from_version: Optional[int] = None,
                 min_poll_interval_s: float = 0.0):
        self.registry = (registry_or_dir
                         if isinstance(registry_or_dir, SnapshotRegistry)
                         else SnapshotRegistry(str(registry_or_dir)))
        self.watcher = self.registry.subscribe(from_version)
        self.targets: Dict[str, Any] = {}
        self.swaps = 0
        self.rejected = 0
        self.last_version: Optional[int] = None
        # at most one registry read this often (0: every call)
        self.min_poll_interval_s = float(min_poll_interval_s)
        self._last_poll = 0.0
        self._tel = telemetry.tracer()

    def register(self, name: str, target: Any) -> None:
        self.targets[name] = target

    def poll_and_swap(self) -> Optional[int]:
        """Read the registry's head and swap the matching targets to a new
        version. Returns the version swapped in, else None. Never raises:
        a bad snapshot counts in ``lifecycle.swap_rejected`` and serving
        goes on with the current state."""
        if self.min_poll_interval_s > 0.0:
            now = time.monotonic()
            if now - self._last_poll < self.min_poll_interval_s:
                return None
            self._last_poll = now
        try:
            snap = self.watcher.poll()
        except Exception:
            return None
        if snap is None or not self.targets:
            return None
        group = (snap.manifest.get("extra") or {}).get("group")
        swapped = None
        for name, target in self.targets.items():
            if group is not None and name != group:
                continue
            try:
                like = target.learner.state
                if not snap.has_payload:
                    raise ValueError(
                        f"v{snap.version} is a file artifact "
                        f"(kind={snap.manifest.get('kind')!r}), not a "
                        f"swappable learner-state pytree")
                if (snap.schema_hash is not None
                        and snap.schema_hash != state_schema_hash(like)):
                    raise ValueError(
                        f"schema hash {snap.schema_hash} != live state")
                target.swap_state(snap.restore(like=like),
                                  version=snap.version)
                swapped = snap.version
            except Exception:
                self.rejected += 1
                _hub_gauges({"lifecycle.swap_rejected": self.rejected})
        if swapped is not None:
            self.swaps += 1
            self.last_version = swapped
        return swapped
