"""Checkpoint / resume for the online loop and iterative drivers.

Counterpart of ``avenir_tpu/utils/checkpoint.py``: a typed checkpoint of
(state tree, step counter), so a killed process resumes with the same
learner state bits instead of replaying its reward history. The JAX
package writes orbax checkpoints; this port writes each step as one
``torch.save`` file of host tensors under ``<dir>/<step>/``:

    ckpt = Checkpointer(dir, max_to_keep=3)
    ckpt.save(step, state_tree)
    state = ckpt.restore(like=state_tree)   # latest step
    step  = ckpt.latest_step()

A tree is a dict, list, tuple or dataclass (a ``LearnerState``) of
tensors, numpy arrays and numbers. Restore with ``like=`` gives back the
types, dtypes and devices of ``like``'s leaves; without it, leaves come
back as host tensors and numpy arrays.

The commit contract is the JAX package's: ``latest_step`` (and so an
argument-less ``restore``) names only a step whose save completed. A
step's directory appears by one rename after its file is written, and
the ``COMMITTED`` marker, rewritten atomically (temp + ``os.replace``)
strictly after that, names it; a process killed mid-save leaves the
previous marker in place. Saves are asynchronous, as the serving loop
needs (a blocking write would spike action latency): ``save`` copies the
tree to the host before it returns (the caller may go on changing its
tensors) and writes it on a thread; its marker lands at the next save,
restore, ``latest_step``, ``wait_until_finished`` or ``close``, each of
which waits for the write first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

_COMMIT_MARKER = "COMMITTED"
_STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are host tensors of their own
    storage (a CPU tensor is cloned: the caller's stays free to change)
    and whose dataclasses are dicts tagged with their field names."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_host(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(saved: Any, like: Any) -> Any:
    """``saved`` rebuilt in ``like``'s structure, types, dtypes and
    devices; a leaf whose shape differs raises."""
    if isinstance(like, torch.Tensor):
        out = torch.as_tensor(np.asarray(saved) if not isinstance(
            saved, torch.Tensor) else saved)
        if tuple(out.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(out.shape)} "
                             f"!= {tuple(like.shape)}")
        return out.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        out = np.asarray(saved.numpy() if isinstance(saved, torch.Tensor)
                         else saved)
        if out.shape != like.shape:
            raise ValueError(f"checkpoint leaf shape {out.shape} != "
                             f"{like.shape}")
        return out.astype(like.dtype)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _like(saved[f.name],
                                           getattr(like, f.name))
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _like(saved[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(s, v) for s, v in zip(saved, like))
    return saved


class Checkpointer:
    """Step-numbered tree checkpoints under one directory, committed
    atomically (module docstring). Explicit ``restore(step=n)`` reads any
    step whose file is whole, committed or not."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pending_step: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    # -- commit marker -----------------------------------------------------

    def _marker_path(self) -> str:
        return os.path.join(self.directory, _COMMIT_MARKER)

    def _write_marker(self, step: int) -> None:
        """Atomic: the marker is either the old committed step or the new
        one, never a torn write."""
        tmp = f"{self._marker_path()}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump({"step": int(step)}, fh)
            os.replace(tmp, self._marker_path())
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _read_marker(self) -> Optional[int]:
        try:
            with open(self._marker_path()) as fh:
                return int(json.load(fh)["step"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    # -- writing -----------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _write_step(self, step: int, host_tree: Any) -> None:
        """The step's file into a temp dir, then one rename into place."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, _STATE_FILE)
        with open(path, "wb") as fh:
            torch.save(host_tree, fh)
            fh.flush()
            os.fsync(fh.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def _run_write(self, step: int, host_tree: Any) -> None:
        try:
            self._write_step(step, host_tree)
        except BaseException as exc:  # surfaced by the next wait
            self._write_error = exc

    def _commit(self, step: int) -> None:
        self._write_marker(step)
        self._prune()

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        keep = self.steps()[-int(self.max_to_keep):]
        for step in self.steps():
            if step not in keep:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Wait for an async write in flight and commit its step."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            exc, self._write_error = self._write_error, None
            self._pending_step = None
            raise exc
        if self._pending_step is not None:
            step, self._pending_step = self._pending_step, None
            self._commit(step)

    def save(self, step: int, tree: Any) -> None:
        """Return once ``tree`` is copied to the host; the write runs on a
        thread and commits at the next wait."""
        self.wait_until_finished()
        host_tree = _to_host(tree)
        self._pending_step = int(step)
        self._writer = threading.Thread(
            target=self._run_write, args=(int(step), host_tree),
            name="avenir-checkpoint", daemon=True)
        self._writer.start()

    # -- reading -----------------------------------------------------------

    def steps(self) -> List[int]:
        """Every step whose file is in place, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _STATE_FILE)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step: the marker's where its step is on
        disk, else (a directory without a marker) the newest step."""
        self.wait_until_finished()
        committed = self._read_marker()
        steps = self.steps()
        if committed is not None and committed in steps:
            return committed
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        with open(os.path.join(self._step_dir(step), _STATE_FILE),
                  "rb") as fh:
            saved = torch.load(fh, map_location="cpu", weights_only=False)
        return saved if like is None else _like(saved, like)

    def close(self) -> None:
        self.wait_until_finished()


_COUNTER_NAMES = ("events", "rewards", "actions_written")


def save_loop_state(ckpt: Checkpointer, step: int, learner_state: Any,
                    stats: Optional[dict] = None) -> None:
    """Checkpoint an online-loop learner state plus the LoopStats
    counters (fixed order: events, rewards, actions_written)."""
    stats = stats or {}
    counters = np.asarray([int(stats.get(k, 0)) for k in _COUNTER_NAMES],
                          np.int64)
    ckpt.save(step, {"learner": learner_state, "counters": counters})


def restore_loop_state(ckpt: Checkpointer, learner_state_like: Any,
                       step: Optional[int] = None):
    """Returns (learner_state, stats dict, step restored)."""
    if step is None:
        step = ckpt.latest_step()
    payload = ckpt.restore(
        step, like={"learner": learner_state_like,
                    "counters": np.zeros(3, np.int64)})
    stats = {k: int(v) for k, v in
             zip(_COUNTER_NAMES, payload["counters"])}
    return payload["learner"], stats, step
