"""Versioned, file-backed snapshot registry of model and learner states.

Counterpart of ``avenir_tpu/lifecycle/registry.py`` (numpy and the
standard library, copied), whose files it reads and writes unchanged: a
registry the JAX package published restores here, and the other way
round. The reference hands state between its batch (MapReduce) and online
(Storm) halves through bare files and an out-of-band "copy the model,
restart the topology" step; this is that bridge with versions: a
directory of immutable, monotonically numbered snapshot dirs and an
atomically updated ``LATEST`` pointer, so a publisher (``RetrainDaemon``,
a batch verb, the serving engine) and any number of subscribers share
artifacts without ever reading a half-written one.

Layout under the registry directory::

    v0000001/
        manifest.json    version, created_at, schema_hash, train_rows,
                         parent_version, kind, extra metadata
        payload.npz      the state's leaves (leaf_000..leaf_N), or
        artifact         a verbatim published file (file snapshots)
    LATEST               {"version": N}, the committed head

Every snapshot is assembled in a temp dir on the same filesystem and
``os.replace``d into place, and ``LATEST`` is rewritten through a temp
file: a kill mid-publish leaves the previous head whole (an orphaned
``.tmp-*`` dir is swept by a later publish).

A state is a tree of tensors: a learner's ``LearnerState``, or nested
dicts, lists and tuples of tensors, arrays and numbers. Its leaves are
stored in the JAX package's flatten order (dict keys sorted, a
``LearnerState`` in its fields' order, its key as the uint32 ``[2]`` JAX
holds), and ``state_schema_hash`` hashes the ``jax.tree_util`` treedef
string JAX prints for the same tree (``tree_structure``), so both
packages agree on which snapshots fit which state.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.models.bandits.learners import FIELDS, LearnerState

_VERSION_RE = re.compile(r"^v(\d{7,})$")
_TMP_RE = re.compile(r"^\.tmp-(\d+)-")
_LATEST = "LATEST"
_MANIFEST = "manifest.json"
_PAYLOAD = "payload.npz"
_ARTIFACT = "artifact"

# a publish assembles one snapshot in seconds: past this age a temp dir is
# an orphan whatever pid it names (a publisher on another host sharing the
# filesystem can share a pid with a live local process)
_TMP_STALE_S = 3600.0


# -- the tree of a state ----------------------------------------------------

def _leaf_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_leaf(leaf: Any, field_name: Optional[str]) -> np.ndarray:
    """A leaf as the host array JAX holds (a ``LearnerState``'s key as
    uint32)."""
    arr = _leaf_array(leaf)
    return arr.astype(np.uint32) if field_name == "key" else arr


def _leaf_spec(leaf: Any, field_name: Optional[str]) -> str:
    """``shape:dtype.str`` of the host array JAX holds for a leaf, from the
    tensor's metadata alone: nothing read from the card."""
    if field_name == "key":
        dtype = np.dtype(np.uint32)
    elif isinstance(leaf, torch.Tensor):
        dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
    else:
        dtype = np.asarray(leaf).dtype
    return f"{tuple(np.shape(leaf))}:{dtype.str}"


def _structure(tree: Any, leaves: List[Any],
               leaf: Callable[[Any, Optional[str]], Any]) -> str:
    """``tree``'s node as ``jax.tree_util`` prints it, ``leaf(value,
    field name or None)`` of each of its leaves appended to ``leaves`` in
    JAX's flatten order."""
    if isinstance(tree, LearnerState):
        leaves.extend(leaf(getattr(tree, name), name) for name, _ in FIELDS)
        return ("CustomNode(LearnerState[()], ["
                + ", ".join("*" for _ in FIELDS) + "])")
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k], leaves, leaf)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(x, leaves, leaf)
                               for x in tree) + "]"
    if isinstance(tree, tuple):
        inner = [_structure(x, leaves, leaf) for x in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
            + ")"
    leaves.append(leaf(tree, None))
    return "*"


def tree_flatten(tree: Any, host: bool = True) -> Tuple[List[Any], str]:
    """(the leaves in JAX's flatten order, the treedef string
    ``str(jax.tree_util.tree_structure(tree))`` gives). The leaves are
    host arrays as JAX holds them; with ``host`` False, the tree's own
    tensors and values, nothing read from the card."""
    leaves: List[Any] = []
    treedef = _structure(tree, leaves, _host_leaf if host
                         else (lambda value, _: value))
    return leaves, f"PyTreeDef({treedef})"


def _as_like(value: Any, like: Any) -> Any:
    """A leaf as ``like``'s kind: a new tensor on its device in its dtype
    (JAX's uint32 key words widened to the port's int64), or a host array
    in its dtype."""
    if isinstance(like, torch.Tensor):
        if isinstance(value, torch.Tensor):
            return value.detach().to(like.device, like.dtype, copy=True)
        arr = np.asarray(value)
        if like.dtype == torch.int64:
            arr = arr.astype(np.int64)
        return torch.as_tensor(arr).to(like.device, like.dtype, copy=True)
    return np.array(_leaf_array(value), dtype=np.asarray(like).dtype)


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if isinstance(like, LearnerState):
        return LearnerState(**{name: _as_like(next(it), getattr(like, name))
                               for name, _ in FIELDS})
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, it) for x in like)
    return _as_like(next(it), like)


def tree_unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` (JAX's flatten order; host arrays or tensors) in
    ``like``'s structure, each leaf a fresh copy of ``like``'s kind,
    device and dtype."""
    return _rebuild(like, iter(leaves))


def state_schema_hash(tree: Any) -> str:
    """Fingerprint of a state's structure and leaf shapes and dtypes (not
    its values, which stay on the card): two states swap into each other
    iff their hashes match. The JAX package's hash of the same tree: the
    treedef string, then ``shape:dtype.str`` a leaf."""
    specs: List[str] = []
    treedef = _structure(tree, specs, _leaf_spec)
    return hashlib.sha256("|".join([f"PyTreeDef({treedef})"] + specs)
                          .encode()).hexdigest()[:16]


# -- snapshots ----------------------------------------------------------------

@dataclass
class Snapshot:
    """One resolved registry version: its manifest and its payload."""

    version: int
    path: str
    manifest: Dict[str, Any] = field(default_factory=dict)

    @property
    def schema_hash(self) -> Optional[str]:
        return self.manifest.get("schema_hash")

    @property
    def has_payload(self) -> bool:
        """True when the snapshot holds a state (``restore`` works), False
        for a verbatim file artifact (``artifact_path``)."""
        return os.path.isfile(os.path.join(self.path, _PAYLOAD))

    def restore(self, like: Any = None):
        """The state's leaves. With ``like``, in ``like``'s structure,
        each a fresh tensor on its device in its dtype; without it, a list
        of host arrays in flatten order."""
        with np.load(os.path.join(self.path, _PAYLOAD)) as zf:
            leaves = [zf[f"leaf_{i:03d}"] for i in range(len(zf.files))]
        if like is None:
            return leaves
        n_like = len(tree_flatten(like, host=False)[0])
        if n_like != len(leaves):
            raise ValueError(f"snapshot v{self.version} has {len(leaves)} "
                             f"leaves, like= has {n_like}")
        return tree_unflatten_like(like, leaves)

    def artifact_path(self) -> str:
        """The path of a file snapshot's verbatim artifact."""
        path = os.path.join(self.path, _ARTIFACT)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"snapshot v{self.version} carries no file artifact")
        return path


class SnapshotRegistry:
    """Publish/subscribe artifact store over one directory: one publisher
    and any number of subscriber processes on a shared filesystem.
    Publishing is rename-atomic and subscribers read committed versions
    through ``LATEST`` only. Concurrent publishers are tolerated (a
    version taken by another is retried with the next) but ``LATEST``
    is then last-writer-wins."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    # -- read side ---------------------------------------------------------

    def _scan_versions(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            m = _VERSION_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def versions(self) -> List[int]:
        """Committed versions, ascending."""
        return self._scan_versions()

    def latest_version(self) -> Optional[int]:
        """The committed head: the ``LATEST`` pointer where it is whole and
        names a complete snapshot, else the newest complete snapshot dir
        (a crash between the snapshot's rename and the pointer's write
        leaves a complete snapshot, so serving it is right)."""
        try:
            with open(os.path.join(self.directory, _LATEST)) as fh:
                v = int(json.load(fh)["version"])
            if os.path.isfile(os.path.join(self._vdir(v), _MANIFEST)):
                return v
        except (OSError, ValueError, KeyError):
            pass
        scanned = self._scan_versions()
        return scanned[-1] if scanned else None

    def _vdir(self, version: int) -> str:
        return os.path.join(self.directory, f"v{version:07d}")

    def get(self, version: int) -> Snapshot:
        path = self._vdir(version)
        with open(os.path.join(path, _MANIFEST)) as fh:
            manifest = json.load(fh)
        return Snapshot(version=version, path=path, manifest=manifest)

    def latest(self) -> Optional[Snapshot]:
        v = self.latest_version()
        return self.get(v) if v is not None else None

    def latest_where(self, kind: Optional[str] = None,
                     **extra_match) -> Optional[Snapshot]:
        """The newest committed snapshot whose manifest has ``kind`` and
        each ``extra_match`` key in its ``extra``, scanned newest first."""
        for version in reversed(self._scan_versions()):
            try:
                snap = self.get(version)
            except (OSError, json.JSONDecodeError):
                continue            # pruned away mid-scan
            if kind is not None and snap.manifest.get("kind") != kind:
                continue
            extra = snap.manifest.get("extra") or {}
            if all(extra.get(k) == v for k, v in extra_match.items()):
                return snap
        return None

    def subscribe(self,
                  from_version: Optional[int] = None) -> "RegistryWatcher":
        """A polling watcher whose ``poll()`` returns each new head once.
        ``from_version=None`` starts at the current head (only later
        publishes fire); ``0`` gives the current head on the first poll."""
        if from_version is None:
            from_version = self.latest_version() or 0
        return RegistryWatcher(self, from_version)

    # -- write side --------------------------------------------------------

    def publish(self, pytree: Any = None, *, file_path: Optional[str] = None,
                kind: str = "model", train_rows: int = 0,
                extra: Optional[Dict[str, Any]] = None) -> Snapshot:
        """Commit a new version of exactly one of ``pytree`` (a state) or
        ``file_path`` (a verbatim copy of the file). The rename is the
        commit; everything before it happens in a temp dir no reader
        sees."""
        if (pytree is None) == (file_path is None):
            raise ValueError("publish takes exactly one of pytree= or "
                             "file_path=")
        parent = self.latest_version()
        manifest = {
            "format": "avenir-lifecycle-v1",
            "created_at": time.time(),
            "kind": kind,
            "train_rows": int(train_rows),
            "parent_version": parent,
            "extra": dict(extra or {}),
        }
        tmp = tempfile.mkdtemp(prefix=f".tmp-{os.getpid()}-",
                               dir=self.directory)
        try:
            if pytree is not None:
                manifest["schema_hash"] = state_schema_hash(pytree)
                leaves = tree_flatten(pytree)[0]
                manifest["n_leaves"] = len(leaves)
                np.savez(os.path.join(tmp, _PAYLOAD),
                         **{f"leaf_{i:03d}": leaf
                            for i, leaf in enumerate(leaves)})
            else:
                shutil.copyfile(file_path, os.path.join(tmp, _ARTIFACT))
                manifest["source_file"] = os.path.abspath(file_path)
            version = parent or 0
            while True:
                version += 1
                manifest["version"] = version
                with open(os.path.join(tmp, _MANIFEST), "w") as fh:
                    json.dump(manifest, fh, sort_keys=True)
                try:
                    os.replace(tmp, self._vdir(version))
                    break
                except OSError:
                    # a concurrent publisher took this version: the next
                    if not os.path.isdir(self._vdir(version)):
                        raise
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._commit_latest(version)
        self._gc()
        return self.get(version)

    def _commit_latest(self, version: int) -> None:
        """The pointer through a temp file and ``os.replace``: the old
        head or the new one, never a truncated file."""
        path = os.path.join(self.directory, _LATEST)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump({"version": version}, fh)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _tmp_is_orphan(self, name: str, path: str) -> bool:
        """A temp dir is swept only when its publisher is gone: the pid it
        names is dead on this host, or it has outlived any publish (a
        publisher on another host ages out). Sweeping every ``.tmp-*``
        would delete a concurrent publisher's snapshot mid-assembly."""
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            return False                # swept already
        if age > _TMP_STALE_S:
            return True
        m = _TMP_RE.match(name)
        if m:
            try:
                os.kill(int(m.group(1)), 0)
            except ProcessLookupError:
                return True             # its publisher died on this host
            except OSError:
                pass                    # alive, not ours
        return False

    def _gc(self) -> None:
        """Prune past ``max_to_keep`` (the head always stays) and sweep the
        temp dirs of dead publishers. Best effort: a failed delete is
        retried at the next publish."""
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                path = os.path.join(self.directory, name)
                if self._tmp_is_orphan(name, path):
                    shutil.rmtree(path, ignore_errors=True)
        if not self.max_to_keep:
            return
        versions = self._scan_versions()
        for v in versions[:-max(int(self.max_to_keep), 1)]:
            shutil.rmtree(self._vdir(v), ignore_errors=True)

    def prune(self, max_to_keep: int) -> List[int]:
        """Keep the ``max_to_keep`` newest versions; returns the versions
        removed."""
        versions = self._scan_versions()
        doomed = versions[:-max(int(max_to_keep), 1)]
        for v in doomed:
            shutil.rmtree(self._vdir(v), ignore_errors=True)
        return doomed


class RegistryWatcher:
    """A polling subscription: each committed head is returned once, on
    the subscriber's own cadence, over any shared filesystem."""

    def __init__(self, registry: SnapshotRegistry, last_seen: int):
        self.registry = registry
        self.last_seen = int(last_seen)

    def poll(self) -> Optional[Snapshot]:
        """The head if it moved past ``last_seen``, else None. Versions
        published between two polls are skipped: a subscriber converges
        on the newest, it does not replay history."""
        head = self.registry.latest_version()
        if head is None or head <= self.last_seen:
            return None
        snap = self.registry.get(head)
        self.last_seen = head
        return snap
