"""Resumable sharded batch jobs: the per-shard completion journal.

Counterpart of ``avenir_tpu/utils/resume.py``, with its layout. A killed
Hadoop job re-runs only the splits whose attempts never committed; here
each shard's output fragment (or partial-count payload), then its
completion record, land rename-atomically in a journal directory beside
the job's output, so a kill leaves a record whole or missing, and a
missing one recomputes that shard. ``--resume`` skips the shards with a
record; the output is put together from the fragments in shard order, so
a resumed run writes the bytes an uninterrupted one does.

A fingerprint of the job refuses a resume into a journal that another job
(another config, another shard list) wrote.

Layout (``<out_path>.shards/``)::

    _job.json           {"key": <fingerprint>, "n_shards": N}
    shard-00007.json    completion record (counters, cm partial, run nonce)
    shard-00007.out     output fragment (KNN classification lines)
    shard-00007.npz     partial-count payload (sharded NB/MI training)
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import time
from typing import Dict, Iterable, Optional

import numpy as np

from avenir_tpu_torch.utils.atomicio import (atomic_write_data,
                                             atomic_write_text)

_JOB_FILE = "_job.json"


def job_fingerprint(parts: dict) -> str:
    """A stable digest of what must match for a resume to be sound: the
    verb, the shard list (name and size) and the job's config without the
    resume switches (the caller drops those)."""
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def shard_file_facts(paths: Iterable[str]) -> list:
    """(basename, size) of each shard, for the fingerprint: a shard whose
    size changed since the journal was written refuses the resume."""
    return [[os.path.basename(p), os.path.getsize(p)] for p in paths]


def run_nonce() -> str:
    """Names one run of the CLI in the shard records: a resumed run
    leaves the records of earlier runs, nonce and all, as they were."""
    return f"{os.getpid()}-{time.time_ns():x}"


class ShardJournal:
    """The rename-atomic per-shard completion journal (module
    docstring)."""

    def __init__(self, journal_dir: str, job_key: str, n_shards: int):
        self.dir = journal_dir
        self.key = job_key
        self.n_shards = n_shards

    # -- lifecycle ----------------------------------------------------------
    def open(self, resume: bool) -> Dict[int, dict]:
        """Prepare the journal and return the completed shards' records
        (index -> record). Without ``resume`` an existing journal is
        cleared, so an earlier unrelated run never leaks fragments into a
        fresh job; with ``resume`` a fingerprint that differs refuses."""
        if os.path.isdir(self.dir) and not resume:
            shutil.rmtree(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        job_path = os.path.join(self.dir, _JOB_FILE)
        if resume and os.path.exists(job_path):
            try:
                with open(job_path) as fh:
                    job = json.load(fh)
            except (OSError, json.JSONDecodeError) as exc:
                raise ValueError(
                    f"shard journal {self.dir} has a corrupt {_JOB_FILE} "
                    f"({exc}); delete the journal or rerun without "
                    f"--resume") from exc
            if job.get("key") != self.key:
                raise ValueError(
                    f"shard journal {self.dir} was written by a different "
                    f"job (input shards or config changed); delete it or "
                    f"rerun without --resume")
        else:
            atomic_write_data(job_path, json.dumps(
                {"key": self.key, "n_shards": self.n_shards},
                sort_keys=True))
        return self._completed()

    def _completed(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in os.listdir(self.dir):
            if not (name.startswith("shard-") and name.endswith(".json")):
                continue
            full = os.path.join(self.dir, name)
            try:
                with open(full) as fh:
                    rec = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue   # records are atomic: anything odd is absent
            idx = rec.get("shard")
            if not isinstance(idx, int) or not (0 <= idx < self.n_shards):
                continue
            # a record without its fragment or payload (a hand-pruned
            # journal; no kill can leave one) is not done
            if rec.get("fragment") and not os.path.exists(
                    self.fragment_path(idx)):
                continue
            if rec.get("payload") and not os.path.exists(
                    self.payload_path(idx)):
                continue
            out[idx] = rec
        return out

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    # -- per-shard artifacts ------------------------------------------------
    def fragment_path(self, index: int) -> str:
        return os.path.join(self.dir, f"shard-{index:05d}.out")

    def payload_path(self, index: int) -> str:
        return os.path.join(self.dir, f"shard-{index:05d}.npz")

    def write_fragment(self, index: int, text: str) -> None:
        atomic_write_data(self.fragment_path(index), text)

    def write_payload(self, index: int, arrays: Dict[str, np.ndarray]
                      ) -> None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        atomic_write_data(self.payload_path(index), buf.getvalue())

    def read_payload(self, index: int) -> dict:
        with np.load(self.payload_path(index)) as z:
            return {k: z[k] for k in z.files}

    def mark_done(self, index: int, record: dict) -> None:
        """Commit a shard: its record lands atomically, after the fragment
        or payload the caller wrote, so a kill between the two leaves a
        shard to recompute, never a record that points at nothing."""
        record = dict(record)
        record["shard"] = index
        atomic_write_data(os.path.join(self.dir, f"shard-{index:05d}.json"),
                          json.dumps(record, sort_keys=True))

    # -- output assembly ----------------------------------------------------
    def assemble(self, out_path: str, n_shards: Optional[int] = None) -> None:
        """Concatenate the fragments in shard order into ``out_path``,
        atomically: the bytes a direct write of the same shards gives."""
        n = self.n_shards if n_shards is None else n_shards

        def emit(out):
            for i in range(n):
                with open(self.fragment_path(i), "rb") as frag:
                    shutil.copyfileobj(frag, out)

        atomic_write_text(out_path, emit, mode="wb")
