"""Parallel cold-path ingest: a split encode pool, re-sequenced, staged
through the ``DeviceFeed``.

Counterpart of ``avenir_tpu/parallel/ingest.py``. The reference's batch
tier parsed each HDFS split in its own mapper; this is that contract in
one process:

1. **Split planning** (:func:`plan_splits`): the input part files, and
   byte ranges of large single files, cut into ~``ingest.split.bytes``
   splits. A split owns the lines whose first byte falls inside it
   (``utils.dataset.read_line_window``), so splits tile a file's lines
   exactly wherever the cuts fall.
2. **Encode pool**: ``ingest.workers`` threads read and encode splits at
   once, on the host, through the port's native encoder, whose ctypes
   calls release the GIL. Where the delimiter is not one byte (or with
   ``ingest.native=false``) a split goes through the Python row scan of
   ``native/loader.py``, with the same rows and the same bad-row records.
   An encoder that cannot be built raises: nothing falls back.
3. **Re-sequencing and staging**: workers may finish in any order; the
   calling thread takes their results strictly in split order (a window of
   ``workers + ingest.queue.depth`` splits in flight), applies the
   ``on.bad.row`` policy, commits each split to the ``ShardJournal``
   when ``ingest.journal`` is set, and streams fixed-size chunks through
   a :class:`DeviceFeed` (``ingest.queue.depth`` deep); the table is
   assembled on the device from the staged chunks.

The table equals the serial encoder's bit for bit, so its staged-table
fingerprint is the serial one's. Bad rows carry split-relative line
numbers from the workers; the caller rebases them to file-global lines
with the cumulative line counts of the splits before, so raise mode
raises on the file's first bad row and skip and quarantine keep the
serial rows, sidecars and breaker.

Telemetry: workers record ``ingest.decode`` and ``ingest.encode`` spans
a split, the feed ``feed.h2d`` a chunk, and the end of a run publishes
the ``ingest.overlap_fraction`` gauge (the share of worker encode time
hidden behind the caller's staging and assembly).
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.parallel.pipeline import DeviceFeed
from avenir_tpu_torch.utils.dataset import part_file_paths, read_line_window
from avenir_tpu_torch.utils.device import DeviceLike

# the line terminators of the text-mode readers (universal newlines): the
# Python row scan splits a window exactly as read_csv_lines does
_LINE_SPLIT = re.compile("\r\n|\r|\n")


# ---------------------------------------------------------------------------
# split planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """One unit of encode work: a byte window of one file."""

    index: int          # the global submission and consumption order
    path: str
    start: int
    stop: int
    last_in_file: bool  # the caller finalizes the file's policy here


def plan_splits(paths: List[str], split_bytes: int) -> List[Split]:
    """``paths`` (in part-file order) cut into byte windows of about
    ``split_bytes``; which split owns a straddling line is settled when it
    is read (``read_line_window``)."""
    splits: List[Split] = []
    index = 0
    for path in paths:
        size = os.path.getsize(path)
        if size == 0:
            continue
        n = max(1, -(-size // split_bytes))
        for k in range(n):
            splits.append(Split(
                index=index, path=path, start=k * split_bytes,
                stop=min((k + 1) * split_bytes, size),
                last_in_file=(k == n - 1)))
            index += 1
    return splits


def fit_is_schema_only(schema) -> bool:
    """True when ``Featurizer.fit`` is fixed by the schema alone: every
    categorical (and the class field) lists its cardinality and every
    numeric carries min and max, so ``fit([])`` builds the encoders
    ``fit(rows)`` would. Stricter than ``Featurizer.schema_data_dependent``,
    which lets a continuous numeric fit its range from the data."""
    for f in schema.get_feature_fields():
        if f.is_categorical:
            if f.cardinality is None:
                return False
        elif f.is_numeric:
            if f.min is None or f.max is None:
                return False
        else:
            return False
    try:
        class_field = schema.find_class_attr_field()
    except ValueError:
        class_field = None
    if class_field is not None and class_field.cardinality is None:
        return False
    return True


@dataclass
class IngestPlan:
    """The decision made when the plan is built: parallel, with its
    splits, or serial, with the reason (``--explain`` shows it)."""

    parallel: bool
    reason: str
    workers: int = 0
    split_bytes: int = 0
    queue_depth: int = 2
    chunk_rows: int = 65536
    splits: List[Split] = dc_field(default_factory=list)

    @classmethod
    def serial(cls, reason: str) -> "IngestPlan":
        return cls(parallel=False, reason=reason)

    def describe(self) -> Dict[str, Any]:
        """The encode node's ``ingest`` property."""
        return {"workers": self.workers,
                "splits": len(self.splits),
                "split_bytes": self.split_bytes,
                "files": len({s.path for s in self.splits}),
                "queue_depth": self.queue_depth}


def plan_ingest(conf, in_path: str, *, with_labels: bool = True,
                require_schema_only_fit: bool = True) -> IngestPlan:
    """Whether this table encodes in parallel. Serial, with the reason:
    ``ingest.parallel=false``, one worker, an input within one split, or,
    where the encode fits the featurizer, a schema whose vocabularies or
    ranges come from the data (the fit must see every row). The KNN test
    table encodes through the train-fitted featurizer and passes
    ``require_schema_only_fit=False``."""
    del with_labels   # eligible either way
    if not conf.get_bool("ingest.parallel", True):
        return IngestPlan.serial("ingest.parallel=false")
    workers = conf.get_int("ingest.workers", 0)
    if workers <= 0:
        workers = os.cpu_count() or 1
    if workers < 2:
        return IngestPlan.serial("one worker (ingest.workers)")
    split_bytes = max(conf.get_int("ingest.split.bytes", 32 << 20), 1)
    splits = plan_splits(part_file_paths(in_path), split_bytes)
    if len(splits) < 2:
        return IngestPlan.serial("input fits one split")
    if require_schema_only_fit:
        from avenir_tpu_torch.utils.schema import FeatureSchema
        schema = FeatureSchema.from_file(
            conf.get_required("feature.schema.file.path"))
        if not fit_is_schema_only(schema):
            return IngestPlan.serial("data-dependent featurizer fit")
    return IngestPlan(
        parallel=True, reason="",
        workers=min(workers, len(splits)),
        split_bytes=split_bytes,
        queue_depth=max(conf.get_int("ingest.queue.depth", 2), 1),
        chunk_rows=max(conf.get_int("ingest.chunk.rows", 65536), 1),
        splits=splits)


# ---------------------------------------------------------------------------
# worker side: one split -> host arrays + split-relative bad rows
# ---------------------------------------------------------------------------

@dataclass
class EncodedChunk:
    """One split's encode result. ``bads`` carry split-relative 1-based
    line numbers; the caller rebases them."""

    split: Split
    binned: np.ndarray
    numeric: np.ndarray
    labels: Optional[np.ndarray]
    ids: Optional[List[str]]
    n_lines: int               # physical lines the split's window spans
    bads: List[Any]            # loader.BadRow, split-relative lines
    decode_ms: float = 0.0
    encode_ms: float = 0.0
    resumed: bool = False


class _Encoder:
    """The encode context the worker threads share: the native encoder's
    specs (built once), or the Python row specs and splitter."""

    def __init__(self, fz, conf, with_labels: bool):
        from avenir_tpu_torch.native import loader
        self.fz = fz
        self.with_labels = with_labels
        self.delim_regex = conf.get("field.delim.regex", ",")
        self.has_id = fz.schema.find_id_field() is not None
        try:
            class_field = fz.schema.find_class_attr_field()
        except ValueError:
            class_field = None
        self.use_labels = with_labels and class_field is not None
        self.native = False
        if conf.get_bool("ingest.native", True):
            try:
                # a build failure raises here; only a delimiter of more
                # than one byte selects the Python scan
                self.lib, self.delim = loader._native_lib_and_delim(
                    fz, self.delim_regex)
                self.specs = loader._build_specs(fz, with_labels)
                self.native = True
            except loader.NativeUnavailable:
                pass
        if not self.native:
            self.pyspecs, self.pyclass = loader._python_row_specs(
                fz, with_labels)
            self.splitter = re.compile(self.delim_regex)

    def encode_split(self, split: Split) -> EncodedChunk:
        """Worker entry: read the split's lines, encode them, and record
        malformed rows without raising; the caller applies ``on.bad.row``
        in split order, so errors come out the same whatever order the
        workers finish in."""
        from avenir_tpu_torch.native import loader
        tracer = telemetry.tracer()
        t0 = time.perf_counter()
        buf = read_line_window(split.path, split.start, split.stop)
        t1 = time.perf_counter()
        n_lines = loader._count_lines(buf)
        if self.native:
            # a private skip policy records (and drops) bad rows; line
            # numbers stay split-relative (line_base=0)
            policy = loader._BadRowPolicy(
                split.path, "skip", 1.0, None, loader.ParseStats())
            binned, numeric, labels, ids = loader._encode_buffer(
                self.lib, self.fz, buf, self.delim, self.specs,
                n_threads=1, want_ids=True, policy=policy, line_base=0)
            bads = list(policy.stats.bad_rows)
        else:
            binned, numeric, labels, ids, bads = self._encode_python(buf)
        t2 = time.perf_counter()
        decode_ms = (t1 - t0) * 1e3
        encode_ms = (t2 - t1) * 1e3
        if tracer.enabled:
            tracer.record("ingest.decode", decode_ms)
            tracer.record("ingest.encode", encode_ms)
        return EncodedChunk(
            split=split, binned=binned, numeric=numeric, labels=labels,
            ids=ids if self.has_id else None, n_lines=n_lines, bads=bads,
            decode_ms=decode_ms, encode_ms=encode_ms)

    def _encode_python(self, buf: bytes):
        """The Python row scan over one window: the tokenization, blank
        lines and first-failure classification of the serial scan."""
        from avenir_tpu_torch.native import loader
        rows: List[List[str]] = []
        bads: List[Any] = []
        for lineno, line in enumerate(_LINE_SPLIT.split(buf.decode()), 1):
            if not line:
                continue
            row = [t.strip() for t in self.splitter.split(line)]
            verdict = loader._check_row(self.pyspecs, self.pyclass, row)
            if verdict is not None:
                code, ordinal, tok, n_fields = verdict
                bads.append(loader._make_bad(lineno, code, ordinal, tok,
                                             n_fields))
                continue
            rows.append(row)
        binned, numeric, labels, ids = self.fz.transform_arrays(
            rows, with_labels=self.with_labels, row_offset=0)
        return binned, numeric, labels, ids, bads


# ---------------------------------------------------------------------------
# caller side: ordered consumption, policy, journal, staging, assembly
# ---------------------------------------------------------------------------

# the latest run's stats per tag ("train"/"test"); the scheduler attaches
# them to last_run()
_LAST_STATS: Dict[str, Dict[str, Any]] = {}


def take_last_stats() -> Dict[str, Dict[str, Any]]:
    """Pop the stats of every ingest run since the last take."""
    global _LAST_STATS
    out, _LAST_STATS = _LAST_STATS, {}
    return out


def _journal_for(iplan: IngestPlan, conf, table_fp: Optional[str],
                 journal_dir: Optional[str]):
    """(journal, completed records) when ``ingest.journal`` is set."""
    if journal_dir is None or not conf.get_bool("ingest.journal", False):
        return None, {}
    from avenir_tpu_torch.plan import fingerprint as FP
    from avenir_tpu_torch.utils.resume import ShardJournal
    key = FP.digest({
        "v": 1, "node": "ingest-journal", "table": table_fp,
        "split_bytes": iplan.split_bytes,
        "splits": [[os.path.basename(s.path), s.start, s.stop]
                   for s in iplan.splits]})
    journal = ShardJournal(journal_dir, key, len(iplan.splits))
    completed = journal.open(resume=conf.get_bool("job.resume", False))
    return journal, completed


def _load_payload(journal, split: Split, record: dict,
                  use_labels: bool, has_id: bool) -> EncodedChunk:
    """A journaled split read back: the resume path's encode."""
    from avenir_tpu_torch.native import loader
    arrays = journal.read_payload(split.index)
    bads = [loader.BadRow(**b) for b in record.get("bad", [])]
    labels = arrays.get("labels") if use_labels else None
    ids = ([str(t) for t in arrays["ids"]]
           if has_id and "ids" in arrays else None)
    return EncodedChunk(
        split=split, binned=arrays["binned"], numeric=arrays["numeric"],
        labels=labels, ids=ids, n_lines=int(record["n_lines"]),
        bads=bads, resumed=True)


def run_ingest(fz, iplan: IngestPlan, conf, *, with_labels: bool = True,
               table_fp: Optional[str] = None,
               journal_dir: Optional[str] = None, tag: str = "train",
               device: Optional[DeviceLike] = None):
    """Encode ``iplan``'s splits in parallel and return the assembled
    ``EncodedTable`` on ``device`` (default: the featurizer's), equal bit
    for bit to ``fz.transform(read_csv_lines(...))``. ``fz`` is fitted
    already: from the schema alone for train tables (the check in
    :func:`plan_ingest`), on the train table for KNN's test table."""
    from avenir_tpu_torch.native import loader
    if not iplan.parallel:
        raise ValueError("run_ingest called with a serial IngestPlan "
                         f"({iplan.reason})")
    dev = fz.device if device is None else torch.device(device)
    enc = _Encoder(fz, conf, with_labels)
    journal, completed = _journal_for(iplan, conf, table_fp, journal_dir)

    on_bad = conf.get("on.bad.row", "raise")
    max_bad = conf.get_float("max.bad.fraction", 0.1)
    qdir = conf.get("quarantine.dir")
    shared_stats = loader.ParseStats()
    policies: Dict[str, Any] = {}

    stats = {"tag": tag, "parallel": True,
             "workers": iplan.workers, "splits": len(iplan.splits),
             "resumed_splits": 0, "encoded_splits": 0, "rows": 0,
             "rows_quarantined": 0, "decode_ms": 0.0, "encode_ms": 0.0,
             "wait_ms": 0.0, "overlap_fraction": 0.0}
    ids_all: List[str] = []
    lines_before: Dict[str, int] = {}
    consume_order: List[int] = []

    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=iplan.workers, thread_name_prefix="avenir-ingest")

    def submit(split: Split):
        if split.index in completed:
            return pool.submit(_load_payload, journal, split,
                               completed[split.index], enc.use_labels,
                               enc.has_id)
        return pool.submit(enc.encode_split, split)

    def ordered_chunks() -> Iterator[Tuple[np.ndarray, ...]]:
        """The re-sequencer: submit in split order with a bounded window
        in flight, take results strictly in split order, apply the
        bad-row policy and the journal, and yield fixed-size chunks."""
        pending: deque = deque()
        it = iter(iplan.splits)
        window = iplan.workers + iplan.queue_depth

        def top_up():
            while len(pending) < window:
                s = next(it, None)
                if s is None:
                    return
                pending.append((s, submit(s)))

        top_up()
        while pending:
            split, fut = pending.popleft()
            t0 = time.perf_counter()
            chunk: EncodedChunk = fut.result()
            stats["wait_ms"] += (time.perf_counter() - t0) * 1e3
            top_up()

            # the bad-row policy, in split order
            base = lines_before.setdefault(split.path, 0)
            policy = policies.get(split.path)
            if policy is None:
                policy = policies[split.path] = loader._BadRowPolicy(
                    split.path, on_bad, max_bad, qdir, shared_stats)
            if chunk.bads:
                policy.record([loader.BadRow(
                    line=base + b.line, ordinal=b.ordinal, token=b.token,
                    reason=b.reason, detail=b.detail)
                    for b in chunk.bads])   # raise mode raises here
            n = chunk.binned.shape[0]
            policy.note_rows(n)
            policy.check_fraction()
            lines_before[split.path] = base + chunk.n_lines
            if split.last_in_file:
                policy.finalize()

            # the journal: payload first, record after
            if journal is not None and not chunk.resumed:
                payload = {"binned": chunk.binned, "numeric": chunk.numeric}
                if chunk.labels is not None:
                    payload["labels"] = chunk.labels
                if chunk.ids is not None:
                    payload["ids"] = np.asarray(chunk.ids)
                journal.write_payload(split.index, payload)
                journal.mark_done(split.index, {
                    "rows": int(n), "n_lines": int(chunk.n_lines),
                    "bad": [{"line": b.line, "ordinal": b.ordinal,
                             "token": b.token, "reason": b.reason,
                             "detail": b.detail} for b in chunk.bads]})

            stats["resumed_splits" if chunk.resumed
                  else "encoded_splits"] += 1
            stats["decode_ms"] += chunk.decode_ms
            stats["encode_ms"] += chunk.encode_ms
            stats["rows"] += int(n)
            consume_order.append(split.index)
            if chunk.ids is not None:
                ids_all.extend(chunk.ids)
            for lo in range(0, n, iplan.chunk_rows):
                hi = min(lo + iplan.chunk_rows, n)
                yield (chunk.binned[lo:hi], chunk.numeric[lo:hi],
                       chunk.labels[lo:hi] if chunk.labels is not None
                       else None)

    try:
        feed = DeviceFeed(ordered_chunks(), depth=iplan.queue_depth,
                          device=dev, span_prefix="feed")
        dev_b, dev_v, dev_l = [], [], []
        for fc in feed:
            b, v, lab = fc.arrays
            dev_b.append(b)
            dev_v.append(v)
            if lab is not None:
                dev_l.append(lab)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    if journal is not None and not conf.get_bool("shard.journal.keep",
                                                 False):
        journal.cleanup()

    worker_ms = stats["decode_ms"] + stats["encode_ms"]
    stats["overlap_fraction"] = (
        min(max(1.0 - stats["wait_ms"] / worker_ms, 0.0), 1.0)
        if worker_ms > 0 else 1.0)
    stats["consume_order"] = consume_order
    fs = feed.stats()
    stats["feed"] = {"chunks": fs.chunks, "h2d_ms": round(fs.h2d_ms, 3),
                     "overlap_fraction": round(fs.overlap_fraction, 4)}
    stats["rows_quarantined"] = shared_stats.rows_quarantined
    _LAST_STATS[tag] = stats
    from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
    set_hub_gauges_if_live(
        {"ingest.overlap_fraction": stats["overlap_fraction"]})

    if not dev_b:
        # every line blank or skipped: the serial encoder's empty table
        return fz.transform([], with_labels=with_labels, device=dev)
    labels = torch.cat(dev_l) if dev_l else None
    return loader._wrap_table(fz, torch.cat(dev_b), torch.cat(dev_v), labels,
                              ids_all if enc.has_id else None, dev)
