"""CSV file → ``EncodedTable`` through the native C++ encoder, with the
bad-row policy.

Counterpart of ``avenir_tpu/native/loader.py``. The column specs come from
a fitted :class:`Featurizer` (vocabularies, bin offsets, class values);
``avt_encode_parallel2`` parses the file's bytes on a pool of threads over
line-aligned byte ranges (one thread under 1 MiB) into numpy buffers, and
the featurizer wraps them as the same table its Python path builds, bit
for bit. The thread count changes how the buffer is split, never the
output.

The C++ path needs a delimiter of one byte; for any other
``encode_file`` raises :class:`NativeUnavailable` and ``transform_file``
takes the Python path. A failed build of the encoder raises
(``native.BuildError``): nothing falls back quietly.

Bad rows: every path takes ``on_bad_row="raise"|"skip"|"quarantine"``.
A ragged row, a non-numeric value in a numeric column, an unseen
categorical or class value is classified the same way by the C++ and the
Python parser: the first bad field in ordinal order, with a ragged row
reporting the first needed ordinal past its end, at its 1-based physical
line (CRLF and blank lines counted).

- ``raise`` (default): the first bad row raises :class:`ParseError`,
  ``"{path}, line {n}: {detail}"`` whichever path parsed it.
- ``skip``: bad rows are counted (``ParseStats.rows_quarantined``) and
  dropped; the surviving rows encode as if the bad lines were absent.
- ``quarantine``: as ``skip``, and the bad rows are written to a JSONL
  sidecar, ``<dirname(path)>/quarantine/<name>.bad.jsonl`` unless
  ``quarantine_dir`` says otherwise, rename-atomically.

``max_bad_fraction`` is a circuit breaker: a file with more bad rows than
that share of its rows fails fast.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import threading
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

import numpy as np

from avenir_tpu_torch import native
from avenir_tpu_torch.utils.atomicio import atomic_write_text
from avenir_tpu_torch.utils.dataset import EncodedTable, Featurizer
from avenir_tpu_torch.utils.device import DeviceLike

_KIND_IGNORE, _KIND_ID, _KIND_CLASS = -1, 0, 1
_KIND_CATEGORICAL, _KIND_BUCKETED, _KIND_CONTINUOUS = 2, 3, 4

# bad-row reason codes: those of native/avt_io.cpp's BadReason
_REASON_RAGGED, _REASON_NUMERIC = 1, 2
_REASON_CATEGORICAL, _REASON_CLASS = 3, 4
_REASON_NAMES = {_REASON_RAGGED: "ragged",
                 _REASON_NUMERIC: "non-numeric",
                 _REASON_CATEGORICAL: "unseen-categorical",
                 _REASON_CLASS: "unseen-class"}

# quarantined rows per input file, written by assignment, so a duplicate
# parse of one file (a speculative attempt) cannot inflate the sum
_QUARANTINE_LOCK = threading.Lock()
_QUARANTINE_BY_FILE: dict = {}

# the breaker's mid-stream checks stay quiet below this many rows seen
# (the end-of-file check is exact at any size)
_BREAKER_MIN_ROWS = 100


class NativeUnavailable(RuntimeError):
    """The C++ path cannot take this request by design; use the Python
    path."""


@dataclass(frozen=True)
class BadRow:
    """One malformed input row, classified the same way by both parsers."""

    line: int        # 1-based physical line number in the source file
    ordinal: int     # offending CSV ordinal (the needed one, for ragged)
    token: str       # offending field text ("" for ragged rows)
    reason: str      # "ragged" | "non-numeric" | "unseen-categorical" | ...
    detail: str      # human-readable detail

    def message(self, path: str) -> str:
        """The one message shape both paths emit."""
        return f"{path}, line {self.line}: {self.detail}"


class ParseError(ValueError):
    """A raise-mode parse failure, carrying its :class:`BadRow`."""

    def __init__(self, path: str, bad_row: BadRow):
        super().__init__(bad_row.message(path))
        self.path = path
        self.bad_row = bad_row


@dataclass
class ParseStats:
    """Bad-row accounting of one logical encode (``parse_stats=``). The
    prefetching loader shares one across shards and their worker threads,
    so every change goes through the lock.

    ``rows``, ``rows_quarantined`` and ``bad_rows`` count parses: a
    speculative duplicate of a shard counts again (both sides of the
    breaker's fraction grow together). ``per_file`` is written by
    assignment and so is exact per input file whatever raced; sharded jobs
    report its sum."""

    rows: int = 0                 # surviving (encoded) rows
    rows_quarantined: int = 0     # rows dropped (skip and quarantine)
    bad_rows: List[BadRow] = dc_field(default_factory=list)
    quarantine_paths: List[str] = dc_field(default_factory=list)
    per_file: dict = dc_field(default_factory=dict)
    _lock: threading.Lock = dc_field(default_factory=threading.Lock,
                                     repr=False, compare=False)


def _make_bad(line: int, code: int, ordinal: int, token: str,
              n_fields: int) -> BadRow:
    if code == _REASON_RAGGED:
        detail = f"row has {n_fields} fields, needs ordinal {ordinal}"
        token = ""
    elif code == _REASON_NUMERIC:
        detail = f"non-numeric value {token!r} at ordinal {ordinal}"
    elif code == _REASON_CATEGORICAL:
        detail = f"unseen categorical value {token!r} at ordinal {ordinal}"
    else:
        detail = f"unseen class value {token!r} at ordinal {ordinal}"
    return BadRow(line=line, ordinal=ordinal, token=token,
                  reason=_REASON_NAMES[code], detail=detail)


class _BadRowPolicy:
    """The bad-row policy and accounting of one file: both parse paths
    send every malformed row through :meth:`record`."""

    def __init__(self, path: str, mode: str, max_bad_fraction: float,
                 quarantine_dir: Optional[str], stats: ParseStats):
        if mode not in ("raise", "skip", "quarantine"):
            raise ValueError(
                f"on_bad_row must be 'raise', 'skip' or 'quarantine', "
                f"got {mode!r}")
        if not (0.0 < max_bad_fraction <= 1.0):
            raise ValueError(
                f"max_bad_fraction must be in (0, 1], got {max_bad_fraction}")
        self.path = path
        self.mode = mode
        self.max_bad_fraction = max_bad_fraction
        self.quarantine_dir = quarantine_dir
        self.stats = stats
        self._bad_here: List[BadRow] = []   # this file's rows (sidecar)

    @property
    def skip(self) -> bool:
        return self.mode != "raise"

    def record(self, bad_rows: List[BadRow]) -> None:
        if not bad_rows:
            return
        if self.mode == "raise":
            raise ParseError(self.path, bad_rows[0])
        with self.stats._lock:
            self.stats.bad_rows.extend(bad_rows)
            self.stats.rows_quarantined += len(bad_rows)
        self._bad_here.extend(bad_rows)

    def note_rows(self, n: int) -> None:
        with self.stats._lock:
            self.stats.rows += n

    def check_fraction(self, final: bool = False) -> None:
        """The circuit breaker: fail once the bad share of the rows seen so
        far exceeds the bound. Checks mid-stream (a buffer, a window, a
        chunk) arm only past a small sample, so one early bad row cannot
        trip a breaker the whole file clears; the ``final`` check at the
        end of the file is exact."""
        bad = self.stats.rows_quarantined
        total = self.stats.rows + bad
        if not final and total < _BREAKER_MIN_ROWS:
            return
        if total and bad > self.max_bad_fraction * total:
            first = self.stats.bad_rows[0]
            raise ParseError(self.path, BadRow(
                line=first.line, ordinal=first.ordinal, token=first.token,
                reason="max-bad-fraction",
                detail=(f"{bad}/{total} rows malformed exceeds "
                        f"max_bad_fraction={self.max_bad_fraction} "
                        f"(first: {first.detail})")))

    def finalize(self, final_check: bool = True) -> None:
        """Once per source file, after its parse: the exact end-of-file
        breaker check (skipped with ``final_check=False``, for a window
        stream abandoned early), the per-file count and the quarantine
        sidecar."""
        if final_check:
            self.check_fraction(final=True)
        if self.skip:
            with self.stats._lock:
                self.stats.per_file[self.path] = len(self._bad_here)
        if self.mode == "quarantine" and self._bad_here:
            qdir = self.quarantine_dir or os.path.join(
                os.path.dirname(self.path) or ".", "quarantine")
            os.makedirs(qdir, exist_ok=True)
            qpath = os.path.join(
                qdir, os.path.basename(self.path) + ".bad.jsonl")

            def emit(fh):
                for b in self._bad_here:
                    fh.write(json.dumps(
                        {"file": self.path, "line": b.line,
                         "ordinal": b.ordinal, "reason": b.reason,
                         "token": b.token, "message": b.message(self.path)},
                        sort_keys=True) + "\n")
            atomic_write_text(qpath, emit)
            with self.stats._lock:
                if qpath not in self.stats.quarantine_paths:
                    self.stats.quarantine_paths.append(qpath)
        if self._bad_here:
            _publish_quarantine_gauge(self.path, len(self._bad_here))


def _publish_quarantine_gauge(path: str, n_bad: int) -> None:
    """The process-wide ``loader.rows_quarantined`` hub gauge: per-file
    counts by assignment (a file parsed twice counts once), summed. It
    never raises (``set_hub_gauges_if_live``)."""
    from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
    with _QUARANTINE_LOCK:
        _QUARANTINE_BY_FILE[path] = n_bad
        total = sum(_QUARANTINE_BY_FILE.values())
    set_hub_gauges_if_live({"loader.rows_quarantined": float(total)})


def _policy(path: str, on_bad_row: str, max_bad_fraction: float,
            quarantine_dir: Optional[str],
            parse_stats: Optional[ParseStats]) -> _BadRowPolicy:
    return _BadRowPolicy(path, on_bad_row, max_bad_fraction, quarantine_dir,
                         parse_stats if parse_stats is not None
                         else ParseStats())


def _count_lines(chunk: bytes) -> int:
    """Physical lines a byte chunk spans (``\\n``, a lone ``\\r`` and
    ``\\r\\n`` each end one line)."""
    return (chunk.count(b"\n") + chunk.count(b"\r") - chunk.count(b"\r\n"))


def _decode_bad(buf: bytes, bad_arr: np.ndarray, delim: str,
                line_base: int) -> List[BadRow]:
    """The C++ bad records (row, line-start offset, reason, ordinal) as
    :class:`BadRow` with 1-based physical line numbers and the offending
    tokens. The offsets ascend and sit at line starts, so one incremental
    pass over the buffer counts the lines."""
    out: List[BadRow] = []
    pos = 0
    lines_seen = 0
    for row, off, code, ordinal in bad_arr:
        off, code, ordinal = int(off), int(code), int(ordinal)
        lines_seen += _count_lines(buf[pos:off])
        pos = off
        end = off
        while end < len(buf) and buf[end] not in (0x0A, 0x0D):
            end += 1
        tokens = [t.strip()
                  for t in buf[off:end].decode(errors="replace").split(delim)]
        token = (tokens[ordinal] if 0 <= ordinal < len(tokens) else "")
        out.append(_make_bad(line_base + lines_seen + 1, code, ordinal,
                             token, len(tokens)))
    return out


def _single_char_delim(delim_regex: str) -> Optional[str]:
    """The literal one-byte delimiter a regex denotes, or None (the C++
    splitter compares one byte; a multi-byte character takes the Python
    path)."""
    if (len(delim_regex) == 1 and delim_regex not in r".^$*+?{}[]\|()"
            and len(delim_regex.encode()) == 1):
        return delim_regex
    if delim_regex == r"\t":
        return "\t"
    return None


def _native_lib_and_delim(fz: Featurizer, delim_regex: str):
    delim = _single_char_delim(delim_regex)
    if delim is None:
        raise NativeUnavailable(
            f"native loader needs a single-char delimiter, got "
            f"{delim_regex!r}")
    if not fz.fitted:
        raise RuntimeError("call fit() first")
    return native.load(), delim


def _build_specs(fz: Featurizer, with_labels: bool):
    """The column-spec arrays of ``avt_encode_parallel2``, built once per
    featurizer and reused across byte windows."""
    id_field = fz.schema.find_id_field()
    try:
        class_field = fz.schema.find_class_attr_field()
    except ValueError:
        class_field = None
    use_labels = with_labels and class_field is not None

    specs = {}   # ordinal -> (kind, feat_slot, bucket_width, bin_offset, vocab)
    if id_field is not None:
        specs[id_field.ordinal] = (_KIND_ID, -1, 0.0, 0, [])
    if use_labels:
        specs[class_field.ordinal] = (
            _KIND_CLASS, -1, 0.0, 0, list(fz.class_values))
    for slot, enc in enumerate(fz.encoders):
        f = enc.field
        if f.is_categorical:
            vocab = [""] * len(enc.vocab)
            for tok, idx in enc.vocab.items():
                vocab[idx] = tok
            specs[f.ordinal] = (_KIND_CATEGORICAL, slot, 0.0, 0, vocab)
        elif enc.continuous:
            specs[f.ordinal] = (_KIND_CONTINUOUS, slot, 0.0, 0, [])
        else:
            specs[f.ordinal] = (_KIND_BUCKETED, slot,
                                float(f.bucket_width), enc.bin_offset, [])
    n_ord = max(specs) + 1

    kinds = np.full(n_ord, _KIND_IGNORE, np.int8)
    feat_slot = np.full(n_ord, -1, np.int32)
    bucket_width = np.zeros(n_ord, np.float64)
    bin_offset = np.zeros(n_ord, np.int64)
    vocab_counts = np.zeros(n_ord, np.int32)
    blob_parts = []
    for ordinal, (kind, slot, bw, off, vocab) in sorted(specs.items()):
        kinds[ordinal] = kind
        feat_slot[ordinal] = slot
        bucket_width[ordinal] = bw
        bin_offset[ordinal] = off
        vocab_counts[ordinal] = len(vocab)
        for tok in vocab:
            blob_parts.append(tok.encode() + b"\0")
    vocab_blob = b"".join(blob_parts)
    return (id_field is not None, use_labels, n_ord, kinds, feat_slot,
            bucket_width, bin_offset, vocab_blob, vocab_counts)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _encode_buffer(lib, fz: Featurizer, buf: bytes, delim: str, specs,
                   n_threads: int, want_ids: bool = True,
                   policy: Optional[_BadRowPolicy] = None,
                   line_base: int = 0):
    """One ``avt_encode_parallel2`` pass over ``buf`` → host numpy arrays
    (binned, numeric, labels or None, ids or None). ``want_ids=False``
    skips decoding the id strings.

    With a skip-mode ``policy`` the bad rows are recorded through it and
    dropped from the arrays; in raise mode the earliest bad row raises
    :class:`ParseError` with its physical line number."""
    (has_id, use_labels, n_ord, kinds, feat_slot, bucket_width,
     bin_offset, vocab_blob, vocab_counts) = specs
    n_feat = len(fz.encoders)
    oov = 1 if fz.unseen == "oov" else 0
    skip_bad = 1 if (policy is not None and policy.skip) else 0
    handle = lib.avt_encode_parallel2(
        buf, len(buf), delim.encode(), n_ord,
        _ptr(kinds, ctypes.c_int8), _ptr(feat_slot, ctypes.c_int32),
        _ptr(bucket_width, ctypes.c_double), _ptr(bin_offset, ctypes.c_int64),
        vocab_blob, _ptr(vocab_counts, ctypes.c_int32),
        oov, n_feat, n_threads, skip_bad)
    try:
        n_rows = lib.avt_rows(handle)
        n_bad = int(lib.avt_bad_count(handle))
        bad_arr = np.zeros((n_bad, 4), np.int64)
        if n_bad:
            lib.avt_bad_fill(handle, _ptr(bad_arr, ctypes.c_int64))
        if n_rows < 0:
            # raise mode: the earliest bad record makes the error, in the
            # Python path's shape; the C message is the last resort
            if n_bad and policy is not None:
                earliest = bad_arr[np.argsort(bad_arr[:, 0])][:1]
                bad = _decode_bad(buf, earliest, delim, line_base)[0]
                raise ParseError(policy.path, bad)
            raise ValueError(
                "native loader: " + lib.avt_error_msg(handle).decode())
        binned = np.zeros((n_rows, n_feat), np.int32)
        numeric = np.zeros((n_rows, n_feat), np.float32)
        labels = np.zeros((n_rows,), np.int32) if use_labels else None
        id_spans = np.zeros((n_rows, 2), np.int64)
        lib.avt_fill(handle, _ptr(binned, ctypes.c_int32),
                     _ptr(numeric, ctypes.c_float),
                     (_ptr(labels, ctypes.c_int32)
                      if labels is not None else None),
                     _ptr(id_spans, ctypes.c_int64))
    finally:
        lib.avt_free(handle)
    if n_bad:
        # bad rows kept their output slots: drop them, so the arrays equal
        # a parse of the file without those lines
        keep = np.ones(n_rows, bool)
        keep[bad_arr[:, 0]] = False
        binned, numeric = binned[keep], numeric[keep]
        labels = labels[keep] if labels is not None else None
        id_spans = id_spans[keep]
        policy.record(_decode_bad(buf, bad_arr, delim, line_base))
    if policy is not None:
        policy.note_rows(binned.shape[0])
        policy.check_fraction()
    if has_id and want_ids:
        # a list of Python ints slices twice as fast as numpy rows
        ids = [buf[a:b].decode() for a, b in id_spans.tolist()]
    else:
        ids = None
    return binned, numeric, labels, ids


def _wrap_table(fz: Featurizer, binned, numeric, labels, ids,
                device: Optional[DeviceLike]) -> EncodedTable:
    """The arrays as a table on ``device``. Without an id field the rows
    are numbered from 0 in each table (each shard of a part dir counts
    again, as the JAX package does)."""
    if ids is None:
        ids = [str(i) for i in range(binned.shape[0])]
    return fz.table_from_arrays(binned, numeric, labels, ids, device=device)


# ---------------------------------------------------------------------------
# the Python row scan: the same classification, the same messages
# ---------------------------------------------------------------------------

def _python_row_specs(fz: Featurizer, with_labels: bool):
    """The needed columns in ordinal order, as ``_build_specs`` has them:
    the Python scan visits the fields in the order the C++ parser does, so
    both report the same first bad field."""
    id_field = fz.schema.find_id_field()
    try:
        class_field = fz.schema.find_class_attr_field()
    except ValueError:
        class_field = None
    use_labels = with_labels and class_field is not None
    specs = []
    if id_field is not None:
        specs.append((id_field.ordinal, "id", None))
    if use_labels:
        specs.append((class_field.ordinal, "class", None))
    for enc in fz.encoders:
        kind = "categorical" if enc.field.is_categorical else "numeric"
        specs.append((enc.field.ordinal, kind, enc))
    specs.sort(key=lambda s: s[0])
    return specs, set(fz.class_values)


def _check_row(specs, class_values, row) -> Optional[tuple]:
    """Classify one tokenized row: None when it encodes, else
    (reason code, ordinal, token, field count), with the C++ parser's
    first-failure rule (fields in ordinal order; a ragged row reports the
    first needed ordinal past its end)."""
    for ordinal, kind, enc in specs:
        if ordinal >= len(row):
            return (_REASON_RAGGED, ordinal, "", len(row))
        tok = row[ordinal]
        if kind == "class":
            if tok not in class_values:
                return (_REASON_CLASS, ordinal, tok, len(row))
        elif kind == "categorical":
            if enc.oov_index is None and tok not in enc.vocab:
                return (_REASON_CATEGORICAL, ordinal, tok, len(row))
        elif kind == "numeric":
            try:
                float(tok)
            except ValueError:
                return (_REASON_NUMERIC, ordinal, tok, len(row))
    return None


def _python_encode_file(fz: Featurizer, path: str, delim_regex: str,
                        with_labels: bool, policy: _BadRowPolicy,
                        chunk_rows: int = 65536):
    """The streaming Python encode, with the bad-row semantics and
    physical line numbers of ``_encode_buffer``. Its peak memory is the
    output arrays and one chunk of ``chunk_rows`` token lists."""
    if not fz.fitted:
        raise RuntimeError("call fit() first")
    specs, class_values = _python_row_specs(fz, with_labels)
    splitter = re.compile(delim_regex)
    bs, vs, ls, ids = [], [], [], []
    pending: list = []
    total = 0

    def flush():
        nonlocal total
        b, v, l, i = fz.transform_arrays(pending, with_labels=with_labels,
                                         row_offset=total)
        bs.append(b)
        vs.append(v)
        if l is not None:
            ls.append(l)
        ids.extend(i)
        total += len(pending)
        pending.clear()

    with open(path, "r") as fh:       # universal newlines, as read_csv_lines
        for lineno, raw in enumerate(fh, 1):
            line = raw.rstrip("\n")
            if not line:
                continue
            row = [t.strip() for t in splitter.split(line)]
            verdict = _check_row(specs, class_values, row)
            if verdict is not None:
                code, ordinal, tok, n_fields = verdict
                policy.record([_make_bad(lineno, code, ordinal, tok,
                                         n_fields)])
                # the breaker checks at chunk boundaries, as the C++ path
                # checks once a buffer (a 3-bad-of-5-rows head with a clean
                # tail behaves the same on both), and every chunk_rows bad
                # rows, so an all-bad file still dies early
                if policy.stats.rows_quarantined % max(chunk_rows, 1) == 0:
                    policy.check_fraction()
                continue
            policy.note_rows(1)
            pending.append(row)
            if len(pending) >= max(chunk_rows, 1):
                flush()
    flush()                           # the tail (and the empty shape)
    labels = np.concatenate(ls) if ls else None
    return np.concatenate(bs), np.concatenate(vs), labels, ids


# ---------------------------------------------------------------------------
# the public encode paths
# ---------------------------------------------------------------------------

def encode_file(fz: Featurizer, path: str, delim_regex: str = ",",
                with_labels: bool = True, n_threads: int = 0,
                on_bad_row: str = "raise", max_bad_fraction: float = 0.1,
                quarantine_dir: Optional[str] = None,
                parse_stats: Optional[ParseStats] = None,
                device: Optional[DeviceLike] = None) -> EncodedTable:
    """One C++ pass over the whole file (``n_threads=0`` sizes the pool
    from the host), as a table on ``device`` (default: the
    featurizer's)."""
    lib, delim = _native_lib_and_delim(fz, delim_regex)
    specs = _build_specs(fz, with_labels)
    policy = _policy(path, on_bad_row, max_bad_fraction, quarantine_dir,
                     parse_stats)
    with open(path, "rb") as fh:
        buf = fh.read()
    binned, numeric, labels, ids = _encode_buffer(
        lib, fz, buf, delim, specs, n_threads, policy=policy)
    policy.finalize()
    return _wrap_table(fz, binned, numeric, labels, ids, device)


def iter_encoded_windows(fz: Featurizer, path: str, delim_regex: str = ",",
                         with_labels: bool = True, n_threads: int = 0,
                         window_bytes: int = 32 << 20,
                         want_ids: bool = True, specs=None,
                         on_bad_row: str = "raise",
                         max_bad_fraction: float = 0.1,
                         quarantine_dir: Optional[str] = None,
                         parse_stats: Optional[ParseStats] = None):
    """Yield ``(binned, numeric, labels|None, ids|None)`` numpy tuples,
    one per line-aligned byte window of the file, so that a consumer that
    folds each window and drops it holds one window at a time. A row
    belongs to the window its first byte falls in. The encoders come from
    the featurizer, so the windows cannot change the encoding. ``specs``
    passes in specs already built by ``_build_specs``.

    The bad-row policy applies per window (the windows come compacted);
    the breaker reads the counts so far, so a corrupt file fails in its
    first window."""
    lib, delim = _native_lib_and_delim(fz, delim_regex)
    if specs is None:
        specs = _build_specs(fz, with_labels)
    policy = _policy(path, on_bad_row, max_bad_fraction, quarantine_dir,
                     parse_stats)
    remaining = os.path.getsize(path)
    carry = b""
    lines_before = 0
    completed = False
    try:
        with open(path, "rb") as fh:
            while remaining > 0:
                # read what is left, at most one window: read(n) allocates
                # n bytes up front
                chunk = fh.read(min(window_bytes, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
                buf = carry + chunk
                cut = buf.rfind(b"\n")
                if cut < 0:
                    carry = buf
                    continue
                window, carry = buf[:cut + 1], buf[cut + 1:]
                yield _encode_buffer(lib, fz, window, delim, specs,
                                     n_threads, want_ids=want_ids,
                                     policy=policy, line_base=lines_before)
                lines_before += _count_lines(window)
        if carry.strip():
            yield _encode_buffer(lib, fz, carry, delim, specs, n_threads,
                                 want_ids=want_ids, policy=policy,
                                 line_base=lines_before)
        completed = True
    finally:
        # a consumer that stops early still gets the sidecar and the
        # per-file count; only the end-of-file breaker check needs the
        # whole parse
        policy.finalize(final_check=completed)


def encode_file_windowed(fz: Featurizer, path: str, delim_regex: str = ",",
                         with_labels: bool = True, n_threads: int = 0,
                         window_bytes: int = 32 << 20,
                         on_bad_row: str = "raise",
                         max_bad_fraction: float = 0.1,
                         quarantine_dir: Optional[str] = None,
                         parse_stats: Optional[ParseStats] = None,
                         device: Optional[DeviceLike] = None
                         ) -> EncodedTable:
    """The C++ encode in line-aligned byte windows: the peak holds the
    output arrays and one window of the file, not the whole file. The
    table is the one :func:`encode_file` gives."""
    # check the delimiter before the spec assembly: the generator below
    # would raise NativeUnavailable only at its first step
    _native_lib_and_delim(fz, delim_regex)
    specs = _build_specs(fz, with_labels)
    use_labels = specs[1]
    parts = list(iter_encoded_windows(
        fz, path, delim_regex, with_labels, n_threads, window_bytes,
        specs=specs, on_bad_row=on_bad_row,
        max_bad_fraction=max_bad_fraction, quarantine_dir=quarantine_dir,
        parse_stats=parse_stats))
    if not parts:
        return _wrap_table(
            fz, np.zeros((0, len(fz.encoders)), np.int32),
            np.zeros((0, len(fz.encoders)), np.float32),
            np.zeros((0,), np.int32) if use_labels else None, None, device)
    binned = np.concatenate([p[0] for p in parts])
    numeric = np.concatenate([p[1] for p in parts])
    labels = (np.concatenate([p[2] for p in parts])
              if parts[0][2] is not None else None)
    ids = (None if parts[0][3] is None
           else [i for p in parts for i in p[3]])
    return _wrap_table(fz, binned, numeric, labels, ids, device)


def transform_file(fz: Featurizer, path: str, delim_regex: str = ",",
                   with_labels: bool = True,
                   force_python: bool = False,
                   n_threads: int = 0,
                   on_bad_row: str = "raise",
                   max_bad_fraction: float = 0.1,
                   quarantine_dir: Optional[str] = None,
                   parse_stats: Optional[ParseStats] = None,
                   device: Optional[DeviceLike] = None) -> EncodedTable:
    """Featurize a CSV file: the C++ pass where the delimiter allows it,
    else (or with ``force_python``) the streaming Python path, with the
    same table, bad-row records, accounting and messages."""
    if not force_python:
        try:
            return encode_file(fz, path, delim_regex, with_labels, n_threads,
                               on_bad_row=on_bad_row,
                               max_bad_fraction=max_bad_fraction,
                               quarantine_dir=quarantine_dir,
                               parse_stats=parse_stats, device=device)
        except NativeUnavailable:
            pass
    policy = _policy(path, on_bad_row, max_bad_fraction, quarantine_dir,
                     parse_stats)
    binned, numeric, labels, ids = _python_encode_file(
        fz, path, delim_regex, with_labels, policy)
    policy.finalize()
    return fz.table_from_arrays(binned, numeric, labels, ids, device=device)


def transform_file_streamed(fz: Featurizer, path: str,
                            delim_regex: str = ",",
                            with_labels: bool = True,
                            chunk_rows: int = 65536,
                            force_python: bool = False,
                            window_bytes: int = 32 << 20,
                            on_bad_row: str = "raise",
                            max_bad_fraction: float = 0.1,
                            quarantine_dir: Optional[str] = None,
                            parse_stats: Optional[ParseStats] = None,
                            device: Optional[DeviceLike] = None
                            ) -> EncodedTable:
    """Featurize a file larger than the host's memory: the C++ parser in
    ``window_bytes`` windows (:func:`encode_file_windowed`), else the
    Python path in ``chunk_rows`` chunks; the table equals
    :func:`transform_file`'s."""
    if not force_python:
        try:
            return encode_file_windowed(
                fz, path, delim_regex, with_labels,
                window_bytes=window_bytes, on_bad_row=on_bad_row,
                max_bad_fraction=max_bad_fraction,
                quarantine_dir=quarantine_dir, parse_stats=parse_stats,
                device=device)
        except NativeUnavailable:
            pass
    policy = _policy(path, on_bad_row, max_bad_fraction, quarantine_dir,
                     parse_stats)
    binned, numeric, labels, ids = _python_encode_file(
        fz, path, delim_regex, with_labels, policy, chunk_rows=chunk_rows)
    policy.finalize()
    return fz.table_from_arrays(binned, numeric, labels, ids, device=device)
