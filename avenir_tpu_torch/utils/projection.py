"""Grouping/ordering projection — the chombo ``org.chombo.mr.Projection``
stage the email-marketing Markov tutorial runs before training
(resource/tutorial_opt_email_marketing.txt:66-76; config block
``projection.operation=groupingOrdering`` at resource/buyhist.properties:6-11).

Counterpart of ``avenir_tpu/utils/projection.py`` (``_parse_number``,
``grouping_ordering``, ``project_file``): the reference job groups rows by
``key.field``, secondary-sorts each group by ``orderBy.field``, and with
``format.compact=true`` emits one line per key: ``key,proj1,proj2,...``
concatenating the ``projection.field`` columns of each record in order.
It is a host-side group-sort, an input-pipeline stage with no kernel: the
native pass is ``avt_project`` of the repo's ``native/avt_io.cpp``,
through the port's own build of it (``avenir_tpu_torch/native``), and a
failed build raises instead of falling back to Python.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence

from avenir_tpu_torch import native
from avenir_tpu_torch.native.loader import _single_char_delim
from avenir_tpu_torch.utils.dataset import read_csv_lines


_NUMBER_CHARS = frozenset("0123456789+-.eE")


def _parse_number(tok: str) -> Optional[float]:
    """Plain decimal floats only — the ONE number grammar both the Python
    and native (strtod-based) paths accept identically: digits, sign,
    point, exponent. Python ``float`` extras (underscore separators, nan,
    inf) and strtod extras (hex floats, NAN(seq)) are all rejected so
    ordering never depends on which path ran, and the sort comparator never
    sees a NaN (which would break strict weak ordering)."""
    if not tok or len(tok) >= 64 or not all(c in _NUMBER_CHARS for c in tok):
        return None
    try:
        return float(tok)
    except ValueError:
        return None


def grouping_ordering(rows: Sequence[Sequence[str]], key_field: int,
                      order_by_field: int,
                      projection_fields: Sequence[int],
                      compact: bool = True,
                      numeric_order: Optional[bool] = None) -> List[List[str]]:
    """Group ``rows`` by ``key_field``, order each group by
    ``order_by_field``, and project ``projection_fields``.

    compact=True: one output row per key — ``[key, p1a, p1b, p2a, p2b, ...]``.
    compact=False: one output row per input row — ``[key, pa, pb, ...]``,
    groups contiguous and ordered.

    ``numeric_order`` selects the order-by comparator (the reference's typed
    comparators): True sorts as float, False lexicographically (correct for
    ISO dates like the tutorial's transaction timestamps). The default
    ``None`` auto-detects — numeric iff every order-by value parses as a
    number — so reference-style properties files (which carry no such key)
    order both date strings and day numbers correctly.
    """
    groups: Dict[str, List[Sequence[str]]] = {}
    order: List[str] = []
    for row in rows:
        key = row[key_field]
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(row)

    if numeric_order is None:
        numeric_order = all(
            _parse_number(r[order_by_field]) is not None for r in rows)

    def sort_key(row: Sequence[str]):
        v = row[order_by_field]
        if not numeric_order:
            return v
        num = _parse_number(v)
        if num is None:
            raise ValueError(f"numeric ordering requested but order-by "
                             f"token {v!r} is not a plain decimal number")
        return num

    out: List[List[str]] = []
    for key in order:
        members = sorted(groups[key], key=sort_key)
        if compact:
            line = [key]
            for row in members:
                line.extend(row[f] for f in projection_fields)
            out.append(line)
        else:
            for row in members:
                out.append([key] + [row[f] for f in projection_fields])
    return out


def project_file(in_path: str, out_path: str, key_field: int,
                 order_by_field: int, projection_fields: Sequence[int],
                 compact: bool = True, numeric_order: Optional[bool] = None,
                 delim_regex: str = ",", delim_out: str = ",",
                 force_python: bool = False) -> None:
    """File-to-file projection: the native C++ pass (``avt_project``) for
    a single file with a one-byte delimiter and no negative field index,
    else ``grouping_ordering`` over ``read_csv_lines`` (a part-file
    directory, a longer delimiter, ``force_python``), with identical
    output.

    When the in/out delimiters are the same single character, BOTH paths
    join output fields with that character (so a ``\\t`` delimiter regex
    produces real tabs on either path). Negative
    field indices always take the Python path (Python-style indexing).

    Known trim divergence (documented): the native path trims ASCII
    whitespace from tokens; the Python path trims Unicode whitespace
    (``str.strip``). Data whose tokens are padded with non-ASCII whitespace
    (e.g. NBSP) groups differently per path."""
    delim = _single_char_delim(delim_regex) if delim_out == delim_regex \
        else None
    if delim is not None:
        delim_out = delim
    has_negative = (key_field < 0 or order_by_field < 0
                    or any(f < 0 for f in projection_fields))
    # the native pass reads one file's raw bytes; directory inputs (MR
    # part-file dirs) take the Python path via read_csv_lines
    if (not force_python and delim is not None and not has_negative
            and os.path.isfile(in_path)):
        lib = native.load()
        with open(in_path, "rb") as fh:
            buf = fh.read()
        proj = (ctypes.c_int32 * len(projection_fields))(*projection_fields)
        mode = -1 if numeric_order is None else int(numeric_order)
        handle = lib.avt_project(buf, len(buf), delim.encode(), key_field,
                                 order_by_field, proj, len(projection_fields),
                                 int(compact), mode)
        try:
            size = lib.avt_project_size(handle)
            if size < 0:
                raise ValueError("native projection: " +
                                 lib.avt_project_error(handle).decode())
            out = ctypes.create_string_buffer(size)
            lib.avt_project_copy(handle, out)
            with open(out_path, "wb") as fh:
                fh.write(out.raw[:size])
        finally:
            lib.avt_project_free(handle)
        return
    rows = grouping_ordering(
        read_csv_lines(in_path, delim_regex), key_field, order_by_field,
        projection_fields, compact, numeric_order)
    with open(out_path, "w") as fh:
        for row in rows:
            fh.write(delim_out.join(row) + "\n")
