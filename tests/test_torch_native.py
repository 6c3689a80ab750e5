"""The port's native CSV loader (``avenir_tpu_torch/native``) against the
JAX package's and against the port's own Python path, on the same seeded
files: tables bit for bit, bad-row records and messages, breaker trips and
quarantine sidecars; and the port's own build of the encoder."""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from avenir_tpu.native import loader as JL
from avenir_tpu_torch import native as TN
from avenir_tpu_torch.native import loader as TL
from avenir_tpu_torch.utils.dataset import Featurizer

from _torch_parity import assert_tables_equal, featurizers, fixture

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _write(tmp_path, lines, name="t.csv", newline="\n"):
    path = tmp_path / name
    with open(path, "w", newline="") as fh:
        fh.write(newline.join(lines) + newline)
    return str(path)


def _lines(rows):
    return [",".join(r) for r in rows]


def _three(jfz, tfz, path, n_threads=2, **kw):
    """(port native, JAX native, port Python) tables of one file."""
    return (TL.encode_file(tfz, path, n_threads=n_threads, **kw),
            JL.encode_file(jfz, path, n_threads=n_threads, **kw),
            TL.transform_file(tfz, path, force_python=True, **kw))


def _assert_three(tables):
    port, jax_, python = tables
    assert_tables_equal(port, jax_)
    assert_tables_equal(port, python)
    return port


# (fixture, rows, body lines -> file, newline, encode kwargs, rows expected)
_CASES = {
    "churn": ("churn", 500, None, "\n", {}, 500),
    "elearn": ("elearn", 300, None, "\n", {}, 300),
    "without-labels": ("churn", 100, None, "\n", {"with_labels": False},
                       100),
    "blank-lines": ("churn", 20, lambda ls: "\n\n".join(ls).split("\n"),
                    "\n", {}, 20),
    "crlf": ("churn", 20, lambda ls: ls[:10] + [""] + ls[10:], "\r\n", {},
             20),
    "crlf-blank-lines-8-threads": (
        "churn", 600, lambda ls: ls[:300] + ["", "", ""] + ls[300:], "\r\n",
        {"n_threads": 8}, 600),
    "more-threads-than-rows": ("churn", 3, None, "\n", {"n_threads": 16},
                               3),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_native_parity(tmp_path, case):
    """Port native = JAX native = port Python, bit for bit, across CRLF
    and blank lines (Python's universal newlines drop a blank CRLF line;
    the C++ byte scanner must too)."""
    name, n, shape, newline, kw, want = _CASES[case]
    schema, rows = fixture(name, n, seed=3)
    lines = _lines(rows)
    path = _write(tmp_path, shape(lines) if shape else lines,
                  newline=newline)
    jfz, tfz = featurizers(schema, rows)
    kw = dict(kw)
    n_threads = kw.pop("n_threads", 2)
    table = _assert_three(_three(jfz, tfz, path, n_threads=n_threads, **kw))
    assert table.n_rows == want
    assert (table.labels is None) == (kw.get("with_labels") is False)


def test_thread_counts_bit_identical(tmp_path):
    """The thread count changes how the buffer is split, never the table:
    1, 3 and 8 threads give the same bits, equal to the JAX encoder's."""
    schema, rows = fixture("churn", 2000, seed=6)
    path = _write(tmp_path, _lines(rows))
    jfz, tfz = featurizers(schema, rows)
    tables = [TL.encode_file(tfz, path, n_threads=t) for t in (1, 3, 8)]
    for t in tables[1:]:
        assert_tables_equal(tables[0], t)
    assert_tables_equal(tables[0], JL.encode_file(jfz, path, n_threads=3))


def _plant(rows, kind, i):
    bad = [list(r) for r in rows]
    if kind == "categorical":
        bad[i][1] = "NEVER_SEEN"
    elif kind == "numeric":
        bad[i][2] = "not_a_number"
    else:
        bad[i] = bad[i][:2]
    return bad


@pytest.mark.parametrize("name,kind,row,n_threads,match", [
    ("churn", "categorical", 10, 2, "unseen categorical"),
    ("elearn", "numeric", 5, 2, "non-numeric"),
    ("churn", "short", 7, 2, "fields"),
    ("churn", "categorical", 700, 4, "line 701")])
def test_raise_messages_equal(tmp_path, name, kind, row, n_threads, match):
    """A bad row raises the same message from the port's C++ path, the
    JAX package's and the port's Python path; with four ranges the
    earliest bad row wins and names its physical line."""
    schema, rows = fixture(name, max(row + 50, 50), seed=2)
    path = _write(tmp_path, _lines(_plant(rows, kind, row)))
    jfz, tfz = featurizers(schema, rows)
    msgs = []
    for call in (lambda: TL.encode_file(tfz, path, n_threads=n_threads),
                 lambda: JL.encode_file(jfz, path, n_threads=n_threads),
                 lambda: TL.transform_file(tfz, path, force_python=True)):
        with pytest.raises(ValueError, match=match) as exc:
            call()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == msgs[2]
    assert msgs[0].startswith(f"{path}, line {row + 1}: ")


def test_unseen_categorical_oov_bin(tmp_path):
    schema, rows = fixture("churn", 50, seed=2)
    bad = _plant(rows, "categorical", 10)
    path = _write(tmp_path, _lines(bad))
    jfz, tfz = featurizers(schema, rows, unseen="oov")
    table = _assert_three(_three(jfz, tfz, path))
    np.testing.assert_array_equal(table.binned.numpy(),
                                  tfz.transform(bad).binned.numpy())


def test_regex_delim_takes_the_python_path(tmp_path):
    """Only a delimiter of more than one byte is NativeUnavailable;
    transform_file then takes the Python path, as the JAX loader does."""
    schema, rows = fixture("churn", 30, seed=4)
    path = _write(tmp_path, _lines(rows))
    jfz, tfz = featurizers(schema, rows)
    with pytest.raises(TL.NativeUnavailable):
        TL.encode_file(tfz, path, delim_regex=",+")
    table = TL.transform_file(tfz, path, delim_regex=",+")
    assert table.n_rows == 30
    assert_tables_equal(table, JL.transform_file(jfz, path,
                                                 delim_regex=",+"))
    with pytest.raises(RuntimeError, match="fit"):
        TL.encode_file(Featurizer(tfz.schema, device="cpu"), path)


def test_featurizer_fuzz_parity(tmp_path):
    """Seeded random ASCII tables (padded tokens, random bucket widths)
    through the three encoders, bit for bit."""
    rnd = random.Random(1234)
    for trial in range(5):
        card = [f"v{i}" for i in range(rnd.randint(2, 6))]
        schema = {"fields": [
            {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
            {"name": "cat", "ordinal": 1, "dataType": "categorical",
             "cardinality": card, "feature": True},
            {"name": "bucketed", "ordinal": 2, "dataType": "int",
             "min": 0, "max": 100, "bucketWidth": rnd.choice([5, 10]),
             "feature": True},
            {"name": "cont", "ordinal": 3, "dataType": "double",
             "feature": True},
            {"name": "label", "ordinal": 4, "dataType": "categorical",
             "classAttribute": True, "cardinality": ["a", "b"]}]}
        lines = []
        for i in range(rnd.randint(20, 80)):
            pad = " " * rnd.randint(0, 2)
            lines.append(",".join([
                f"{pad}R{i}{pad}", pad + rnd.choice(card) + pad,
                str(rnd.randint(0, 100)), f"{rnd.uniform(-5, 5):.4f}",
                rnd.choice(["a", "b"])]))
        path = _write(tmp_path, lines, name=f"fuzz{trial}.csv")
        jfz, tfz = featurizers(schema, [line.split(",") for line in lines])
        _assert_three(_three(jfz, tfz, path))


# -- the bad-row matrix ------------------------------------------------------

def _records(stats):
    return [(b.line, b.ordinal, b.token, b.reason, b.detail)
            for b in stats.bad_rows]


def _four(jfz, tfz, path, **kw):
    """Each of (port native, port Python, JAX native, JAX Python): its
    table, its ParseStats and the bytes of its quarantine sidecar, read
    right after its own run (all four write the same sidecar path)."""
    out = []
    for mod, fz in ((TL, tfz), (JL, jfz)):
        for force_python in (False, True):
            stats = mod.ParseStats()
            table = mod.transform_file(fz, path, force_python=force_python,
                                       n_threads=2, parse_stats=stats, **kw)
            sidecar = (Path(stats.quarantine_paths[-1]).read_bytes()
                       if stats.quarantine_paths else None)
            out.append((table, stats, sidecar))
    for table, stats, sidecar in out[1:]:
        assert_tables_equal(out[0][0], table)
        assert stats.rows_quarantined == out[0][1].rows_quarantined
        assert stats.per_file == out[0][1].per_file
        assert _records(stats) == _records(out[0][1])
        assert sidecar == out[0][2]
    return out[0]


def test_full_matrix_quarantine(tmp_path):
    """Ragged, non-numeric and unseen-class rows among a trailing
    delimiter and a blank line: equal tables, records, physical line
    numbers and sidecar bytes on all four paths."""
    schema, rows = fixture("elearn", 60, seed=5)
    lines = _lines(rows)
    lines[3] = ",".join(rows[3][:2])              # ragged
    lines[10] = lines[10] + ","                   # trailing delimiter: OK
    lines[17] = ",".join(rows[17][:2] + ["not_a_number"] + rows[17][3:])
    lines[29] = ",".join(rows[29][:-1] + ["limbo"])   # unseen class
    lines.insert(20, "")                          # blank line: skipped
    path = _write(tmp_path, lines)
    jfz, tfz = featurizers(schema, rows)
    table, stats, sidecar = _four(jfz, tfz, path, on_bad_row="quarantine")
    assert table.n_rows == 57 and stats.rows_quarantined == 3
    assert [b.reason for b in stats.bad_rows] == [
        "ragged", "non-numeric", "unseen-class"]
    assert [b.line for b in stats.bad_rows] == [4, 18, 31]
    assert sidecar.count(b"\n") == 3 and path.encode() in sidecar


def test_skip_unseen_categorical_and_quarantine_dir(tmp_path):
    schema, rows = fixture("churn", 50, seed=2)
    path = _write(tmp_path, _lines(_plant(rows, "categorical", 10)))
    jfz, tfz = featurizers(schema, rows)
    table, stats, _ = _four(jfz, tfz, path, on_bad_row="skip")
    assert table.n_rows == 49 and stats.bad_rows[0].token == "NEVER_SEEN"
    qdir = str(tmp_path / "q")
    _, stats, sidecar = _four(jfz, tfz, path, on_bad_row="quarantine",
                              quarantine_dir=qdir)
    assert stats.quarantine_paths == [f"{qdir}/t.csv.bad.jsonl"]
    assert b"unseen-categorical" in sidecar


def test_breaker_trips_at_the_same_row(tmp_path):
    """Half the rows bad: every path and package trips max_bad_fraction
    with the same message; a generous bound lets the file through."""
    schema, rows = fixture("churn", 60, seed=4)
    lines = _lines(rows)
    for i in range(0, 60, 2):
        lines[i] = "junk"
    path = _write(tmp_path, lines)
    jfz, tfz = featurizers(schema, rows)
    msgs = []
    for mod, fz in ((TL, tfz), (JL, jfz)):
        for force_python in (False, True):
            with pytest.raises(mod.ParseError,
                               match="max_bad_fraction") as exc:
                mod.transform_file(fz, path, force_python=force_python,
                                   n_threads=2, on_bad_row="skip")
            msgs.append(str(exc.value))
    assert len(set(msgs)) == 1
    assert msgs[0].startswith(f"{path}, line 1: 30/60 rows malformed")
    table, stats, _ = _four(jfz, tfz, path, on_bad_row="skip",
                            max_bad_fraction=0.9)
    assert table.n_rows == 30 and stats.rows_quarantined == 30


def test_bad_head_with_clean_tail_passes_on_both_paths(tmp_path):
    """Three bad rows of a five-row head, then a clean tail: the breaker
    checks once a buffer (C++) or once a chunk (Python), never per row, so
    both paths let the file through alike."""
    schema, rows = fixture("churn", 205, seed=7)
    lines = _lines(rows)
    for i in (0, 2, 4):
        lines[i] = "junk"
    path = _write(tmp_path, lines)
    jfz, tfz = featurizers(schema, rows)
    table, stats, _ = _four(jfz, tfz, path, on_bad_row="skip")
    assert table.n_rows == 202 and stats.rows_quarantined == 3


def test_windowed_trio_equals_encode_file(tmp_path):
    """iter_encoded_windows, encode_file_windowed and
    transform_file_streamed (C++ windows of 997 bytes; Python chunks of 7
    rows) give encode_file's table and bad-row lines, as the JAX
    loader's windowed path does."""
    schema, rows = fixture("churn", 400, seed=9)
    lines = _lines(rows)
    for i in (3, 150, 333):
        lines[i] = ",".join(rows[i][:2])
    path = _write(tmp_path, lines, newline="\r\n")
    jfz, tfz = featurizers(schema, rows)
    kw = dict(on_bad_row="skip", max_bad_fraction=0.5)
    base_stats = TL.ParseStats()
    base = TL.encode_file(tfz, path, n_threads=2, parse_stats=base_stats,
                          **kw)
    stats = [TL.ParseStats() for _ in range(3)]
    windowed = TL.encode_file_windowed(tfz, path, n_threads=2,
                                       window_bytes=997,
                                       parse_stats=stats[0], **kw)
    streamed = TL.transform_file_streamed(tfz, path, window_bytes=997,
                                          parse_stats=stats[1], **kw)
    python = TL.transform_file_streamed(tfz, path, force_python=True,
                                        chunk_rows=7, parse_stats=stats[2],
                                        **kw)
    jax_ = JL.encode_file_windowed(jfz, path, n_threads=2, window_bytes=997,
                                   **kw)
    for table in (windowed, streamed, python, jax_):
        assert_tables_equal(base, table)
    for st in stats:
        assert _records(st) == _records(base_stats)
    assert [b.line for b in base_stats.bad_rows] == [4, 151, 334]
    parts = list(TL.iter_encoded_windows(tfz, path, n_threads=2,
                                         window_bytes=997, **kw))
    assert len(parts) > 10
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  base.binned.numpy())
    assert [i for p in parts for i in p[3]] == base.ids


# -- the port's own build ----------------------------------------------------

def test_port_builds_its_own_library():
    """The library the loader uses lies in the port's package, is named
    by its source's hash, and is not the JAX package's."""
    path = TN.build()
    assert path.parent == REPO / "avenir_tpu_torch" / "native"
    assert re.fullmatch(r"_avt_io-[0-9a-f]{16}\.so", path.name)
    assert TN.load()._name == str(path)
    assert TN.SRC == REPO / "native" / "avt_io.cpp"
    for name, (argtypes, restype) in TN._SIGNATURES.items():
        assert getattr(TN.load(), name).argtypes == argtypes
    assert {"avt_encode_parallel2", "avt_project",
            "avt_project_copy"} <= set(TN._SIGNATURES)
    for src in (REPO / "avenir_tpu_torch").rglob("*.py"):
        assert "_avt_io.so" not in src.read_text()


def test_build_writes_under_its_dir_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "a.cpp"
    src.write_text('extern "C" int avt_one() { return 1; }\n')
    out = tmp_path / "lib"
    out.mkdir()
    monkeypatch.setattr(TN, "SRC", src)
    monkeypatch.setattr(TN, "LIB_DIR", out)
    first = TN.build()
    assert first.parent == out and first.exists()
    assert [p.name for p in out.iterdir()] == [first.name]
    src.write_text(src.read_text() + "// edited\n")
    assert TN.library_path() != first


def test_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    """A compiler error raises BuildError with g++'s stderr, and
    transform_file raises it too: no quiet Python path."""
    src = tmp_path / "broken.cpp"
    src.write_text("int avt_broken( {\n")
    monkeypatch.setattr(TN, "SRC", src)
    monkeypatch.setattr(TN, "LIB_DIR", tmp_path)
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(TN.BuildError, match="g\\+\\+ failed.*broken.cpp"):
        TN.build()
    schema, rows = fixture("churn", 20, seed=1)
    path = _write(tmp_path, _lines(rows))
    tfz = featurizers(schema, rows)[1]
    with pytest.raises(TN.BuildError):
        TL.transform_file(tfz, path)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob(".*"))
