"""The port's parallel split ingest (``parallel/ingest.py``), the
``read_line_window`` split rule and the threaded ``DeviceFeed`` against
the JAX package's and against the serial encoder."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as G
from avenir_tpu.native import loader as jloader
from avenir_tpu.parallel import ingest as JING
from avenir_tpu.utils.config import JobConfig as JConf
from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
from avenir_tpu.utils.dataset import read_line_window as j_window
from avenir_tpu.utils.schema import FeatureSchema as JSchema

from avenir_tpu_torch.native import loader
from avenir_tpu_torch.parallel import ingest as ING
from avenir_tpu_torch.parallel.pipeline import DeviceFeed
from avenir_tpu_torch.utils.config import JobConfig
from avenir_tpu_torch.utils.dataset import (Featurizer, read_csv_lines,
                                            read_line_window)
from avenir_tpu_torch.utils.schema import FeatureSchema

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_stats():
    ING.take_last_stats()
    JING.take_last_stats()
    yield
    ING.take_last_stats()
    JING.take_last_stats()


def _write(tmp_path, rows, name="train.csv", newline="\n"):
    path = tmp_path / name
    path.write_bytes((newline.join(",".join(r) for r in rows)
                      + newline).encode())
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps(G._CHURN_SCHEMA_JSON))
    return str(path)


def _conf(tmp_path, **over):
    props = {"field.delim.regex": ",",
             "feature.schema.file.path": str(tmp_path / "schema.json"),
             "ingest.workers": "3", "ingest.split.bytes": "2048", **over}
    return JobConfig(props), JConf(props)


def _fitted(tmp_path):
    schema = str(tmp_path / "schema.json")
    return (Featurizer(FeatureSchema.from_file(schema),
                       device="cpu").fit([]),
            JFeaturizer(JSchema.from_file(schema)).fit([]))


def _tables_equal(a, b):
    for name in ("binned", "numeric", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
    assert a.ids == b.ids


# -- split planning ----------------------------------------------------------

@pytest.mark.parametrize("newline", ["\n", "\r\n"])
@pytest.mark.parametrize("split", [1, 7, 100, 1024, 100_000])
def test_windows_tile_the_file_as_jax(tmp_path, newline, split):
    path = _write(tmp_path, G.churn_rows(120, seed=3), newline=newline)
    size = os.path.getsize(path)
    got, want = [], []
    for lo in range(0, size, split):
        got.append(read_line_window(path, lo, lo + split))
        want.append(j_window(path, lo, lo + split))
    assert got == want
    assert b"".join(got) == open(path, "rb").read()
    splits = ING.plan_splits([path, path], split)
    assert [(s.index, s.start, s.stop, s.last_in_file) for s in splits] == \
        [(s.index, s.start, s.stop, s.last_in_file)
         for s in JING.plan_splits([path, path], split)]


@pytest.mark.parametrize("over,reason", [
    ({"ingest.parallel": "false"}, "ingest.parallel=false"),
    ({"ingest.workers": "1"}, "one worker (ingest.workers)"),
    ({"ingest.split.bytes": "10000000"}, "input fits one split"),
    ({}, "")])
def test_ingest_plans_equal_jax(tmp_path, over, reason):
    path = _write(tmp_path, G.churn_rows(200, seed=4))
    tconf, jconf = _conf(tmp_path, **over)
    got, want = ING.plan_ingest(tconf, path), JING.plan_ingest(jconf, path)
    assert (got.parallel, got.reason) == (want.parallel, want.reason)
    assert got.reason == reason
    assert got.describe() == want.describe()
    assert ING.fit_is_schema_only(G.churn_schema()) == \
        JING.fit_is_schema_only(G.churn_schema())


# -- the table ----------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("with_labels", [True, False])
def test_parallel_table_equals_the_serial_one(tmp_path, native,
                                              with_labels):
    """Bit for bit: the native pool and the Python row scan against the
    serial encoder and the JAX package's parallel table."""
    path = _write(tmp_path, G.churn_rows(400, seed=6))
    tconf, jconf = _conf(tmp_path, **{"ingest.native": str(native).lower(),
                                      "ingest.chunk.rows": "50"})
    tfz, jfz = _fitted(tmp_path)
    iplan = ING.plan_ingest(tconf, path)
    assert iplan.parallel and len(iplan.splits) >= 4
    par = ING.run_ingest(tfz, iplan, tconf, with_labels=with_labels)
    st = ING.take_last_stats()["train"]
    assert st["rows"] == 400 and st["feed"]["chunks"] >= 8
    _tables_equal(par, tfz.transform(read_csv_lines(path, ","),
                                     with_labels=with_labels))
    _tables_equal(par, JING.run_ingest(
        jfz, JING.plan_ingest(jconf, path), jconf, with_labels=with_labels))


def test_workers_out_of_order_are_resequenced(tmp_path, monkeypatch):
    path = _write(tmp_path, G.churn_rows(300, seed=7))
    tconf, _ = _conf(tmp_path, **{"ingest.workers": "4",
                                  "ingest.split.bytes": "1024"})
    iplan = ING.plan_ingest(tconf, path)
    assert len(iplan.splits) >= 4
    completion = []
    orig = ING._Encoder.encode_split

    def staggered(self, split):
        # later splits finish first
        time.sleep(0.03 * max(0, len(iplan.splits) - split.index))
        out = orig(self, split)
        completion.append(split.index)
        return out

    monkeypatch.setattr(ING._Encoder, "encode_split", staggered)
    tfz, _ = _fitted(tmp_path)
    par = ING.run_ingest(tfz, iplan, tconf)
    st = ING.take_last_stats()["train"]
    assert completion != sorted(completion)
    assert st["consume_order"] == sorted(st["consume_order"])
    _tables_equal(par, tfz.transform(read_csv_lines(path, ",")))


def _poisoned(tmp_path):
    rows = G.churn_rows(200, seed=5)
    rows[20][1] = "NOPE"                     # unseen categorical
    rows[90] = rows[90][:4]                  # ragged
    rows[170][6] = "weird"                   # bad class label
    return _write(tmp_path, rows, "poison.csv")


@pytest.mark.parametrize("native", [True, False])
def test_skip_mode_rebases_bad_rows(tmp_path, native):
    path = _poisoned(tmp_path)
    tconf, jconf = _conf(tmp_path, **{"on.bad.row": "skip",
                                      "ingest.native": str(native).lower()})
    tfz, jfz = _fitted(tmp_path)
    serial_stats = loader.ParseStats()
    serial = loader.transform_file(tfz, path, ",", force_python=not native,
                                   on_bad_row="skip",
                                   parse_stats=serial_stats)
    par = ING.run_ingest(tfz, ING.plan_ingest(tconf, path), tconf)
    st = ING.take_last_stats()["train"]
    _tables_equal(serial, par)
    assert st["rows_quarantined"] == serial_stats.rows_quarantined == 3
    _tables_equal(par, JING.run_ingest(jfz, JING.plan_ingest(jconf, path),
                                       jconf))


def test_quarantine_sidecar_has_global_lines(tmp_path):
    path = _poisoned(tmp_path)
    qp, qj = tmp_path / "q_port", tmp_path / "q_jax"
    tconf, _ = _conf(tmp_path, **{"on.bad.row": "quarantine",
                                  "quarantine.dir": str(qp)})
    _, jconf = _conf(tmp_path, **{"on.bad.row": "quarantine",
                                  "quarantine.dir": str(qj)})
    tfz, jfz = _fitted(tmp_path)
    ING.run_ingest(tfz, ING.plan_ingest(tconf, path), tconf)
    JING.run_ingest(jfz, JING.plan_ingest(jconf, path), jconf)
    name = "poison.csv.bad.jsonl"
    assert (qp / name).read_text() == (qj / name).read_text()
    assert [json.loads(line)["line"] for line in
            (qp / name).read_text().splitlines()] == [21, 91, 171]


def test_raise_mode_raises_on_the_first_bad_row(tmp_path):
    path = _poisoned(tmp_path)
    tconf, jconf = _conf(tmp_path)
    tfz, jfz = _fitted(tmp_path)
    with pytest.raises(loader.ParseError) as serial:
        loader.transform_file(tfz, path, ",", on_bad_row="raise")
    with pytest.raises(loader.ParseError) as par:
        ING.run_ingest(tfz, ING.plan_ingest(tconf, path), tconf)
    with pytest.raises(jloader.ParseError) as jax_par:
        JING.run_ingest(jfz, JING.plan_ingest(jconf, path), jconf)
    assert str(par.value) == str(serial.value) == str(jax_par.value)
    assert par.value.bad_row.line == 21


def test_split_journal_resumes_only_the_missing_split(tmp_path):
    path = _write(tmp_path, G.churn_rows(300, seed=8))
    tconf, _ = _conf(tmp_path, **{"ingest.journal": "true",
                                  "shard.journal.keep": "true"})
    tfz, _ = _fitted(tmp_path)
    iplan = ING.plan_ingest(tconf, path)
    n = len(iplan.splits)
    jd = str(tmp_path / "out.txt.ingest-train")
    full = ING.run_ingest(tfz, iplan, tconf, table_fp="fp", journal_dir=jd)
    st = ING.take_last_stats()["train"]
    assert (st["encoded_splits"], st["resumed_splits"]) == (n, 0)
    for ext in ("npz", "json"):       # the kill: one split's commit lost
        os.remove(os.path.join(jd, f"shard-00001.{ext}"))
    ING.run_ingest(tfz, iplan, tconf, table_fp="fp", journal_dir=jd)
    st = ING.take_last_stats()["train"]
    assert (st["encoded_splits"], st["resumed_splits"]) == (n, 0)
    os.remove(os.path.join(jd, "shard-00001.npz"))
    os.remove(os.path.join(jd, "shard-00001.json"))
    tconf.set("job.resume", "true")
    resumed = ING.run_ingest(tfz, iplan, tconf, table_fp="fp",
                             journal_dir=jd)
    st = ING.take_last_stats()["train"]
    assert (st["encoded_splits"], st["resumed_splits"]) == (1, n - 1)
    _tables_equal(full, resumed)


# -- the DeviceFeed -------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_device_feed_keeps_order_depth_and_stats(depth, chunk):
    a = np.arange(300, dtype=np.float32).reshape(100, 3)
    b = torch.arange(100, dtype=torch.int32)
    in_flight, peak = [0], [0]
    lock = threading.Lock()

    def chunks():
        for lo in range(0, 100, chunk):
            with lock:
                in_flight[0] += 1
                peak[0] = max(peak[0], in_flight[0])
            yield a[lo:lo + chunk], None, b[lo:lo + chunk]

    feed = DeviceFeed(chunks(), depth=depth, device="cpu")
    got = []
    for fc in feed:
        with lock:
            in_flight[0] -= 1
        assert fc.arrays[1] is None and fc.arrays[0].shape[0] == fc.n_rows
        got.append(fc)
    assert [fc.index for fc in got] == list(range(len(got)))
    assert np.array_equal(torch.cat([fc.arrays[0] for fc in got]).numpy(), a)
    assert torch.equal(torch.cat([fc.arrays[2] for fc in got]), b)
    assert peak[0] <= depth + 1
    st = feed.stats()
    assert st.chunks == len(got) == -(-100 // chunk)
    assert 0.0 <= st.overlap_fraction <= 1.0
    assert {fc.n_rows for fc in got} <= {chunk, 100 % chunk or chunk}
    with pytest.raises(RuntimeError, match="single-pass"):
        next(iter(feed))


def test_device_feed_reraises_a_staging_error():
    def chunks():
        yield (np.zeros((4, 2), np.float32),)
        yield (None,)                       # no arrays: the stage raises
        yield (np.zeros((4, 2), np.float32),)

    feed = DeviceFeed(chunks(), depth=2, device="cpu")
    it = iter(feed)
    assert next(it).n_rows == 4
    with pytest.raises(ValueError, match="feed chunk 1 has no arrays"):
        next(it)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        DeviceFeed([], depth=0, device="cpu")


def test_device_feed_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        DeviceFeed([], depth=1)
