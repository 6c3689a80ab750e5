"""The port's prefetching shard reader (``native/prefetch.py``), its shard
journal (``utils/resume.py``) and the NearestNeighbor part-file path of its
CLI, against the JAX package's: retries, deadlines and speculation on
custom stages, the journal's semantics, and the CLI's outputs, stdout and
quarantine sidecars byte for byte under every key the path reads."""

import contextlib
import io
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.native.prefetch import PrefetchLoader as JPrefetchLoader
from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.native.loader import ParseStats
from avenir_tpu_torch.native.prefetch import PrefetchLoader, ShardError
from avenir_tpu_torch.utils import resume as R
from avenir_tpu_torch.utils.dataset import Featurizer

from _torch_parity import (
    assert_tables_equal, featurizers, fixture, write_fixture)

torch.set_num_threads(2)


def _write(tmp_path, lines, name):
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _shards(tmp_path, n=4, rows_per=80):
    """(jax featurizer, torch featurizer, shard paths, all rows) of churn
    rows cut into ``n`` files."""
    schema, rows = fixture("churn", n * rows_per, seed=11)
    jfz, tfz = featurizers(schema, rows)
    paths = [_write(tmp_path, [",".join(r) for r in
                               rows[i * rows_per:(i + 1) * rows_per]],
                    f"part-{i}.csv") for i in range(n)]
    return jfz, tfz, paths, rows


# -- the prefetching loader --------------------------------------------------

def test_prefetch_order_and_parity(tmp_path):
    """Shards come in order, each the port's transform of its rows and
    the JAX loader's table of the same file."""
    schema, rows = fixture("churn", 900, seed=11)
    jfz, tfz = featurizers(schema, rows)
    shards = [rows[i::3] for i in range(3)]
    paths = [_write(tmp_path, [",".join(r) for r in s], f"part-{i}.csv")
             for i, s in enumerate(shards)]
    tables = list(PrefetchLoader(tfz, paths, depth=2, n_threads=2))
    assert len(tables) == 3
    for shard, table, jtable in zip(shards, tables,
                                    JPrefetchLoader(jfz, paths, depth=2)):
        assert table.device.type == "cpu"
        assert_tables_equal(table, tfz.transform(shard))
        assert_tables_equal(table, jtable)


def test_prefetch_requires_fit_and_handles_no_shards(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="fit"):
        PrefetchLoader(Featurizer(tfz.schema, device="cpu"), paths)
    assert list(PrefetchLoader(tfz, [])) == []
    with pytest.raises(ValueError, match="bucket"):
        PrefetchLoader(tfz, paths, bucket=True)
    with pytest.raises(ValueError, match="custom stage"):
        PrefetchLoader(tfz, paths, to_device=True, device="cpu",
                       stage=lambda t: t)


def test_to_device_stage_keeps_real_rows(tmp_path):
    """The to-device stage on the CPU: tables with their real row count
    (``bucket`` pads nothing) equal to the host loader's."""
    jfz, tfz, paths, _ = _shards(tmp_path, n=3, rows_per=70)
    staged = list(PrefetchLoader(tfz, paths, to_device=True, bucket=True,
                                 device="cpu", n_threads=2))
    for table, plain in zip(staged, PrefetchLoader(tfz, paths)):
        assert table.n_rows == table.binned.shape[0] == 70
        assert_tables_equal(table, plain)


def test_to_device_defaults_to_cuda(tmp_path):
    """Without ``device`` the stage goes to the card: with none it
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    jfz, tfz, paths, _ = _shards(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(tfz, paths, to_device=True)


def test_raising_stage_surfaces_with_path(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path)

    def boom(table):
        raise RuntimeError("stage exploded")

    t0 = time.perf_counter()
    with pytest.raises(ShardError) as exc:
        list(PrefetchLoader(tfz, paths, depth=2, stage=boom, retries=1))
    assert time.perf_counter() - t0 < 10
    assert exc.value.path == paths[0] and paths[0] in str(exc.value)
    assert isinstance(exc.value, RuntimeError)
    assert isinstance(exc.value.__cause__, RuntimeError)


def test_flaky_stage_retried_exactly(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path)
    failures = {"left": 2}

    def flaky(table):
        if failures["left"] > 0:
            failures["left"] -= 1
            raise RuntimeError("transient")
        return table

    loader = PrefetchLoader(tfz, paths, depth=1, stage=flaky, retries=2,
                            speculate=False)
    assert len(list(loader)) == len(paths)
    assert loader.stats.shard_retries == 2
    assert loader.stats.shards == len(paths)


def test_zero_retries_fails_on_first_error(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path)

    def boom(table):
        raise ValueError("no second chances")

    with pytest.raises(ShardError, match="after 1 attempt"):
        list(PrefetchLoader(tfz, paths, depth=1, stage=boom, retries=0))


def test_hung_shard_speculative_rescue(tmp_path):
    """A shard whose first attempt hangs gets a duplicate once it runs
    past the bar; the duplicate's table is yielded in order."""
    jfz, tfz, paths, rows = _shards(tmp_path, n=5)
    slow_id = rows[3 * 80][0]
    release = threading.Event()
    calls = []

    def hang_once(table):
        calls.append(table.ids[0])
        if table.ids[0] == slow_id and calls.count(slow_id) == 1:
            release.wait(10)
        return table

    loader = PrefetchLoader(tfz, paths, depth=2, stage=hang_once,
                            speculate=True, speculative_min_samples=2,
                            speculative_min_wait_s=0.2,
                            speculative_factor=4.0)
    try:
        tables = list(loader)
    finally:
        release.set()
    assert loader.stats.speculative_wins >= 1
    assert [t.ids[0] for t in tables] == [rows[i * 80][0] for i in range(5)]


def test_losing_attempt_error_does_not_kill_racing_winner(tmp_path):
    """With the retry budget spent and a duplicate still racing, the
    first attempt's late error means wait, not ShardError."""
    jfz, tfz, paths, rows = _shards(tmp_path, n=5)
    slow_id = rows[3 * 80][0]
    duplicate_ran = threading.Event()
    calls = []

    def slow_then_boom(table):
        calls.append(table.ids[0])
        if table.ids[0] == slow_id:
            if calls.count(slow_id) == 1:
                duplicate_ran.wait(10)
                raise RuntimeError("primary died late")
            duplicate_ran.set()
        return table

    loader = PrefetchLoader(tfz, paths, depth=2, stage=slow_then_boom,
                            retries=0, speculate=True,
                            speculative_min_samples=2,
                            speculative_min_wait_s=0.2,
                            speculative_factor=4.0)
    tables = list(loader)
    assert len(tables) == 5 and tables[3].ids[0] == slow_id
    assert loader.stats.speculative_wins >= 1


def test_deadline_retry(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path, n=2)
    release = threading.Event()
    state = {"n": 0}

    def hang_first(table):
        state["n"] += 1
        if state["n"] == 1:
            release.wait(10)
        return table

    loader = PrefetchLoader(tfz, paths, depth=1, stage=hang_first,
                            retries=1, shard_timeout_s=0.4, speculate=False)
    t0 = time.perf_counter()
    try:
        tables = list(loader)
    finally:
        release.set()
    assert time.perf_counter() - t0 < 10
    assert len(tables) == 2
    assert loader.stats.shard_retries >= 1
    assert loader.stats.speculative_wins == 0


def _poison(path, rows_bad):
    with open(path) as fh:
        lines = fh.read().splitlines()
    for i in rows_bad:
        lines[i] = "garbage"
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def test_quarantine_accounting_across_shards(tmp_path):
    jfz, tfz, paths, _ = _shards(tmp_path, n=3)
    _poison(paths[0], [5])
    _poison(paths[2], [7, 9])
    stats = ParseStats()
    tables = list(PrefetchLoader(tfz, paths, depth=2, on_bad_row="skip",
                                 parse_stats=stats, n_threads=2))
    assert [t.n_rows for t in tables] == [79, 80, 78]
    assert stats.rows_quarantined == 3
    assert stats.per_file == {paths[0]: 1, paths[1]: 0, paths[2]: 2}


def test_shared_parse_stats_under_thread_churn(tmp_path):
    """Twelve shards on six attempt threads and a tiny switch interval,
    with duplicates launched freely: the shared stats stay exact
    (per_file by assignment; rows and quarantined rows grow together)."""
    jfz, tfz, paths, _ = _shards(tmp_path, n=12, rows_per=40)
    for i, path in enumerate(paths):
        _poison(path, range(i % 3 + 1))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = ParseStats()
        loader = PrefetchLoader(tfz, paths, depth=6, on_bad_row="skip",
                                max_bad_fraction=0.5, parse_stats=stats,
                                speculative_min_samples=1,
                                speculative_min_wait_s=0.0,
                                speculative_factor=0.0, n_threads=2)
        t0 = time.perf_counter()
        tables = list(loader)
        assert time.perf_counter() - t0 < 30
    finally:
        sys.setswitchinterval(old)
    assert [t.n_rows for t in tables] == [40 - (i % 3 + 1)
                                          for i in range(12)]
    assert stats.per_file == {p: i % 3 + 1 for i, p in enumerate(paths)}
    parses = stats.rows + stats.rows_quarantined
    assert parses % 40 == 0 and parses >= 480
    assert len(stats.bad_rows) == stats.rows_quarantined


# -- the shard journal -------------------------------------------------------

def _journal(tmp_path, key="k1", n=3):
    return R.ShardJournal(str(tmp_path / "j"), key, n)


def test_fresh_open_clears_stale_journal(tmp_path):
    j = _journal(tmp_path)
    assert j.open(resume=False) == {}
    j.write_fragment(0, "a\n")
    j.mark_done(0, {"rows": 1, "fragment": True, "run": "r1"})
    assert list(j.open(resume=True)) == [0]
    assert j.open(resume=False) == {}
    assert not os.path.exists(j.fragment_path(0))


def test_resume_key_mismatch_refuses(tmp_path):
    _journal(tmp_path, key="k1").open(resume=False)
    with pytest.raises(ValueError, match="different job"):
        _journal(tmp_path, key="k2").open(resume=True)


def test_record_without_fragment_not_done(tmp_path):
    j = _journal(tmp_path)
    j.open(resume=False)
    j.write_fragment(1, "x\n")
    j.mark_done(1, {"rows": 1, "fragment": True, "run": "r"})
    os.remove(j.fragment_path(1))
    assert j.open(resume=True) == {}


def test_assemble_order_and_atomicity(tmp_path):
    j = _journal(tmp_path, n=3)
    j.open(resume=False)
    for i, txt in enumerate(("b\n", "a\n", "c\n")):
        j.write_fragment(i, txt)
    out = str(tmp_path / "out.txt")
    j.assemble(out)
    assert open(out).read() == "b\na\nc\n"
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    assert not [n for n in os.listdir(j.dir) if ".tmp" in n]


def test_payload_and_fingerprint(tmp_path):
    """The .npz payload round-trips; the fingerprint follows the shard
    facts; nonces differ between runs."""
    j = _journal(tmp_path, n=2)
    j.open(resume=False)
    j.write_payload(1, {"counts": np.arange(6).reshape(2, 3)})
    j.mark_done(1, {"payload": True, "run": R.run_nonce()})
    assert list(j.open(resume=True)) == [1]
    np.testing.assert_array_equal(j.read_payload(1)["counts"],
                                  np.arange(6).reshape(2, 3))
    f = tmp_path / "part-0"
    f.write_text("abc\n")
    key = R.job_fingerprint({"shards": R.shard_file_facts([str(f)])})
    f.write_text("abcd\n")
    assert key != R.job_fingerprint({"shards": R.shard_file_facts([str(f)])})
    assert R.shard_file_facts([str(f)]) == [["part-0", 5]]
    assert R.run_nonce() != R.run_nonce()


# -- the part-file path of the CLI against the JAX CLI's ----------------------

# the keys the JAX CLI reads only on its part-file path (the port refused
# them there before it had the path); the first five can change the
# output, the stdout or the sidecars
_PART_CASES = [("shard.report", "true"), ("on.bad.row", "skip"),
               ("on.bad.row", "quarantine"), ("quarantine.dir", "q"),
               ("max.bad.fraction", "0.5"), ("shard.retries", "3"),
               ("shard.timeout.s", "30"), ("shard.speculate", "false"),
               ("shard.speculative.factor", "2"),
               ("shard.speculative.min.wait.s", "5"),
               ("shard.prefetch.depth", "4"), ("shard.journal", "false"),
               ("shard.journal.keep", "true")]
_PER_CASE = {"shard.report", "on.bad.row", "quarantine.dir",
             "max.bad.fraction"}
# planted bad rows of the test parts: (row, kind); elearn's only
# categorical column is its class
_PLANTED = [(7, "ragged"), (60, "numeric"), (130, "class"),
            (181, "numeric")]


@pytest.fixture(scope="module")
def part_dir(tmp_path_factory):
    """Train file, properties and a two-part elearn test dir with planted
    bad rows (``_SUCCESS`` beside the parts)."""
    root = tmp_path_factory.mktemp("parts")
    train, test = write_fixture(root, "elearn", 800, 200, seed=55)
    test = [list(r) for r in test]
    for row, kind in _PLANTED:
        if kind == "ragged":
            test[row] = test[row][:3]
        elif kind == "numeric":
            test[row][4] = "n/a"
        else:
            test[row][-1] = "withdrawn"
    parts = root / "test_parts"
    parts.mkdir()
    for i, rows in enumerate((test[:100], test[100:])):
        (parts / f"part-0000{i}").write_text(
            "".join(",".join(r) + "\n" for r in rows))
    (parts / "_SUCCESS").write_text("")
    props = root / "knn.properties"
    props.write_text("".join(f"{k}={v}\n" for k, v in {
        "field.delim.regex": ",",
        "feature.schema.file.path": root / "schema.json",
        "train.data.path": root / "train.csv", "top.match.count": "5",
        "kernel.function": "none", "distance.scale": "1000",
        "validation.mode": "true", "positive.class.value": "fail",
        "on.bad.row": "quarantine"}.items()))
    return root, parts, str(props)


def _sidecars(qdir):
    """The sidecar files' bytes, then the directory removed, so that the
    next run starts without them."""
    if not os.path.isdir(qdir):
        return {}
    out = {n: open(os.path.join(qdir, n), "rb").read()
           for n in sorted(os.listdir(qdir))}
    shutil.rmtree(qdir)
    return out


def _run(capsys, port, part_dir, out, extra=()):
    """One CLI run (the port's or the JAX package's) on the part dir:
    (output bytes, stdout, sidecars)."""
    root, parts, props = part_dir
    args = ["NearestNeighbor", str(parts), str(root / out), "--conf", props,
            *extra]
    capsys.readouterr()
    if port:
        tmain(args + ["--device", "cpu"])
    else:
        # quantized and ANN are their own paths, without knn.mode
        exact = ([] if any(a.startswith(("knn.quantized", "knn.ann"))
                           for a in extra) else ["-D", "knn.mode=exact"])
        jmain(args + ["-D", "plan.enable=false"] + exact)
    stdout = capsys.readouterr().out
    qdir = "q" if "quarantine.dir=q" in extra else str(parts / "quarantine")
    return (root / out).read_bytes(), stdout, _sidecars(qdir)


@pytest.fixture(scope="module")
def jax_reference(part_dir):
    """One JAX CLI run on the part dir under the base config: the
    reference of every key that cannot change the bytes."""
    root, parts, props = part_dir
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jmain(["NearestNeighbor", str(parts), str(root / "j_ref.txt"),
               "--conf", props, "-D", "plan.enable=false",
               "-D", "knn.mode=exact"])
    return ((root / "j_ref.txt").read_bytes(), buf.getvalue(),
            _sidecars(str(parts / "quarantine")))


@pytest.mark.parametrize("key,value", _PART_CASES)
def test_part_file_keys_match_the_jax_cli(part_dir, jax_reference, capsys,
                                          monkeypatch, tmp_path, key, value):
    """Each key of the part-file path: the port's output file, stdout
    (the Validation JSON and the shard report) and quarantine sidecars
    byte-identical to the JAX CLI's on the same part dir, with planted
    bad rows and on.bad.row=quarantine set in the properties."""
    monkeypatch.chdir(tmp_path)
    extra = ["-D", f"{key}={value}"]
    tag = f"{key}-{value}"
    got = _run(capsys, True, part_dir, f"t_{tag}.txt", extra)
    want = (_run(capsys, False, part_dir, f"j_{tag}.txt", extra)
            if key in _PER_CASE else jax_reference)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(got[0].splitlines()) == 200 - len(_PLANTED)
    report = json.loads(got[1].splitlines()[-1])
    assert report["rows_quarantined"] == len(_PLANTED)
    if value != "skip":
        assert sum(v.count(b"\n") for v in got[2].values()) == len(_PLANTED)
    root = part_dir[0]
    assert os.path.isdir(root / f"t_{tag}.txt.shards") == (
        key == "shard.journal.keep")


@pytest.mark.parametrize("extra", [
    ["-D", "knn.quantized=true"],
    ["-D", "knn.ann=true", "-D", "knn.ann.nlist=8", "-D", "knn.ann.nprobe=8"]],
    ids=["quantized", "ann-full-probe"])
def test_part_file_quantized_and_ann_match_the_jax_cli(part_dir, capsys,
                                                       extra):
    """The part-file path with the quantized scan or the IVF index
    (probing every list; its index built once for all shards): the same
    bytes as the JAX CLI's."""
    got = _run(capsys, True, part_dir, "t_q.txt", extra)
    assert got == _run(capsys, False, part_dir, "j_q.txt", extra)
    assert len(got[0].splitlines()) == 200 - len(_PLANTED)


def _resume(capsys, port, part_dir, out):
    """Run with the journal kept, drop shard 1's record, resume: (kept
    record of shard 0 before, after; the resumed run's bytes, stdout)."""
    root, parts, _ = part_dir
    _run(capsys, port, part_dir, out, ["-D", "shard.journal.keep=true"])
    shards = root / f"{out}.shards"
    os.remove(shards / "shard-00001.json")
    before = (shards / "shard-00000.json").read_text()
    got = _run(capsys, port, part_dir, out, ["--resume"])
    assert not shards.exists()
    return json.loads(before)["run"], got


def test_resume_matches_the_jax_cli(part_dir, jax_reference, capsys):
    """--resume after a lost shard record: the port resumes the journal it
    wrote, recomputing one shard; output, stdout and sidecars equal the
    JAX CLI's resumed run, and the output an uninterrupted run's."""
    _, got = _resume(capsys, True, part_dir, "t_resume.txt")
    _, want = _resume(capsys, False, part_dir, "j_resume.txt")
    assert got == want
    assert got[0] == jax_reference[0]
    report = json.loads(got[1].splitlines()[-1])
    assert (report["shards_resumed"], report["shards_computed"]) == (1, 1)
    assert report["rows_quarantined"] == len(_PLANTED)
    assert list(got[2]) == ["part-00001.bad.jsonl"]


def test_resume_refusals(part_dir, capsys, tmp_path):
    """--resume with shard.journal=false raises, as in the JAX CLI; a
    journal written under another config refuses --resume; a kept record
    keeps its nonce."""
    root, parts, props = part_dir
    with pytest.raises(ValueError, match="needs shard.journal=true"):
        tmain(["NearestNeighbor", str(parts), str(root / "t_r.txt"),
               "--conf", props, "--resume", "-D", "shard.journal=false",
               "--device", "cpu"])
    _run(capsys, True, part_dir, "t_r.txt", ["-D", "shard.journal.keep=true"])
    with pytest.raises(ValueError, match="different job"):
        tmain(["NearestNeighbor", str(parts), str(root / "t_r.txt"),
               "--conf", props, "--resume", "-D", "top.match.count=3",
               "--device", "cpu"])
    shards = root / "t_r.txt.shards"
    nonce = (shards / "shard-00000.json").read_text()
    os.remove(shards / "shard-00001.json")
    _run(capsys, True, part_dir, "t_r.txt",
         ["--resume", "-D", "shard.journal.keep=true"])
    assert (shards / "shard-00000.json").read_text() == nonce
    assert (shards / "shard-00001.json").exists()
    _sidecars(str(parts / "quarantine"))
