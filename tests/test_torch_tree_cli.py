"""The port's five tree verbs against the JAX CLI's: TreeBuilder,
TreePredictor, ClassPartitionGenerator, SplitGenerator and
DataPartitioner, each run by both CLIs on the same retarget rows in two
directory trees whose files are then compared.

Every file and every line of stdout is byte-identical, but the
statistics of the candidate-split files (``splits*.txt``,
``splits/part-r-00000``): the JAX package computes them in compiled XLA
kernels, which round in another order than eager JAX
(``tests/test_torch_tree.py``), so those fields are held within
``STAT_RTOL`` relative or ``STAT_ATOL`` absolute, for every algorithm,
and every other field of those lines exactly."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG

from avenir_tpu_torch.cli.main import main as tmain

from _torch_parity import write_csv

torch.set_num_threads(2)

STAT_RTOL, STAT_ATOL = 1e-6, 1e-6
SIDES = {"j": lambda args: jmain(args),
         "t": lambda args: tmain(args + ["--device", "cpu"])}


def _is_splits(path: Path) -> bool:
    return path.name.startswith("splits") or path.parent.name == "splits"


def _assert_split_lines_close(a: str, b: str, where: str) -> None:
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), where
    for x, y in zip(la, lb):
        fx, fy = x.split(";"), y.split(";")
        assert len(fx) == len(fy), where
        # attr;key;stat then segment;class;prob triples: the stat and the
        # probabilities are numbers, every other field is text
        numeric = {2} | set(range(5, len(fx), 3))
        for i, (u, v) in enumerate(zip(fx, fy)):
            if i in numeric:
                np.testing.assert_allclose(float(v), float(u),
                                           rtol=STAT_RTOL, atol=STAT_ATOL,
                                           err_msg=where)
            else:
                assert u == v, where


def _assert_dirs_equal(j: Path, t: Path) -> int:
    """Every file under ``j`` and ``t``: the same relative paths, the same
    bytes (candidate-split stats within the tolerance). Returns the file
    count."""
    jf = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    tf = sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
    assert jf == tf
    for rel in jf:
        a, b = (j / rel).read_bytes(), (t / rel).read_bytes()
        if a != b and _is_splits(rel):
            _assert_split_lines_close(a.decode(), b.decode(), str(rel))
        else:
            assert a == b, str(rel)
    return len(jf)


@pytest.fixture
def both(tmp_path):
    """Two directories j/ and t/ holding data.csv (1,200 retarget rows),
    test.csv (400) and schema.json, each with its properties file beside
    it, and a runner that runs one command of
    each CLI in its own directory (paths relative to it) and returns both
    stdouts."""
    rows = JG.retarget_rows(1600, seed=31)
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        write_csv(d / "data.csv", rows[:1200])
        write_csv(d / "test.csv", rows[1200:])
        with open(d / "schema.json", "w") as fh:
            json.dump(JG._RETARGET_SCHEMA_JSON, fh)
        with open(tmp_path / f"{side}.properties", "w") as fh:
            fh.write(f"feature.schema.file.path={d / 'schema.json'}\n"
                     "field.delim.regex=,\nfield.delim.out=;\n"
                     f"tree.model.file.path={d / 'model.json'}\n"
                     "positive.class.value=yes\n")

    def run(capsys, verb, inp, out, *extra):
        outs = {}
        for side, fn in SIDES.items():
            d = tmp_path / side
            fn([verb, str(d / inp), str(d / out), "--conf",
                str(tmp_path / f"{side}.properties"),
                *[a.replace("{d}", str(d)) for a in extra]])
            captured = capsys.readouterr()
            outs[side] = (captured.out, captured.err.replace(str(d), "{d}"))
        return outs
    run.dirs = (tmp_path / "j", tmp_path / "t")
    return run


@pytest.mark.parametrize("algorithm", ["giniIndex", "entropy",
                                       "hellingerDistance",
                                       "classConfidenceRatio"])
def test_tree_builder_and_predictor(capsys, both, algorithm):
    built = both(capsys, "TreeBuilder", "data.csv", "model.json",
                 "-D", "max.depth=4", "-D", f"split.algorithm={algorithm}",
                 "-D", "min.node.size=5")
    assert built["j"] == built["t"]
    assert json.loads(built["t"][0])["Tree.Depth"] >= 2
    for on_device in ("true", "false"):
        pred = both(capsys, "TreePredictor", "test.csv", "pred.txt",
                    "-D", "validation.mode=true",
                    "-D", f"device.predict={on_device}")
        assert pred["j"] == pred["t"]
        if algorithm in ("giniIndex", "entropy"):
            # the planted rule caps the accuracy near 0.725
            assert json.loads(pred["t"][0].splitlines()[-1])[
                "Validation.Accuracy"] > 0.65
        _assert_dirs_equal(*both.dirs)


def test_models_cross_over(capsys, both):
    """Each CLI's TreePredictor reads the model the other's TreeBuilder
    wrote: the JSON artifact carries the tree."""
    both(capsys, "TreeBuilder", "data.csv", "model.json",
         "-D", "max.depth=3")
    j, t = both.dirs
    shutil.copy(j / "model.json", t / "model_j.json")
    shutil.copy(t / "model.json", j / "model_t.json")
    jmain(["TreePredictor", str(j / "test.csv"), str(j / "cross.txt"),
           "--conf", str(j.parent / "j.properties"),
           "-D", f"tree.model.file.path={j / 'model_t.json'}"])
    tmain(["TreePredictor", str(t / "test.csv"), str(t / "cross.txt"),
           "--conf", str(t.parent / "t.properties"),
           "-D", f"tree.model.file.path={t / 'model_j.json'}",
           "--device", "cpu"])
    both(capsys, "TreePredictor", "test.csv", "pred.txt")
    for d in (j, t):
        assert (d / "cross.txt").read_bytes() == (d / "pred.txt").read_bytes()
    assert (j / "cross.txt").read_bytes() == (t / "cross.txt").read_bytes()


def test_random_from_top_and_budget_fallback(capsys, both):
    random = both(capsys, "TreeBuilder", "data.csv", "model.json",
                  "-D", "split.selection.strategy=randomFromTop",
                  "-D", "random.seed=7", "-D", "max.depth=3")
    assert random["j"] == random["t"]
    _assert_dirs_equal(*both.dirs)
    # past the device node budget the CLI grows on the host loop
    fallback = both(capsys, "TreeBuilder", "data.csv", "model2.json",
                    "-D", "device.node.budget=2", "-D", "max.depth=4",
                    "-D", "min.node.size=2")
    assert fallback["j"] == fallback["t"]
    assert "using the per-level host loop" in fallback["t"][1]
    _assert_dirs_equal(*both.dirs)


@pytest.mark.parametrize("algorithm,extra", [
    ("giniIndex", ()),
    ("entropy", ()),
    ("hellingerDistance", ()),
    ("hellingerDistance", ("-D", "hellinger.absent.class.value=reference")),
    ("classConfidenceRatio", ()),
])
def test_root_and_candidate_splits(capsys, both, algorithm, extra):
    alg = ("-D", f"split.algorithm={algorithm}") + extra
    root = both(capsys, "ClassPartitionGenerator", "data.csv", "root.txt",
                "-D", "at.root=true", *alg)
    assert root["j"] == root["t"]
    j, t = both.dirs
    # at.root: eager JAX, byte-identical for every algorithm
    assert (j / "root.txt").read_bytes() == (t / "root.txt").read_bytes()
    parent = (t / "root.txt").read_text().strip()
    for name, keys in (("splits.txt", ()),
                       ("splits_prob.txt", ("-D", "output.split.prob=true",
                                            "-D", f"parent.info={parent}"))):
        out = both(capsys, "ClassPartitionGenerator", "data.csv", name,
                   *alg, *keys)
        assert out["j"] == out["t"]
    _assert_dirs_equal(*both.dirs)


@pytest.mark.parametrize("keys", [
    ("-D", "split.attribute.selection.strategy=userSpecified",
     "-D", "split.attributes=3,1"),
    ("-D", "split.attribute.selection.strategy=random",
     "-D", "random.split.set.size=2", "-D", "random.seed=5"),
    ("-D", "split.attribute.selection.strategy=notUsedYet",
     "-D", "used.split.attributes=1"),
])
def test_attribute_selection_strategies(capsys, both, keys):
    out = both(capsys, "ClassPartitionGenerator", "data.csv", "splits.txt",
               *keys)
    assert out["j"] == out["t"]
    _assert_dirs_equal(*both.dirs)


def test_tutorial_rounds_by_level(capsys, both):
    """The tutorial's ClassPartitionGenerator at.root → SplitGenerator →
    DataPartitioner round, then a second round on each partition with the
    notUsedYet strategy reading the lineage sidecars."""
    root = both(capsys, "ClassPartitionGenerator", "data.csv", "root.txt",
                "-D", "at.root=true")
    assert root["j"] == root["t"]
    parent = (both.dirs[1] / "root.txt").read_text().strip()
    both(capsys, "SplitGenerator", "data.csv", "splits.txt",
         "-D", f"parent.info={parent}")
    part = both(capsys, "DataPartitioner", "data.csv", "node",
                "-D", "candidate.splits.path={d}/splits.txt")
    assert part["j"] == part["t"]
    assert json.loads(part["t"][0])["split.attribute"] in (1, 3)
    j, t = both.dirs
    parts = sorted(p.relative_to(t) for p in
                   t.glob("node/split=*/segment=*/data/partition.txt"))
    assert len(parts) >= 2
    for rel in parts:
        node = rel.parent.parent
        for verb, out, extra in (
                ("SplitGenerator", f"{node}/splits/part-r-00000",
                 ("-D", "split.attribute.selection.strategy=notUsedYet")),
                ("DataPartitioner", str(node),
                 ("-D", "split.attribute.selection.strategy=notUsedYet"))):
            os.makedirs(j / node / "splits", exist_ok=True)
            os.makedirs(t / node / "splits", exist_ok=True)
            res = both(capsys, verb, str(rel), out, *extra)
            assert res["j"] == res["t"]
    assert _assert_dirs_equal(j, t) > 2 * len(parts)
    # SplitGenerator's project.base.path layout
    for d in (j, t):
        os.makedirs(d / "base" / "split=root" / "data")
        shutil.copy(d / "data.csv", d / "base" / "split=root" / "data")
    both(capsys, "SplitGenerator", "data.csv", "ignored.txt",
         "-D", "project.base.path={d}/base", "-D", "split.path=data.csv")
    assert (t / "base/split=root/data/splits/part-r-00000").is_file()
    _assert_dirs_equal(j, t)


@pytest.mark.parametrize("algorithm", ["giniIndex", "entropy"])
def test_batched_levels(capsys, both, algorithm):
    out = both(capsys, "DataPartitioner", "data.csv", "node",
               "-D", "tree.levels.per.invocation=3",
               "-D", f"split.algorithm={algorithm}",
               "-D", "candidate.splits.path={d}/splits.txt")
    assert out["j"] == out["t"]
    assert json.loads(out["t"][0])["tree.levels"] == 3
    assert _assert_dirs_equal(*both.dirs) > 10
