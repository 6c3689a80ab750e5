"""The text verbs and NearestNeighbor modes of the port's CLI against the JAX
CLI's, stdout and every file byte for byte: WordCounter, text Naive Bayes
(``tabular.input=false``), SameTypeSimilarity, FeatureCondProbJoiner,
NearestNeighbor's neighbor-record replay (``neighbor.data.path``, every
record layout and both validation messages) and its regression
(``prediction.mode=regression``, the four methods)."""

import json
import re

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG

from avenir_tpu_torch.cli.main import main as tmain

from _torch_parity import write_csv

torch.set_num_threads(2)


def _props(path, **kv):
    with open(path, "w") as fh:
        for k, v in kv.items():
            fh.write(f"{k}={v}\n")
    return str(path)


def _run(capsys, root, verb, inp, out, props, *extra):
    """The verb through both CLIs: the output files and stdout equal byte
    for byte; returns the port's stdout."""
    jmain([verb, str(inp), str(root / f"j_{out}"), "--conf", props,
           *extra, "-D", "plan.enable=false"])
    j_out = capsys.readouterr().out
    tmain([verb, str(inp), str(root / f"t_{out}"), "--conf", props,
           *extra, "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert (root / f"j_{out}").read_bytes() == \
        (root / f"t_{out}").read_bytes()
    assert j_out == t_out
    return t_out


def _raise_both(capsys, verb, inp, out, props, *extra):
    """Both CLIs raise a ValueError with the same message."""
    with pytest.raises(ValueError) as j:
        jmain([verb, str(inp), str(out), "--conf", props, *extra,
               "-D", "plan.enable=false"])
    with pytest.raises(ValueError) as t:
        tmain([verb, str(inp), str(out), "--conf", props, *extra,
               "--device", "cpu"])
    capsys.readouterr()
    assert str(t.value) == str(j.value)
    return str(t.value)


# -- text: WordCounter and text Naive Bayes -----------------------------------

def _text_rows(n, seed):
    """``text,class`` rows: class-skewed word frequencies, stop words,
    apostrophes, dots and digits among the words."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(150)] + [
        "the", "and", "o'neil", "u.s.a", "42", "3.14", "Offer", "CHEAP"]
    rows = []
    for i in range(n):
        c = ("spam", "ham")[i % 2]
        rank = (np.arange(len(words)) + (0 if c == "spam" else 70)) \
            % len(words)
        p = 1.0 / (1.0 + rank)
        rows.append([" ".join(rng.choice(words, int(rng.integers(1, 25)),
                                         p=p / p.sum())), c])
    return rows


@pytest.fixture(scope="module")
def text_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_cli")
    rows = _text_rows(500, seed=3)
    write_csv(root / "train.csv", rows[:400])
    write_csv(root / "test.csv", rows[400:])
    write_csv(root / "ids.csv", [[f"d{i}", r[0], r[1]]
                                 for i, r in enumerate(rows[:100])])
    (root / "short.csv").write_text("cheap offer\nmeeting,ham\n")
    return root


@pytest.mark.parametrize("inp,extra", [
    ("train.csv", []), ("ids.csv", ["-D", "text.field.ordinal=1"]),
    ("ids.csv", ["-D", "field.delim.out=;"])])
def test_word_counter(capsys, text_dir, inp, extra):
    props = _props(text_dir / "wc.properties", **{"field.delim.regex": ","})
    _run(capsys, text_dir, "WordCounter", text_dir / inp, "wc.txt", props,
         *extra)
    assert (text_dir / "t_wc.txt").read_text().count("\n") > 50


@pytest.mark.parametrize("extra", [
    [], ["-D", "laplace.smoothing=0.5"], ["-D", "laplace.smoothing=0"],
    ["-D", "validation.mode=false", "-D", "field.delim.out=|"]])
def test_text_bayes_verbs(capsys, text_dir, extra):
    """The model file, the predictions and the Validation JSON; the text
    path's laplace.smoothing default is 1.0."""
    props = {}
    for side in ("j", "t"):
        props[side] = _props(text_dir / f"{side}.properties", **{
            "tabular.input": "false", "field.delim.regex": ",",
            "bayesian.model.file.path": text_dir / f"{side}_model.txt",
            "validation.mode": "true"})
    jmain(["BayesianDistribution", str(text_dir / "train.csv"),
           str(text_dir / "j_model.txt"), "--conf", props["j"],
           "-D", "plan.enable=false"])
    j_train = capsys.readouterr().out
    tmain(["BayesianDistribution", str(text_dir / "train.csv"),
           str(text_dir / "t_model.txt"), "--conf", props["t"],
           "--device", "cpu"])
    assert capsys.readouterr().out == j_train
    assert (text_dir / "j_model.txt").read_bytes() == \
        (text_dir / "t_model.txt").read_bytes()
    jmain(["BayesianPredictor", str(text_dir / "test.csv"),
           str(text_dir / "j_pred.txt"), "--conf", props["j"], *extra,
           "-D", "plan.enable=false"])
    j_out = capsys.readouterr().out
    tmain(["BayesianPredictor", str(text_dir / "test.csv"),
           str(text_dir / "t_pred.txt"), "--conf", props["t"], *extra,
           "--device", "cpu"])
    assert capsys.readouterr().out == j_out
    assert (text_dir / "j_pred.txt").read_bytes() == \
        (text_dir / "t_pred.txt").read_bytes()
    if "validation.mode=false" not in extra:
        assert json.loads(j_out.splitlines()[-1])[
            "Validation.Accuracy"] > 0.8


def test_text_predictor_refuses_rows_without_class(capsys, text_dir):
    props = _props(text_dir / "v.properties", **{
        "tabular.input": "false",
        "bayesian.model.file.path": text_dir / "t_model.txt",
        "validation.mode": "true"})
    tmain(["BayesianDistribution", str(text_dir / "train.csv"),
           str(text_dir / "t_model.txt"), "--conf", props, "--device",
           "cpu"])
    msg = _raise_both(capsys, "BayesianPredictor", text_dir / "short.csv",
                      text_dir / "o.txt", props)
    assert "have no class column" in msg


# -- SameTypeSimilarity, FeatureCondProbJoiner and the replay ----------------

@pytest.fixture(scope="module")
def knn_dir(tmp_path_factory):
    """elearn train (400) and test (100) rows, churn rows, the schemas
    (elearn also with manhattan), the train rows' feature-prob artifact
    and a properties file."""
    root = tmp_path_factory.mktemp("knn_modes_cli")
    rows = JG.elearn_rows(500, seed=57)
    write_csv(root / "train.csv", rows[:400])
    write_csv(root / "test.csv", rows[400:])
    schema = JG.elearn_schema_json()
    with open(root / "elearn.json", "w") as fh:
        json.dump(schema, fh)
    with open(root / "manhattan.json", "w") as fh:
        json.dump(dict(schema, distAlgorithm="manhattan"), fh)
    churn = JG.churn_rows(300, seed=5)
    write_csv(root / "churn.csv", churn)
    with open(root / "churn.json", "w") as fh:
        json.dump(JG._CHURN_SCHEMA_JSON, fh)
    props = _props(root / "knn.properties", **{
        "field.delim.regex": ",",
        "feature.schema.file.path": root / "elearn.json",
        "train.data.path": root / "train.csv",
        "bayesian.model.file.path": root / "nb.txt",
        "top.match.count": "5", "kernel.function": "none",
        "distance.scale": "1000", "validation.mode": "true",
        "positive.class.value": "fail", "laplace.smoothing": "1.0"})
    jmain(["BayesianDistribution", str(root / "train.csv"),
           str(root / "nb.txt"), "--conf", props, "-D", "plan.enable=false"])
    jmain(["BayesianPredictor", str(root / "train.csv"),
           str(root / "prob.txt"), "--conf", props, "-D",
           "output.feature.prob.only=true", "-D", "plan.enable=false"])
    jmain(["SameTypeSimilarity", str(root / "test.csv"),
           str(root / "dist.txt"), "--conf", props, "-D",
           "inter.set.matching=true", "-D", "plan.enable=false"])
    return root, props


@pytest.mark.parametrize("inp,extra", [
    ("test.csv", []),
    ("test.csv", ["-D", "inter.set.matching=true"]),
    ("test.csv", ["-D", "feature.schema.file.path={root}/manhattan.json",
                  "-D", "distance.scale=100", "-D", "field.delim.out=;"]),
    ("churn.csv", ["-D", "feature.schema.file.path={root}/churn.json"])])
def test_same_type_similarity(capsys, knn_dir, inp, extra):
    root, props = knn_dir
    extra = [e.format(root=root) for e in extra]
    _run(capsys, root, "SameTypeSimilarity", root / inp, "sim.txt", props,
         *extra)
    n = 100 if inp == "test.csv" else 300
    lines = (root / "t_sim.txt").read_text().splitlines()
    assert len(lines) == (n * 400 if "inter.set.matching=true" in extra
                          else n * (n - 1))


@pytest.mark.parametrize("extra", [
    [], ["-D", "test.class.path={root}/test.csv"]])
def test_feature_cond_prob_joiner(capsys, knn_dir, extra):
    root, props = knn_dir
    extra = [e.format(root=root) for e in extra]
    out = _run(capsys, root, "FeatureCondProbJoiner", root / "dist.txt",
               "join.txt", props, "-D",
               f"feature.prob.path={root / 'prob.txt'}", *extra)
    assert out.strip() == '{"Join.Records": 40000}'


def test_joiner_refuses_an_unknown_train_entity(capsys, knn_dir, tmp_path):
    root, props = knn_dir
    (tmp_path / "d.txt").write_text("S1,nobody,12\n")
    msg = _raise_both(capsys, "FeatureCondProbJoiner", tmp_path / "d.txt",
                      tmp_path / "o.txt", props, "-D",
                      f"feature.prob.path={root / 'prob.txt'}")
    assert "missing from the feature-prob artifact" in msg


def _joined(capsys, root, props, tag, *extra):
    """The 6-field class-conditional records, written by the JAX CLI."""
    path = root / f"joined_{tag}.txt"
    jmain(["FeatureCondProbJoiner", str(root / "dist.txt"), str(path),
           "--conf", props, "-D", f"feature.prob.path={root / 'prob.txt'}",
           *extra, "-D", "plan.enable=false"])
    capsys.readouterr()
    return path


@pytest.mark.parametrize("layout,extra", [
    ("3", []),
    ("3", ["-D", "validation.mode=false"]),
    ("3", ["-D", "test.class.path={root}/test.csv"]),
    ("6", ["-D", "class.condition.weighted=true"]),
    ("6", ["-D", "class.condtion.weighted=true", "-D",
           "kernel.function=linearMultiplicative", "-D",
           "inverse.distance.weighted=true"]),
    ("5", ["-D", "class.condition.weighted=true", "-D",
           "validation.mode=false"]),
    ("plain", []), ("plain4", ["-D", "validation.mode=false"]),
    ("3dir", ["-D", "test.class.path={root}/test.csv", "-D",
              "top.match.count=9", "-D", "kernel.function=gaussian"])])
def test_neighbor_record_replay(capsys, knn_dir, layout, extra):
    """Each record layout: the 3-field distance file (test classes from
    test.class.path, or the skipped-validation message), the 6- and
    5-field class-conditional layouts, the reference's plain layout
    ``trainId,testId,rank,trainClass[,testClass]``, and a part-file dir."""
    root, props = knn_dir
    extra = [e.format(root=root) for e in extra]
    src = root / "dist.txt"
    if layout in ("6", "5"):
        src = _joined(capsys, root, props, "6", "-D",
                      f"test.class.path={root / 'test.csv'}")
        if layout == "5":
            lines = src.read_text().splitlines()
            src = root / "joined_5.txt"
            src.write_text("".join(",".join(f[:1] + f[2:]) + "\n" for f in
                                   (line.split(",") for line in lines)))
    elif layout.startswith("plain"):
        cls = {r.split(",")[0]: r.split(",")[-1] for r in
               (root / "train.csv").read_text().splitlines()}
        tcls = {r.split(",")[0]: r.split(",")[-1] for r in
                (root / "test.csv").read_text().splitlines()}
        src = root / f"{layout}.txt"
        with open(src, "w") as fh:
            for line in (root / "dist.txt").read_text().splitlines():
                te, tr, rank = line.split(",")
                rec = [tr, te, rank, cls[tr]]
                if layout == "plain":
                    rec.append(tcls[te])
                fh.write(",".join(rec) + "\n")
    elif layout == "3dir":
        lines = (root / "dist.txt").read_text().splitlines(keepends=True)
        src = root / "dist_parts"
        src.mkdir(exist_ok=True)
        for i in range(3):
            (src / f"part-0000{i}").write_text(
                "".join(lines[i * 15000:(i + 1) * 15000]))
        (src / "_SUCCESS").write_text("")
    out = _run(capsys, root, "NearestNeighbor", root / "ignored.csv",
               "replay.txt", props, "-D", f"neighbor.data.path={src}",
               *extra)
    if layout == "3":
        skipped = not any(e.startswith(("validation.mode=false",
                                        "test.class.path"))
                          for e in extra)
        assert ("validation.mode=true skipped" in out) == skipped
        assert ("Validation.Accuracy" in out) == any(
            e.startswith("test.class.path") for e in extra)
    assert len((root / "t_replay.txt").read_text().splitlines()) == 100


def test_replay_validation_without_test_classes_raises(capsys, knn_dir):
    """5-field records carry no test class: under validation both CLIs
    raise the same message; and regression refuses the replay."""
    root, props = knn_dir
    src = _joined(capsys, root, props, "nocls")
    five = root / "five.txt"
    five.write_text("".join(",".join(f[:1] + f[2:]) + "\n" for f in
                            (line.split(",") for line in
                             src.read_text().splitlines())))
    msg = _raise_both(capsys, "NearestNeighbor", root / "ignored.csv",
                      root / "o.txt", props, "-D",
                      f"neighbor.data.path={five}", "-D",
                      "class.condition.weighted=true")
    assert "carry no test-class column" in msg
    msg = _raise_both(capsys, "NearestNeighbor", root / "ignored.csv",
                      root / "o.txt", props, "-D",
                      f"neighbor.data.path={root / 'dist.txt'}", "-D",
                      "prediction.mode=regression")
    assert re.search("supports classification", msg)


def test_replay_agrees_with_the_fused_path(capsys, knn_dir):
    """The knn.sh pipeline replayed from files classifies as the fused
    NearestNeighbor does (the bar of the tutorial test, 0.97)."""
    root, props = knn_dir
    tmain(["NearestNeighbor", str(root / "ignored.csv"),
           str(root / "r.txt"), "--conf", props, "-D",
           f"neighbor.data.path={root / 'dist.txt'}", "--device", "cpu"])
    tmain(["NearestNeighbor", str(root / "test.csv"), str(root / "f.txt"),
           "--conf", props, "--device", "cpu"])
    capsys.readouterr()
    replay = dict(line.split(",") for line in
                  (root / "r.txt").read_text().splitlines())
    fused = dict(line.split(",")[:2] for line in
                 (root / "f.txt").read_text().splitlines())
    assert set(replay) == set(fused)
    assert np.mean([replay[k] == fused[k] for k in fused]) >= 0.97


# -- regression ---------------------------------------------------------------

def _regression_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        x = rng.uniform(0, 1, 3)
        target = 200 * x[0] + 100 * x[1] - 50 * x[2] + rng.normal(0, 4)
        rows.append([f"S{i:05d}"] + [f"{int(v * 100)}" for v in x]
                    + [f"{target:.1f}"])
    return rows


@pytest.fixture(scope="module")
def regression_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("knn_regression_cli")
    rows = _regression_rows(500, seed=91)
    write_csv(root / "train.csv", rows[:400])
    write_csv(root / "test.csv", rows[400:])
    (root / "parts").mkdir()
    for i in range(2):
        write_csv(root / "parts" / f"part-0000{i}",
                  rows[400 + 50 * i:450 + 50 * i])
    (root / "parts" / "_SUCCESS").write_text("")
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    for i, name in enumerate(("a", "b", "c")):
        fields.append({"name": name, "ordinal": i + 1, "dataType": "int",
                       "min": 0, "max": 100, "feature": True})
    fields.append({"name": "score", "ordinal": 4, "dataType": "double",
                   "classAttribute": True})
    with open(root / "schema.json", "w") as fh:
        json.dump({"distAlgorithm": "euclidean",
                   "entity": {"fields": fields}}, fh)
    props = _props(root / "r.properties", **{
        "feature.schema.file.path": root / "schema.json",
        "train.data.path": root / "train.csv",
        "prediction.mode": "regression", "top.match.count": "7",
        "validation.mode": "true", "knn.mode": "exact"})
    return root, props


@pytest.mark.parametrize("method,extra", [
    ("average", []), ("median", ["-D", "top.match.count=6"]),
    ("linearRegression", ["-D", "regr.input.field.ordinal=1"]),
    ("multiLinearRegression", []),
    ("multiLinearRegression", ["-D", "regr.input.field.ordinals=1,2"]),
    ("average", ["-D", "feed.chunk.rows=32", "-D", "validation.mode=false"]),
    ("median", ["-D", "knn.quantized=true"]),
    ("average", ["parts"])])
def test_regression(capsys, regression_dir, method, extra):
    """Predictions and the MeanAbsoluteError line; a part-file dir reads
    merged. multiLinearRegression: the JAX package solves its ridge
    system in f32 (ROADMAP C8), the port in float64; on these rows the
    files still agree byte for byte."""
    root, props = regression_dir
    inp = root / "test.csv"
    if extra == ["parts"]:
        inp, extra = root / "parts", []
    out = _run(capsys, root, "NearestNeighbor", inp, "reg.txt", props,
               "-D", f"regression.method={method}", *extra)
    if "validation.mode=false" not in extra:
        mae = json.loads(out.splitlines()[-1])[
            "Validation.MeanAbsoluteError"]
        assert mae < 25, mae


def test_regression_needs_its_input_ordinal(capsys, regression_dir):
    root, props = regression_dir
    msg = _raise_both(capsys, "NearestNeighbor", root / "test.csv",
                      root / "o.txt", props, "-D",
                      "regression.method=linearRegression")
    assert "regr.input.field.ordinal" in msg
