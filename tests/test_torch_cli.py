"""The port's CLI against the JAX package's, the keys it refuses, and the
rules the port keeps: no JAX, no silent CPU, no hidden fallback."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.utils.dataset import Featurizer
from avenir_tpu_torch.utils.schema import FeatureSchema

from _torch_parity import (
    exact_metrics, near_tie_rows, tables, write_csv, write_fixture)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "avenir_tpu_torch"


def _last_json(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.strip()]
    return json.loads(lines[-1])


def _props(path, **kv):
    with open(path, "w") as fh:
        for k, v in kv.items():
            fh.write(f"{k}={v}\n")
    return str(path)


def _run_both(capsys, jax_args, torch_args):
    jmain(jax_args + ["-D", "plan.enable=false"])
    j_out = capsys.readouterr().out
    tmain(torch_args + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    return j_out, t_out


def test_churn_recipe_byte_identical(tmp_path, capsys):
    """The verify skill's churn recipe: model, predictions and the
    Validation JSON, byte for byte."""
    write_fixture(tmp_path, "churn", 1500, 500, seed=99)
    props = _props(tmp_path / "c.properties", **{
        "field.delim.regex": ",", "field.delim": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "validation.mode": "true", "positive.class.value": "closed",
        "laplace.smoothing": "1.0"})
    out = {}
    for tag, fn, extra in (("j", jmain, ["-D", "plan.enable=false"]),
                           ("t", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"model_{tag}.txt")
        fn(["BayesianDistribution", str(tmp_path / "train.csv"), model,
            "--conf", props, "-D", f"bayesian.model.file.path={model}"]
           + extra)
        train_json = _last_json(capsys)
        fn(["BayesianPredictor", str(tmp_path / "test.csv"),
            str(tmp_path / f"pred_{tag}.txt"), "--conf", props,
            "-D", f"bayesian.model.file.path={model}"] + extra)
        out[tag] = (train_json, capsys.readouterr().out)
    assert out["j"] == out["t"]
    for name in ("model", "pred"):
        assert ((tmp_path / f"{name}_j.txt").read_bytes()
                == (tmp_path / f"{name}_t.txt").read_bytes())
    assert json.loads(out["t"][1].splitlines()[-1])[
        "Validation.Accuracy"] > 0.75


@pytest.mark.parametrize("extra", [[], ["-D", "class.condtion.weighted=true"],
                                   ["-D", "feed.chunk.rows=96"]])
def test_elearn_nearest_neighbor_matches(tmp_path, capsys, extra):
    write_fixture(tmp_path, "elearn", 1600, 400, seed=55)
    props = _props(tmp_path / "knn.properties", **{
        "field.delim.regex": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "top.match.count": "5", "kernel.function": "none",
        "distance.scale": "1000", "validation.mode": "true",
        "positive.class.value": "fail"})
    j_out, t_out = _run_both(
        capsys,
        ["NearestNeighbor", str(tmp_path / "test.csv"),
         str(tmp_path / "j.txt"), "--conf", props, "-D", "knn.mode=exact"]
        + extra,
        ["NearestNeighbor", str(tmp_path / "test.csv"),
         str(tmp_path / "t.txt"), "--conf", props] + extra)
    j_rows = (tmp_path / "j.txt").read_text().splitlines()
    t_rows = (tmp_path / "t.txt").read_text().splitlines()
    assert len(j_rows) == len(t_rows) == 400
    differ = np.array([a != b for a, b in zip(j_rows, t_rows)])
    if differ.any():
        # only rows with a near-tie at the k boundary may differ
        _, _, t_train, t_test = tables("elearn", 1600, 400, seed=55)
        tr_num, _, _ = tknn._split_features(t_train)
        te_num, _, _ = tknn._split_features(t_test)
        ties = near_tie_rows(exact_metrics(te_num.numpy(), tr_num.numpy()), 5)
        assert not np.any(differ & ~ties)
        assert differ.sum() < 0.01 * len(differ)
    else:
        assert j_out == t_out
    assert json.loads(t_out.splitlines()[-1])["Validation.Accuracy"] > 0.8


@pytest.mark.parametrize("key,value", [("knn.sharded", "true")])
def test_knn_refuses_later_keys(tmp_path, key, value):
    """Keys at values that select work the port does not carry."""
    write_fixture(tmp_path, "elearn", 50, 10)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv"})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tmain(["NearestNeighbor", str(tmp_path / "test.csv"),
               str(tmp_path / "o.txt"), "--conf", props, "-D",
               f"{key}={value}", "--device", "cpu"])
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("key,value", [
    ("plan.enable", "true"), ("feed.depth", "3"),
    ("profile.trace.dir", "trace")])
def test_knn_keys_once_refused_now_run(tmp_path, capsys, key, value):
    """plan.enable=true (the default plan path), feed.depth with the
    chunked feed (the threaded DeviceFeed three chunks ahead) and
    profile.trace.dir (a torch.profiler trace) run, with the file and
    stdout of the hand-wired body at feed.depth=1."""
    write_fixture(tmp_path, "elearn", 300, 60, seed=8)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "validation.mode": "true", "positive.class.value": "fail",
        "feed.chunk.rows": "16"})
    base = ["NearestNeighbor", str(tmp_path / "test.csv")]
    tmain(base + [str(tmp_path / "ref.txt"), "--conf", props, "-D",
                  "plan.enable=false", "-D", "feed.depth=1", "--device",
                  "cpu"])
    want = capsys.readouterr().out
    value = str(tmp_path / value) if key == "profile.trace.dir" else value
    tmain(base + [str(tmp_path / "o.txt"), "--conf", props, "-D",
                  f"{key}={value}", "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert (tmp_path / "o.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    if key == "profile.trace.dir":
        (trace,) = (tmp_path / "trace").glob("trace-*.json")
        assert json.loads(trace.read_text())["traceEvents"]


_OFF_OBS = [("profile.trace.dir", ""), ("obs.flight.path", ""),
            ("obs.http.port", "-1"), ("obs.live", "false"),
            ("alerts.enable", "false")]


@pytest.mark.parametrize("verb,key,value", [
    *[("BayesianDistribution", k, v) for k, v in _OFF_OBS],
    *[("NearestNeighbor", k, v) for k, v in _OFF_OBS],
    ("NearestNeighbor", "feed.depth", "3"),
    ("NearestNeighbor", "mesh.shape", "2")])
def test_off_values_of_later_keys_match_the_jax_cli(tmp_path, capsys, verb,
                                                    key, value):
    """Keys at values with which the JAX CLI does nothing — the
    observability keys off, feed.depth without the chunked feed,
    mesh.shape without knn.sharded — run, and every output is the JAX
    CLI's, byte for byte."""
    name = "churn" if verb == "BayesianDistribution" else "elearn"
    write_fixture(tmp_path, name, 400, 100, seed=21)
    props = _props(tmp_path / "p.properties", **{
        "field.delim.regex": ",", "field.delim": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "validation.mode": "true", "positive.class.value":
            "closed" if name == "churn" else "fail"})
    data = "train.csv" if name == "churn" else "test.csv"
    extra = ["-D", f"{key}={value}"]
    if verb == "NearestNeighbor":
        extra += ["-D", "knn.mode=exact"]
    j_out, t_out = _run_both(
        capsys,
        [verb, str(tmp_path / data), str(tmp_path / "j.txt"), "--conf",
         props] + extra,
        [verb, str(tmp_path / data), str(tmp_path / "t.txt"), "--conf",
         props] + extra)
    assert j_out == t_out
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt") \
        .read_bytes()


@pytest.mark.parametrize("extra", [
    ["-D", "knn.quantized=true"],
    ["-D", "knn.quantized=true", "-D", "knn.quantized.oversample=2"],
    ["-D", "knn.ann=true", "-D", "knn.ann.nlist=8", "-D", "knn.ann.nprobe=8"],
    ["-D", "knn.ann=true", "-D", "knn.ann.nlist=8", "-D", "knn.ann.nprobe=8",
     "-D", "feed.chunk.rows=96", "-D", "knn.ann.seed=3"]],
    ids=["quantized", "quantized-oversample2", "ann-full-probe",
         "ann-full-probe-chunked"])
def test_quantized_and_ann_outputs_byte_identical(tmp_path, capsys, extra):
    """knn.quantized (int8) and knn.ann probing every list: the output
    file and the Validation JSON byte-identical to the JAX CLI's (full
    probing makes the ANN result independent of the clustering)."""
    write_fixture(tmp_path, "elearn", 1600, 400, seed=56)
    props = _props(tmp_path / "knn.properties", **{
        "field.delim.regex": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "top.match.count": "5", "kernel.function": "none",
        "distance.scale": "1000", "validation.mode": "true",
        "positive.class.value": "fail", "output.class.distr": "true"})
    j_out, t_out = _run_both(
        capsys,
        ["NearestNeighbor", str(tmp_path / "test.csv"),
         str(tmp_path / "j.txt"), "--conf", props] + extra,
        ["NearestNeighbor", str(tmp_path / "test.csv"),
         str(tmp_path / "t.txt"), "--conf", props] + extra)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt") \
        .read_bytes()
    assert j_out == t_out
    assert json.loads(t_out.splitlines()[-1])["Validation.Accuracy"] > 0.8


_ONCE_REFUSED = [
    (["-D", "knn.ann.live=true", "-D", "knn.ann.nprobe=8"], "jax"),
    (["-D", "knn.ann.live=true", "-D", "knn.ann.nprobe=8", "-D",
      "knn.ann.live.tail.budget=64"], "jax"),
    (["--obs-port", "0"], "jax"),
    (["-D", "obs.http.port=0"], "jax"),
    (["-D", "obs.live=true"], "jax"),
    (["-D", "obs.flight.path=FLIGHT"], "unarmed"),
    (["-D", "alerts.enable=true", "-D", "alerts.high.water=64"], "jax"),
    (["--obs-port", "0", "-D", "alerts.enable=true", "-D",
      "obs.slo.p99.ms=250", "--metrics-out", "METRICS"], "unarmed")]


@pytest.mark.parametrize("extra,against", _ONCE_REFUSED,
                         ids=["ann-live", "ann-live-tail-budget", "obs-port",
                              "obs-http-port", "obs-live", "obs-flight-path",
                              "alerts-enable", "armed-with-metrics-out"])
def test_keys_and_flags_once_refused_now_run(tmp_path, capsys, extra,
                                             against):
    """The live ANN keys and the live observability flag and keys, which
    this CLI refused before it carried them, run: the file and stdout are
    the JAX CLI's with the same arguments (``knn.ann.live`` probing every
    list), or the unarmed job's; an armed endpoint's port line comes
    first on both CLIs and differs only in its numbers."""
    write_fixture(tmp_path, "elearn", 1200, 300, seed=58)
    props = _props(tmp_path / "p.properties", **{
        "field.delim.regex": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "top.match.count": "5", "validation.mode": "true",
        "positive.class.value": "fail", "output.class.distr": "true",
        "knn.ann": "true", "knn.ann.nlist": "8"})
    extra = [a.replace("FLIGHT", str(tmp_path / "flight.jsonl"))
             .replace("METRICS", str(tmp_path / "m.jsonl")) for a in extra]
    base = ["NearestNeighbor", str(tmp_path / "test.csv")]
    if against == "jax":
        jmain(base + [str(tmp_path / "want.txt"), "--conf", props, "-D",
                      "plan.enable=false", "-D", "knn.ann.nprobe=8"] + extra)
    else:
        tmain(base + [str(tmp_path / "want.txt"), "--conf", props,
                      "--device", "cpu"])
    want = capsys.readouterr().out.splitlines()
    tmain(base + [str(tmp_path / "got.txt"), "--conf", props, "--device",
                  "cpu"] + extra)
    got = capsys.readouterr().out.splitlines()
    armed = "--obs-port" in extra or "obs.http.port=0" in extra
    if armed:
        port = json.loads(got.pop(0))
        assert port["obs_port"] > 0 and port["pid"] == os.getpid()
        if against == "jax":
            assert set(json.loads(want.pop(0))) == set(port)
    assert got == want
    assert (tmp_path / "got.txt").read_bytes() == \
        (tmp_path / "want.txt").read_bytes()
    if "--metrics-out" in extra:
        assert (tmp_path / "m.jsonl.alerts.jsonl").exists()
        assert (tmp_path / "m.jsonl.prom").exists()


@pytest.mark.parametrize("verb", ["BayesianDistribution",
                                  "BayesianPredictor"])
def test_nb_plan_enable_runs(tmp_path, capsys, verb):
    """plan.enable=true runs (the trainer's default plan path; the
    predictor has no plan and ignores the key), as plan.enable=false
    does, byte for byte."""
    write_fixture(tmp_path, "churn", 300, 60, seed=4)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "bayesian.model.file.path": tmp_path / "m.txt",
        "validation.mode": "true"})
    tmain(["BayesianDistribution", str(tmp_path / "train.csv"),
           str(tmp_path / "m.txt"), "--conf", props, "--device", "cpu"])
    data = "train.csv" if verb == "BayesianDistribution" else "test.csv"
    outs = []
    for flag in ("true", "false"):
        capsys.readouterr()
        tmain([verb, str(tmp_path / data), str(tmp_path / f"o_{flag}.txt"),
               "--conf", props, "-D", f"plan.enable={flag}", "--device",
               "cpu"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
    assert (tmp_path / "o_true.txt").read_bytes() == \
        (tmp_path / "o_false.txt").read_bytes()


@pytest.mark.parametrize("verb", ["BayesianDistribution",
                                  "BayesianPredictor"])
@pytest.mark.parametrize("key,value", [("train.sharded", "true")])
def test_nb_refuses_later_keys(tmp_path, verb, key, value):
    write_fixture(tmp_path, "churn", 50, 10)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "bayesian.model.file.path": tmp_path / "m.txt"})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tmain([verb, str(tmp_path / "train.csv"), str(tmp_path / "o.txt"),
               "--conf", props, "-D", f"{key}={value}", "--device", "cpu"])


@pytest.mark.parametrize("verb", ["BayesianDistribution",
                                  "BayesianPredictor"])
@pytest.mark.parametrize("key", ["streaming.train", "shard.parts",
                                 "job.resume"])
def test_nb_streamed_and_sharded_keys_match_the_jax_cli(tmp_path, capsys,
                                                        verb, key):
    """With the key set, the port's file and stdout equal the JAX CLI's:
    the predictor ignores the key, and the trainer takes the streamed path
    (one file) or the per-shard path (a dir of two part files)."""
    write_fixture(tmp_path, "churn", 900, 300, seed=23)
    src = tmp_path / "train.csv"
    if verb == "BayesianDistribution" and key != "streaming.train":
        lines = src.read_text().splitlines(keepends=True)
        src = tmp_path / "parts"
        src.mkdir()
        (src / "part-00000").write_text("".join(lines[:450]))
        (src / "part-00001").write_text("".join(lines[450:]))
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "bayesian.model.file.path": tmp_path / "model.txt",
        "validation.mode": "true", "laplace.smoothing": "1.0"})
    tmain(["BayesianDistribution", str(tmp_path / "train.csv"),
           str(tmp_path / "model.txt"), "--conf", props, "--device", "cpu"])
    capsys.readouterr()
    if verb == "BayesianPredictor":
        src = tmp_path / "test.csv"
    j_out, t_out = _run_both(
        capsys,
        [verb, str(src), str(tmp_path / "j.txt"), "--conf", props, "-D",
         f"{key}=true"],
        [verb, str(src), str(tmp_path / "t.txt"), "--conf", props, "-D",
         f"{key}=true"])
    assert t_out == j_out and t_out
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt") \
        .read_bytes()
    if verb == "BayesianDistribution":
        # the same model as the merged train's
        assert ((tmp_path / "t.txt").read_bytes()
                == (tmp_path / "model.txt").read_bytes())


@pytest.mark.parametrize("verb", ["GradientBoostBuilder",
                                  "RandomForestBuilder", "NearestNeighbor"])
def test_metrics_out_writes_the_report(tmp_path, capsys, verb):
    """--metrics-out runs the job and writes its report: JSONL events at
    PATH and Prometheus text at PATH.prom, with the job span, the plan's
    node spans and the StepTimer gauges; the output file is the job's
    without the flag."""
    from avenir_tpu_torch import plan as tplan
    from avenir_tpu_torch.obs import exporters as tex
    tplan.reset_cache()
    tex.hub().reset()
    if verb == "NearestNeighbor":
        write_fixture(tmp_path, "elearn", 300, 60, seed=9)
        data = "test.csv"
    else:
        write_csv(tmp_path / "train.csv", JG.retarget_rows(400, seed=9))
        with open(tmp_path / "schema.json", "w") as fh:
            json.dump(JG._RETARGET_SCHEMA_JSON, fh)
        data = "train.csv"
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv", "num.trees": 3,
        "forest.boost.num.rounds": 2, "max.depth": 2})
    args = [verb, str(tmp_path / data), "--conf", props, "--device", "cpu"]
    tmain(args[:2] + [str(tmp_path / "plain.txt")] + args[2:])
    report = str(tmp_path / "m.jsonl")
    tmain(args[:2] + [str(tmp_path / "o.txt")] + args[2:]
          + ["--metrics-out", report])
    capsys.readouterr()
    assert (tmp_path / "o.txt").read_bytes() == \
        (tmp_path / "plain.txt").read_bytes()
    events = tex.read_jsonl(report)
    spans = {e["name"] for e in events if e["type"] == "span"}
    gauges = {e["name"] for e in events if e["type"] == "gauge"}
    assert f"job.{verb}" in spans
    assert any(name.startswith(f"job.{verb}/plan.{verb}.") for name in spans)
    assert {f"job.{verb}.steps", f"job.{verb}.p99_ms"} <= gauges
    prom = tex.parse_prometheus_text((tmp_path / "m.jsonl.prom").read_text())
    assert any(labels.get("span") == f"job.{verb}" for _, labels, _ in prom)
    assert not tex.hub().enabled


def _explain_fixture(tmp_path):
    write_fixture(tmp_path, "churn", 600, 120, seed=12)
    return _props(tmp_path / "p.properties", **{
        "field.delim.regex": ",", "field.delim": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "validation.mode": "true", "ingest.workers": "3",
        "ingest.split.bytes": "9000"})


@pytest.mark.parametrize("verb,data", [
    ("NearestNeighbor", "test.csv"), ("BayesianDistribution", "train.csv")])
def test_explain_matches_the_jax_cli(tmp_path, capsys, verb, data):
    """--explain prints the JAX CLI's plan letter for letter (cold caches
    on both sides), writes PATH.plan.json with --metrics-out, and runs
    nothing."""
    from avenir_tpu import plan as jplan
    from avenir_tpu_torch import plan as tplan
    props = _explain_fixture(tmp_path)
    outs = []
    for tag, fn, extra, plan in (("j", jmain, [], jplan),
                                 ("t", tmain, ["--device", "cpu"], tplan)):
        plan.reset_cache()
        fn([verb, str(tmp_path / data), str(tmp_path / "o.txt"), "--conf",
            props, "--explain", "--metrics-out", str(tmp_path / tag)]
           + extra)
        outs.append(capsys.readouterr().out)
        assert not (tmp_path / "o.txt").exists()
    assert outs[0] == outs[1]
    assert "ingest=parallel workers=3" in outs[1]
    assert json.loads((tmp_path / "j.plan.json").read_text()) == \
        json.loads((tmp_path / "t.plan.json").read_text())


def test_profile_dir_runs_like_the_jax_flag(tmp_path, capsys):
    """--profile-dir is parsed as the JAX CLI parses it: the job's files
    and stdout are the JAX CLI's, and the directory holds the port's
    torch.profiler Chrome trace (the JAX CLI writes its XLA trace)."""
    write_fixture(tmp_path, "churn", 400, 80, seed=13)
    props = _props(tmp_path / "p.properties", **{
        "field.delim.regex": ",", "field.delim": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "laplace.smoothing": "1.0"})
    base = ["BayesianDistribution", str(tmp_path / "train.csv")]
    jmain(base + [str(tmp_path / "j.txt"), "--conf", props,
                  "--profile-dir", str(tmp_path / "jtrace")])
    j_out = capsys.readouterr().out
    tmain(base + [str(tmp_path / "t.txt"), "--conf", props,
                  "--profile-dir", str(tmp_path / "ttrace"), "--device",
                  "cpu"])
    assert capsys.readouterr().out == j_out
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    assert any((tmp_path / "jtrace").rglob("*.trace.json.gz"))
    (trace,) = (tmp_path / "ttrace").glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_refusals_name_roadmap_items_that_exist():
    """Every ROADMAP item a refusal names, in any module of the port, is a
    title of queue A; no message names an item by its number, which
    changes when the queue is reordered."""
    queue = (REPO / "ROADMAP.md").read_text().split("### A.")[1] \
        .split("### B.")[0]
    titles = set(re.findall(r"^\d+\. \*\*(.+?)\.?\*\*", queue, re.M))
    named, by_number = set(), []
    for path in sorted((REPO / "avenir_tpu_torch").rglob("*.py")):
        text = path.read_text()
        named |= set(re.findall(r"roadmap_item\(\s*[\"'](.+?)[\"']\s*\)",
                                text))
        by_number += [f"{path.name}: {m}" for m in
                      re.findall(r"queue A,? item \d+", text)]
    for title in ("Multi-device layer", "Rebalance and the control plane"):
        assert title in named, title
    assert named <= titles, named - titles
    assert not by_number, by_number


# -- the forest and batch bandit verbs ----------------------------------------

def _forest_dirs(tmp_path):
    """j/ and t/, each with 1,500 retarget train rows, 500 test rows, the
    schema and a properties file naming its own model path."""
    rows = JG.retarget_rows(2000, seed=41)
    props = {}
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        write_csv(d / "train.csv", rows[:1500])
        write_csv(d / "test.csv", rows[1500:])
        with open(d / "schema.json", "w") as fh:
            json.dump(JG._RETARGET_SCHEMA_JSON, fh)
        props[side] = _props(
            d / "f.properties", **{
                "feature.schema.file.path": d / "schema.json",
                "field.delim.regex": ",", "field.delim.out": ";",
                "forest.model.file.path": d / "forest.json",
                "positive.class.value": "yes", "num.trees": 5,
                "random.split.set.size": 2, "max.depth": 3,
                "random.seed": 3})
    return props


@pytest.mark.parametrize("extra", [
    [], ["-D", "forest.growth=serial", "-D", "bagging=false",
         "-D", "split.algorithm=entropy"],
    ["-D", "num.trees=4", "-D", "min.node.size=5",
     "-D", "split.selection.strategy=randomFromTop"]])
def test_forest_verbs_byte_identical(tmp_path, capsys, extra):
    """RandomForestBuilder (the JAX CLI's default plan path and its
    hand-wired body write the same artifact) and RandomForestPredictor with
    validation, on the host walk and the device vote."""
    props = _forest_dirs(tmp_path)
    j, t = tmp_path / "j", tmp_path / "t"
    built = _run_both(
        capsys, ["RandomForestBuilder", str(j / "train.csv"),
                 str(j / "forest.json"), "--conf", props["j"], *extra],
        ["RandomForestBuilder", str(t / "train.csv"), str(t / "forest.json"),
         "--conf", props["t"], *extra])
    assert built[0] == built[1]
    assert json.loads(built[1])["Forest.Rows"] == 1500
    assert (j / "forest.json").read_bytes() == \
        (t / "forest.json").read_bytes()
    jmain(["RandomForestBuilder", str(j / "train.csv"),
           str(j / "plan.json"), "--conf", props["j"], *extra])
    assert capsys.readouterr().out == built[0]
    assert (j / "plan.json").read_bytes() == (j / "forest.json").read_bytes()
    for on_device in ("false", "true"):
        keys = ["-D", "validation.mode=true",
                "-D", f"device.predict={on_device}"]
        pred = _run_both(
            capsys, ["RandomForestPredictor", str(j / "test.csv"),
                     str(j / "pred.txt"), "--conf", props["j"], *keys],
            ["RandomForestPredictor", str(t / "test.csv"),
             str(t / "pred.txt"), "--conf", props["t"], *keys])
        assert pred[0] == pred[1]
        assert json.loads(pred[1])["Validation.Accuracy"] > 0.65
        assert (j / "pred.txt").read_bytes() == (t / "pred.txt").read_bytes()


def test_forest_builder_refusals_and_errors(tmp_path):
    props = _forest_dirs(tmp_path)
    t = tmp_path / "t"
    args = ["RandomForestBuilder", str(t / "train.csv"),
            str(t / "forest.json"), "--conf", props["t"], "--device", "cpu"]
    # plan.enable=true is the default plan path now: it runs, with the
    # hand-wired body's artifact
    for flag in ("true", "false"):
        tmain(["RandomForestBuilder", str(t / "train.csv"),
               str(t / f"plan_{flag}.json"), "--conf", props["t"],
               "--device", "cpu", "-D", f"plan.enable={flag}"])
    assert (t / "plan_true.json").read_bytes() == \
        (t / "plan_false.json").read_bytes()
    with pytest.raises(ValueError, match="unknown forest growth mode"):
        tmain(args + ["-D", "forest.growth=eager"])
    with pytest.raises(ValueError, match="n_trees must be >= 1"):
        tmain(args + ["-D", "num.trees=0"])
    assert not (t / "forest.json").exists()


def _bandit_files(tmp_path):
    """A round's ``group,item,count,reward`` file for 40 price-optimization
    groups (untried arms, equal rewards) and a per-group batch-size file."""
    from avenir_tpu_torch.datagen import price_opt_arms
    rng = np.random.default_rng(17)
    lines, sizes = [], []
    for g, (arms, expect) in price_opt_arms(n_groups=40, seed=11).items():
        for a, reward in zip(arms, expect):
            count = int(rng.integers(0, 4))
            lines.append([g, a, str(count),
                          str(int(reward) // 10 * 10 if count else 0)])
        sizes.append([g, str(int(rng.integers(1, 4)))])
    write_csv(tmp_path / "round.csv", lines)
    write_csv(tmp_path / "sizes.csv", sizes[::2])
    return str(tmp_path / "round.csv"), str(tmp_path / "sizes.csv")


@pytest.mark.parametrize("verb,keys", [
    ("GreedyRandomBandit", {"prob.reduction.algorithm": "logLinear",
                            "random.selection.prob": 0.7}),
    ("GreedyRandomBandit", {"prob.reduction.algorithm": "AuerGreedy"}),
    ("AuerDeterministic", {}),
    ("SoftMaxBandit", {"temp.constant": 0.5}),
    ("RandomFirstGreedyBandit", {"exploration.count.strategy": "pac",
                                 "current.round.num": 9}),
    ("RandomFirstGreedyBandit", {"current.round.num": 30})])
def test_batch_bandit_verbs_byte_identical(tmp_path, capsys, verb, keys):
    data, sizes = _bandit_files(tmp_path)
    props = _props(tmp_path / "b.properties", **{
        "field.delim.regex": ",", "field.delim": ",", "batch.size": 2,
        "current.round.num": 4, "random.seed": 5,
        "group.item.count.path": sizes, **keys})
    outs = _run_both(
        capsys, [verb, data, str(tmp_path / "j.txt"), "--conf", props],
        [verb, data, str(tmp_path / "t.txt"), "--conf", props])
    assert outs[0] == outs[1]
    got = (tmp_path / "t.txt").read_bytes()
    assert got == (tmp_path / "j.txt").read_bytes()
    assert len(got.splitlines()) > 40


# a two-part elearn directory: both CLIs score it on their part-file path
# (tests/test_torch_shards.py holds the keys that path reads)
def _two_parts(tmp_path, n_train=800, n_test=200):
    train, test = write_fixture(tmp_path, "elearn", n_train, n_test,
                                seed=55)
    parts = tmp_path / "test_parts"
    parts.mkdir()
    half = len(test) // 2
    for i, rows in enumerate((test[:half], test[half:])):
        (parts / f"part-0000{i}").write_text(
            "".join(",".join(r) + "\n" for r in rows))
    (parts / "_SUCCESS").write_text("")
    props = _props(tmp_path / "knn.properties", **{
        "field.delim.regex": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "top.match.count": "5", "kernel.function": "none",
        "distance.scale": "1000", "validation.mode": "true",
        "positive.class.value": "fail"})
    return parts, props


@pytest.mark.parametrize("extra", [
    ["-D", "shard.retries=1", "-D", "on.bad.row=raise"],
    ["-D", "shard.prefetch=false", "-D", "shard.report=true",
     "-D", "on.bad.row=skip"]])
def test_knn_part_file_keys_at_defaults_or_merged(tmp_path, capsys, extra):
    """Keys at their JAX defaults (both CLIs' part-file path), or
    shard.prefetch=false (both CLIs' merged path, which reads none of
    them): outputs byte-identical to the JAX CLI's."""
    parts, props = _two_parts(tmp_path)
    j_out, t_out = _run_both(
        capsys,
        ["NearestNeighbor", str(parts), str(tmp_path / "j.txt"), "--conf",
         props, "-D", "knn.mode=exact"] + extra,
        ["NearestNeighbor", str(parts), str(tmp_path / "t.txt"), "--conf",
         props] + extra)
    assert j_out == t_out
    assert ((tmp_path / "j.txt").read_bytes()
            == (tmp_path / "t.txt").read_bytes())
    assert len((tmp_path / "t.txt").read_text().splitlines()) == 200


def test_knn_single_file_ignores_part_file_keys(tmp_path, capsys):
    """A single file takes the merged path in both CLIs, which reads
    neither the part-file keys nor job.resume."""
    write_fixture(tmp_path, "elearn", 200, 40, seed=55)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv"})
    tmain(["NearestNeighbor", str(tmp_path / "test.csv"),
           str(tmp_path / "o.txt"), "--conf", props, "-D",
           "shard.report=true", "--resume", "--device", "cpu"])
    assert len((tmp_path / "o.txt").read_text().splitlines()) == 40
    assert capsys.readouterr().out == ""


def test_cli_knows_every_verb_of_the_jax_cli():
    """Each verb of the JAX CLI is ported or refused by name; none fails
    in argparse as an invalid choice."""
    from avenir_tpu.cli.main import VERBS as JVERBS
    from avenir_tpu_torch.cli.main import _LATER_VERBS, VERBS
    assert not set(VERBS) & set(_LATER_VERBS)
    assert set(VERBS) | set(_LATER_VERBS) == set(JVERBS)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = [path for path in sorted(PORT.rglob("*.py"))
             if "_build" not in path.parts]   # build outputs, not sources
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "avenir_tpu"), (
                f"{path.relative_to(REPO)} imports {name}")


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, avenir_tpu_torch; avenir_tpu_torch.cli.main; "
            "import avenir_tpu_torch.interop; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'avenir_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_default_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    schema = FeatureSchema.from_json(json.loads(json.dumps(
        {"fields": [{"name": "id", "ordinal": 0, "id": True}]})))
    with pytest.raises(RuntimeError, match="--device cpu"):
        Featurizer(schema)
    write_fixture(tmp_path, "churn", 30, 5)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json"})
    with pytest.raises(RuntimeError, match="--device cpu"):
        tmain(["BayesianDistribution", str(tmp_path / "train.csv"),
               str(tmp_path / "m.txt"), "--conf", props])
    assert not (tmp_path / "m.txt").exists()


def test_module_entry_point_runs_on_cpu(tmp_path):
    write_fixture(tmp_path, "churn", 300, 50)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json"})
    out = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", "BayesianDistribution",
         str(tmp_path / "train.csv"), str(tmp_path / "m.txt"), "--conf",
         props, "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1])[
        "Distribution Data.Records"] == 300.0
    assert (tmp_path / "m.txt").read_text().startswith("open,1,")


@pytest.mark.parametrize("name,alone", [("chip_smoke.py", False),
                                        ("chip_smoke.py", True)])
def test_card_scripts_fail_without_a_card(tmp_path, name, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = REPO / name
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / name)
        script, cwd = tmp_path / name, tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# x = 0, so each train row's metric is |y|²: rows 0, 1 tie at 1, rows 2, 3
# tie at 4, rows 4, 5 tie at 9; the plain top-4 is ids 0..3
_GATE_Y = torch.tensor([[1., 0.], [0., 1.], [2., 0.], [0., 2.], [3., 0.],
                        [0., 3.]])


@pytest.mark.parametrize("ids,metrics,match", [
    ([0, 1, 2], [1., 1., 4.], None),              # the plain answer
    ([1, 0, 2], [1., 1., 4.], None),              # swapped within a tie
    ([0, 1, 3], [1., 1., 4.], None),              # other set, boundary tie
    ([0, 1, 4], [1., 1., 4.], "not those of its ids"),
    ([0, 1, 4], [1., 1., 9.], "beyond 1e-5 relative"),
    ([0, 0, 2], [1., 1., 4.], "repeats"),
    ([0, 1, 6], [1., 1., 4.], "outside the train rows"),
])
def test_smoke_topk_gate(ids, metrics, match):
    """The card's top-k gate takes the plain answer and near-tie swaps,
    and refuses ids whose metrics are not the ones reported."""
    smoke = _chip_smoke()
    from avenir_tpu_torch.ops import cuda_distance
    x = torch.zeros((1, 2))
    y2 = (_GATE_Y * _GATE_Y).sum(1)
    plain = smoke.plain_with_next(cuda_distance.topk_raw_plain, x, _GATE_Y,
                                  y2, 3)
    assert plain[1].tolist() == [[0, 1, 2, 3]]
    got = (torch.tensor([metrics]), torch.tensor([ids], dtype=torch.int32))
    if match is None:
        check = smoke.compare_topk("gate", got, plain, x, _GATE_Y, y2, 2)
        assert check["rows"] == (ids != [0, 1, 2])
        assert check["sets"] == (ids == [0, 1, 3])
    else:
        with pytest.raises(AssertionError, match=match):
            smoke.compare_topk("gate", got, plain, x, _GATE_Y, y2, 2)


@pytest.mark.parametrize("n_bytes,copies", [
    (1_048_576 * 6 * 4, 5),        # K1 at 1,048,576 x 5 churn rows
    (20 * 100_000 * 4, 14),        # K4 at the MI shape
    (2 * 16_777_216 * 4, 1),       # K4, one pair at 16,777,216 rows
])
def test_smoke_hbm_copies_fill_the_l2_twice(n_bytes, copies):
    """The card's HBM timing rotates through enough input copies that
    each is gone from the 50 MB L2 before it is read again."""
    smoke = _chip_smoke()
    assert smoke.hbm_copies(n_bytes) == copies
    assert copies * n_bytes >= 2 * smoke.L2_BYTES or copies == 1


@pytest.mark.parametrize("chunk", [0, 128])
def test_smoke_records_the_main_path(tmp_path, chunk):
    """The recorder sees each kernel call of a CLI job — one K2 call, or
    one K3 call per chunk with the ragged tail — with operands that pass
    the gate, and puts the wrappers back afterwards."""
    smoke = _chip_smoke()
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused
    write_fixture(tmp_path, "elearn", 1000, 300)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "feed.chunk.rows": chunk})
    wrappers = (cuda_distance.topk_raw, cuda_fused.fused_topk_raw)
    calls = []
    with smoke.recording(calls):
        tmain(["NearestNeighbor", str(tmp_path / "test.csv"),
               str(tmp_path / "out.txt"), "--conf", props, "--device", "cpu"])
    assert (cuda_distance.topk_raw, cuda_fused.fused_topk_raw) == wrappers
    names = {name for name, _, _ in calls}
    assert names == ({"K3"} if chunk else {"K2"})
    rows = [a["x_raw" if chunk else "x"].shape[0] for _, a, _ in calls]
    assert rows == ([128, 128, 44] if chunk else [300])
    for name, a, out in calls:
        if name == "K2":
            x = a["x"]
            plain = smoke.plain_with_next(cuda_distance.topk_raw_plain, x,
                                          a["y"], a["y2"], a["k"])
        else:
            x = cuda_fused.normalize(a["x_raw"], a["mins"], a["span"])
            plain = smoke.plain_with_next(
                cuda_fused.fused_topk_raw_plain, a["x_raw"], a["y"], a["y2"],
                a["k"], a["mins"], a["span"])
        check = smoke.compare_topk(name, out, plain, x, a["y"], a["y2"], 9)
        assert check["int_err"] == 0


@pytest.mark.parametrize("module_name,wrapper,label", [
    ("cuda_distance", "topk_raw", "K2"),
    ("cuda_fused", "fused_topk_raw", "K3")])
def test_smoke_recording_keeps_the_launch_counts(monkeypatch, module_name,
                                                 wrapper, label):
    """A wrapper that launches while the recorder stands in for it still
    counts the launch, on the wrapper itself once the recorder exits. The
    launch is faked on meta tensors, which take the wrapper's launch
    branch as CUDA tensors do."""
    import importlib
    smoke = _chip_smoke()
    module = importlib.import_module(f"avenir_tpu_torch.ops.{module_name}")
    fn = getattr(module, wrapper)
    monkeypatch.setattr(fn, "launches", fn.launches)

    def fake_launch(x, y, y2, k, **scales):
        return (torch.empty((x.shape[0], k), device="meta"),
                torch.empty((x.shape[0], k), dtype=torch.int32,
                            device="meta"))

    monkeypatch.setattr(module, "_launch_topk", fake_launch)
    before = fn.launches
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    scales = (meta(3), meta(3)) if label == "K3" else ()
    calls = []
    with smoke.recording(calls):
        getattr(module, wrapper)(meta(4, 3), meta(8, 3), meta(8), *scales, 2)
    assert getattr(module, wrapper) is fn
    assert [name for name, _, _ in calls] == [label]
    assert fn.launches == before + 1
