"""The port's CLI against the JAX package's, the keys it refuses, and the
rules the port keeps: no JAX, no silent CPU, no hidden fallback."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.utils.dataset import Featurizer
from avenir_tpu_torch.utils.schema import FeatureSchema

from _torch_parity import (
    exact_metrics, near_tie_rows, tables, write_fixture)

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


@pytest.mark.parametrize("key,value", [
    ("plan.enable", "true"), ("knn.quantized", "true"), ("knn.ann", "true"),
    ("knn.ann.nlist", "16"), ("knn.sharded", "true"),
    ("neighbor.data.path", "n.txt"), ("prediction.mode", "regression"),
    ("job.resume", "true"), ("feed.depth", "3"), ("mesh.shape", "2"),
    ("profile.trace.dir", "trace"), ("obs.live", "true"),
    ("alerts.enable", "true")])
def test_knn_refuses_later_keys(tmp_path, key, value):
    write_fixture(tmp_path, "elearn", 50, 10)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv"})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tmain(["NearestNeighbor", str(tmp_path / "test.csv"),
               str(tmp_path / "o.txt"), "--conf", props, "-D",
               f"{key}={value}", "--device", "cpu"])
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("verb", ["BayesianDistribution",
                                  "BayesianPredictor"])
@pytest.mark.parametrize("key,value", [
    ("train.sharded", "true"), ("streaming.train", "true"),
    ("shard.parts", "true"), ("tabular.input", "false"),
    ("plan.enable", "true")])
def test_nb_refuses_later_keys(tmp_path, verb, key, value):
    write_fixture(tmp_path, "churn", 50, 10)
    props = _props(tmp_path / "p.properties", **{
        "feature.schema.file.path": tmp_path / "schema.json",
        "bayesian.model.file.path": tmp_path / "m.txt"})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tmain([verb, str(tmp_path / "train.csv"), str(tmp_path / "o.txt"),
               "--conf", props, "-D", f"{key}={value}", "--device", "cpu"])


@pytest.mark.parametrize("args,match", [
    (["SameTypeSimilarity"], "SameTypeSimilarity"),
    (["FeatureCondProbJoiner"], "FeatureCondProbJoiner"),
    (["NearestNeighbor", "--metrics-out", "m.jsonl"], "--metrics-out"),
    (["NearestNeighbor", "--obs-port", "0"], "--obs-port"),
    (["NearestNeighbor", "--resume"], "--resume")])
def test_cli_refuses_later_verbs_and_flags(tmp_path, args, match):
    props = _props(tmp_path / "p.properties", x="1")
    with pytest.raises(ValueError, match=match):
        tmain([args[0], "in.csv", "out.txt", "--conf", props, *args[1:],
               "--device", "cpu"])


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
