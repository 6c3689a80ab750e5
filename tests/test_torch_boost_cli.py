"""GradientBoostBuilder and GradientBoostPredictor of the port's CLI
against the JAX CLI's on retarget rows: the artifact, the prediction
file and stdout byte for byte, in core and streamed over part files, and
the refusals."""

import json

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


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """j/ and t/, each with 1,500 retarget train rows (also as three part
    files), 500 test rows, the schema and a properties file naming its
    own model path."""
    root = tmp_path_factory.mktemp("boost_cli")
    rows = JG.retarget_rows(2000, seed=41)
    props = {}
    for side in ("j", "t"):
        d = root / side
        (d / "parts").mkdir(parents=True)
        write_csv(d / "train.csv", rows[:1500])
        write_csv(d / "test.csv", rows[1500:])
        for i in range(3):
            write_csv(d / "parts" / f"part-0000{i}",
                      rows[i * 500:(i + 1) * 500])
        (d / "parts" / "_SUCCESS").write_text("")
        with open(d / "schema.json", "w") as fh:
            json.dump(JG._RETARGET_SCHEMA_JSON, fh)
        props[side] = _props(
            d / "b.properties", **{
                "feature.schema.file.path": d / "schema.json",
                "featurizer.fit.data.path": d / "train.csv",
                "field.delim.regex": ",", "field.delim.out": ";",
                "forest.boost.model.file.path": d / "boost.json",
                "positive.class.value": "yes",
                "forest.boost.num.rounds": 8,
                "forest.boost.learning.rate": 0.3, "max.depth": 3})
    return root, props


def _both(capsys, root, props, verb, inp, out, *extra, plan_off=True):
    """The JAX CLI's stdout (its hand-wired body, or with ``plan_off``
    False its default plan path) and the port's, each on its own
    directory."""
    outs = []
    for side, main, tail in (("j", jmain, ["-D", "plan.enable=false"]
                              if plan_off else []),
                             ("t", tmain, ["--device", "cpu"])):
        d = root / side
        main([verb, str(d / inp), str(d / out), "--conf", props[side],
              *extra, *tail])
        outs.append(capsys.readouterr().out)
    return outs


def _same(root, name):
    return (root / "j" / name).read_bytes() == (root / "t" / name).read_bytes()


@pytest.mark.parametrize("extra,plan_off", [
    ([], False),
    (["-D", "split.algorithm=entropy", "-D", "forest.boost.reg.lambda=0.5",
      "-D", "forest.boost.base.score=-0.2"], True),
    (["-D", "forest.boost.num.rounds=30", "-D",
      "forest.boost.learning.rate=0.9", "-D", "max.depth=5", "-D",
      "forest.boost.early.stop.rounds=2"], True)])
def test_boost_verbs_byte_identical(dirs, capsys, extra, plan_off):
    """GradientBoostBuilder (against the JAX CLI's plan path by default,
    which writes the same artifact as its body) and GradientBoostPredictor
    with and without validation, on the host walk and the device route."""
    root, props = dirs
    built = _both(capsys, root, props, "GradientBoostBuilder", "train.csv",
                  "boost.json", *extra, plan_off=plan_off)
    assert built[0] == built[1]
    assert json.loads(built[1])["Boost.LearningRate"] > 0
    assert _same(root, "boost.json")
    if "forest.boost.early.stop.rounds=2" in extra:
        model = json.loads((root / "t" / "boost.json").read_text())
        assert model["roundsUsed"] == len(model["trees"]) < 30
    for keys in ([], ["-D", "validation.mode=true", "-D",
                      "device.predict=false"],
                 ["-D", "validation.mode=true", "-D",
                  "device.predict=true"]):
        pred = _both(capsys, root, props, "GradientBoostPredictor",
                     "test.csv", "pred.txt", *keys)
        assert pred[0] == pred[1]
        assert _same(root, "pred.txt")
        if keys:
            assert json.loads(pred[1])["Validation.Accuracy"] > 0.65


def test_boost_builder_streams_part_files(dirs, capsys):
    """``streaming.train=true`` over the part dir: the JAX CLI's artifact
    and stdout, and the in-core model over the same rows."""
    root, props = dirs
    streamed = _both(capsys, root, props, "GradientBoostBuilder", "parts",
                     "streamed.json", "-D", "streaming.train=true")
    assert streamed[0] == streamed[1]
    assert _same(root, "streamed.json")
    t = root / "t"
    tmain(["GradientBoostBuilder", str(t / "train.csv"),
           str(t / "incore.json"), "--conf", props["t"], "--device", "cpu"])
    capsys.readouterr()
    assert (t / "incore.json").read_bytes() == \
        (t / "streamed.json").read_bytes()


def test_boost_verbs_refusals(dirs, capsys):
    root, props = dirs
    t = root / "t"
    args = ["GradientBoostBuilder", str(t / "train.csv"),
            str(t / "refused.json"), "--conf", props["t"], "--device", "cpu"]
    # plan.enable=true is the default plan path now: it runs, with the
    # hand-wired body's artifact
    for flag in ("true", "false"):
        tmain(["GradientBoostBuilder", str(t / "train.csv"),
               str(t / f"plan_{flag}.json"), "--conf", props["t"],
               "--device", "cpu", "-D", f"plan.enable={flag}"])
    capsys.readouterr()
    assert (t / "plan_true.json").read_bytes() == \
        (t / "plan_false.json").read_bytes()
    with pytest.raises(ValueError, match="learning_rate must be"):
        tmain(args + ["-D", "forest.boost.learning.rate=1.5"])
    with pytest.raises(ValueError, match="early.stop.rounds is not "
                       "supported by the streaming trainer"):
        tmain(["GradientBoostBuilder", str(t / "parts"),
               str(t / "refused.json"), "--conf", props["t"], "-D",
               "streaming.train=true", "-D",
               "forest.boost.early.stop.rounds=2", "--device", "cpu"])
    assert not (t / "refused.json").exists()
    # a bagged artifact on the boosted predict path, by kind
    (t / "bagged.json").write_text(json.dumps(
        {"format": 1, "kind": "bagged", "classValues": ["no", "yes"],
         "trees": []}))
    with pytest.raises(ValueError, match="'bagged' model.*'boosted' "
                       "predict path"):
        tmain(["GradientBoostPredictor", str(t / "test.csv"),
               str(t / "p.txt"), "--conf", props["t"], "-D",
               f"forest.boost.model.file.path={t / 'bagged.json'}",
               "--device", "cpu"])
