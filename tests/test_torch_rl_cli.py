"""ReinforcementLearnerTopology on the port (``--device cpu``) against the
JAX CLI: for each of the ten learners the actions file and the JSON line
byte for byte, on bare and on stamped (``event.timestamps``) event
files, and exponentialWeight's at the sizes where its reward folds take
the fused path; the same with ``serving.engine=true`` (the JSON line but
its ``overlap_fraction``), with the admission gate and with a snapshot
registry (``lifecycle.dir``); the ``Lifecycle`` verb's five commands;
the broker fleet refused by name; the JAX CLI's config errors with its
messages."""

import json
import os

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.datagen import LeadGenSimulator

torch.set_num_threads(2)

TYPES = ["intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
         "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
         "softMax", "actionPursuit", "rewardComparison", "exponentialWeight"]
EVENTS = 200


def write_inputs(d, n_events=EVENTS, stamped=False):
    """The tutorial's shape: session ids over the three lead-generation
    actions, a reward file of ``LeadGenSimulator`` rewards for a quarter
    of them, and the properties."""
    sim = LeadGenSimulator(sel_count_threshold=1, seed=3)
    rng = np.random.default_rng(0)
    with open(d / "events.txt", "w") as fh:
        for i in range(n_events):
            stamp = f"|{1700000000 + i * 0.5}" if stamped else ""
            fh.write(f"session{i:08d}{stamp}\n")
    with open(d / "rewards.txt", "w") as fh:
        for _ in range(n_events // 4):
            action, reward = sim.observe_action(
                sim.actions[int(rng.integers(0, 3))])
            fh.write(f"{action},{reward}\n")
    (d / "p.properties").write_text(
        f"action.list={','.join(sim.actions)}\n"
        f"reward.data.path={d / 'rewards.txt'}\nrandom.seed=7\n"
        "min.sample.size=3\nmin.reward.distr.sample=2\n")


def run_both(d, capsys, *extra, events="events.txt", own=()):
    """The JAX CLI and the port's on the same inputs: (JSON lines, actions
    files) of each. Each key of ``own`` gets a path of each package's own
    (``<d>/<tag>-<value>``)."""
    out = []
    for tag, fn, dev in (("j", jmain, []), ("t", tmain,
                                            ["--device", "cpu"])):
        mine = [a for key, value in own
                for a in ("-D", f"{key}={d / f'{tag}-{value}'}")]
        assert fn(["ReinforcementLearnerTopology", str(d / events),
                   str(d / f"{tag}.txt"), "--conf", str(d / "p.properties"),
                   *extra, *mine, *dev]) == 0
        out.append((capsys.readouterr().out, (d / f"{tag}.txt").read_bytes()))
    return out


@pytest.mark.parametrize("stamped", [False, True])
@pytest.mark.parametrize("learner_type", TYPES)
def test_actions_and_json_line_byte_identical(tmp_path, capsys, learner_type,
                                              stamped):
    write_inputs(tmp_path, stamped=stamped)
    extra = ["-D", f"learner.type={learner_type}"]
    if stamped:
        extra += ["-D", "event.timestamps=true"]
    (j_line, j_file), (t_line, t_file) = run_both(tmp_path, capsys, *extra)
    assert t_line == j_line == (f'{{"events": {EVENTS}, "rewards": '
                                f'{EVENTS // 4}, "actions": {EVENTS}}}\n')
    assert t_file == j_file
    assert t_file.decode().splitlines()[0].startswith("session00000000,")


@pytest.mark.parametrize("n_events", [1024, 4096])
def test_exponential_weight_fused_folds_byte_identical(tmp_path, capsys,
                                                      n_events):
    """exponentialWeight where the verb folds its rewards through EXP3's
    fused path: 256 and 1,024 rewards (one and four fused chunks of 256,
    phase 14's shape at 4,096 events)."""
    write_inputs(tmp_path, n_events=n_events)
    (j_line, j_file), (t_line, t_file) = run_both(
        tmp_path, capsys, "-D", "learner.type=exponentialWeight")
    assert t_line == j_line == (f'{{"events": {n_events}, "rewards": '
                                f'{n_events // 4}, "actions": {n_events}}}\n')
    assert t_file == j_file


@pytest.mark.parametrize("keys,message", [
    ({"action.list": ""}, "action.list must name the candidate actions"),
    ({"serving.engine": "true", "checkpoint.dir": "ck"},
     "serving.engine=true does not use checkpoint.dir"),
    ({"lifecycle.dir": "reg"}, "lifecycle.dir is the engine's durability"),
    ({"broker.shards": "localhost:1"}, "broker.shards needs serving.engine")])
def test_config_errors_carry_the_jax_clis_messages(tmp_path, keys, message):
    write_inputs(tmp_path, n_events=4)
    args = [f"{k}={v}" for k, v in dict({"learner.type": "softMax"},
                                        **keys).items()]
    for fn, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=message):
            fn(["ReinforcementLearnerTopology", str(tmp_path / "events.txt"),
                str(tmp_path / "o.txt"), "--conf",
                str(tmp_path / "p.properties")]
               + [a for kv in args for a in ("-D", kv)] + dev)


@pytest.mark.parametrize("extra", [["broker.shards=localhost:1"]])
def test_the_engine_is_refused_by_name(tmp_path, extra):
    write_inputs(tmp_path, n_events=4)
    keys = ["learner.type=softMax", "serving.engine=true", *extra]
    with pytest.raises(ValueError, match=(
            r"serving\.engine=true.*ROADMAP queue A, 'Bandits and "
            r"streaming serving'")) as err:
        tmain(["ReinforcementLearnerTopology", str(tmp_path / "events.txt"),
               str(tmp_path / "o.txt"), "--conf",
               str(tmp_path / "p.properties"), "--device", "cpu"]
              + [a for kv in keys for a in ("-D", kv)])
    for key in extra:
        assert key in str(err.value)
    assert not (tmp_path / "o.txt").exists()


# -- serving.engine=true and the Lifecycle verb ------------------------------

ENGINE = ("-D", "serving.engine=true")


def _engine_line(line):
    """The JSON line with its ``overlap_fraction`` (a host-time ratio)
    checked in [0, 1] and taken out."""
    out = json.loads(line)
    assert 0.0 <= out.pop("overlap_fraction") <= 1.0
    return out


@pytest.mark.parametrize("learner_type", TYPES)
def test_engine_actions_byte_identical_to_jax_and_to_the_loop(
        tmp_path, capsys, learner_type):
    write_inputs(tmp_path)
    extra = ["-D", f"learner.type={learner_type}"]
    (j_line, j_file), (t_line, t_file) = run_both(tmp_path, capsys, *extra,
                                                  *ENGINE)
    assert list(json.loads(t_line)) == [
        "events", "rewards", "actions", "overlap_fraction", "batches"]
    assert _engine_line(t_line) == _engine_line(j_line) == {
        "events": EVENTS, "rewards": EVENTS // 4, "actions": EVENTS,
        "batches": -(-EVENTS // 64)}
    assert t_file == j_file
    # the engine's file is the loop's (the parity contract)
    assert tmain(["ReinforcementLearnerTopology",
                  str(tmp_path / "events.txt"), str(tmp_path / "loop.txt"),
                  "--conf", str(tmp_path / "p.properties"), *extra,
                  "--device", "cpu"]) == 0
    assert (tmp_path / "loop.txt").read_bytes() == t_file


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest"])
def test_engine_admission_gate_equals_jax(tmp_path, capsys, policy):
    """``engine.admission.high`` sheds with exact accounting: shed_total
    + events = the events produced, as the JAX CLI counts them."""
    write_inputs(tmp_path, n_events=1000)
    (j_line, j_file), (t_line, t_file) = run_both(
        tmp_path, capsys, "-D", "learner.type=softMax", *ENGINE,
        "-D", "engine.admission.high=200", "-D", "engine.shed.chunk=64",
        "-D", f"engine.shed.policy={policy}", "-D", "event.timestamps=true",
        events="events.txt")
    t = _engine_line(t_line)
    assert t == _engine_line(j_line)
    assert t["shed_total"] > 0 and t["shed_total"] + t["events"] == 1000
    assert t_file == j_file


def _manifests(reg):
    """Each version's manifest without ``created_at``, the payloads' leaves
    and ``LATEST``."""
    out = {}
    for name in sorted(os.listdir(reg)):
        path = os.path.join(reg, name)
        if name == "LATEST":
            out[name] = open(path).read()
            continue
        m = json.load(open(os.path.join(path, "manifest.json")))
        m.pop("created_at")
        leaves = {}
        if os.path.exists(os.path.join(path, "payload.npz")):
            with np.load(os.path.join(path, "payload.npz")) as zf:
                leaves = {k: (zf[k].dtype.str, zf[k].tolist())
                          for k in zf.files}
        out[name] = (m, leaves)
    return out


@pytest.mark.parametrize("learner_type", ["softMax", "exponentialWeight",
                                          "upperConfidenceBoundTwo"])
def test_engine_lifecycle_dir_restores_and_publishes_as_jax(
        tmp_path, capsys, learner_type):
    """Two runs over one registry each: the second restores the head the
    first published; the registries' files equal but ``created_at``, and
    a registry the JAX CLI wrote restores in the port's engine."""
    write_inputs(tmp_path)
    extra = ("-D", f"learner.type={learner_type}", *ENGINE,
             "-D", "lifecycle.max.keep=3")
    for version in (1, 2):
        (j_line, j_file), (t_line, t_file) = run_both(
            tmp_path, capsys, *extra, own=[("lifecycle.dir", "reg")])
        assert _engine_line(t_line) == _engine_line(j_line)
        assert json.loads(t_line)["lifecycle_version"] == version
        assert t_file == j_file
    assert _manifests(tmp_path / "t-reg") == _manifests(tmp_path / "j-reg")
    # the JAX CLI's registry, head and all, serves the port's third run
    tmain(["ReinforcementLearnerTopology", str(tmp_path / "events.txt"),
           str(tmp_path / "t3.txt"), "--conf", str(tmp_path / "p.properties"),
           *extra, "-D", f"lifecycle.dir={tmp_path / 'j-reg'}",
           "--device", "cpu"])
    tmain(["ReinforcementLearnerTopology", str(tmp_path / "events.txt"),
           str(tmp_path / "t4.txt"), "--conf", str(tmp_path / "p.properties"),
           *extra, "-D", f"lifecycle.dir={tmp_path / 't-reg'}",
           "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[0])[
        "lifecycle_version"] == 3
    assert (tmp_path / "t3.txt").read_bytes() == \
        (tmp_path / "t4.txt").read_bytes()


@pytest.mark.parametrize("head,message", [
    ("artifact", "is a file artifact"),
    ("other", "was published for a different learner shape")])
def test_engine_refuses_a_head_it_cannot_restore(tmp_path, capsys, head,
                                                 message):
    write_inputs(tmp_path, n_events=8)
    reg = tmp_path / "reg"
    if head == "artifact":
        assert tmain(["Lifecycle", str(tmp_path / "events.txt"),
                      str(tmp_path / "o.txt"), "--conf",
                      str(tmp_path / "p.properties"), "-D",
                      f"lifecycle.dir={reg}", "-D",
                      "lifecycle.command=publish", "--device", "cpu"]) == 0
    else:
        assert tmain(["ReinforcementLearnerTopology",
                      str(tmp_path / "events.txt"), str(tmp_path / "o.txt"),
                      "--conf", str(tmp_path / "p.properties"), "-D",
                      "learner.type=softMax", *ENGINE, "-D",
                      "action.list=a,b", "-D", "reward.data.path=",
                      "-D", f"lifecycle.dir={reg}",
                      "--device", "cpu"]) == 0
    args = ["-D", "learner.type=softMax", *ENGINE, "-D",
            f"lifecycle.dir={reg}"]
    for fn, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=message):
            fn(["ReinforcementLearnerTopology", str(tmp_path / "events.txt"),
                str(tmp_path / "o.txt"), "--conf",
                str(tmp_path / "p.properties"), *args, *dev])


def _lifecycle_both(d, capsys, command, in_path, *extra):
    """The Lifecycle verb's ``command`` on each package's registry
    (``<d>/j-reg``, ``<d>/t-reg``): the JSON lines, and the output files
    parsed without ``created_at``."""
    out = []
    for tag, fn, dev in (("j", jmain, []), ("t", tmain,
                                            ["--device", "cpu"])):
        path = d / f"{tag}-{command}.txt"
        assert fn(["Lifecycle", str(in_path), str(path), "--conf",
                   str(d / "p.properties"), "-D",
                   f"lifecycle.dir={d / f'{tag}-reg'}", "-D",
                   f"lifecycle.command={command}", *extra, *dev]) == 0
        text = path.read_text() if path.exists() else ""
        docs = [json.loads(line) for line in text.splitlines() if line]
        for doc in docs:
            doc.pop("created_at")
            if "source_file" in doc:
                doc["source_file"] = os.path.basename(doc["source_file"])
        out.append((capsys.readouterr().out, docs))
    return out


def test_lifecycle_verb_commands_equal_jax(tmp_path, capsys):
    """publish, retrain (twice), list, show and prune: the JSON lines and
    the files of the JAX CLI's, ``created_at`` aside; the retrained
    payloads equal leaf for leaf."""
    write_inputs(tmp_path)
    model = tmp_path / "model.txt"
    model.write_text("open,1,low,237\n")
    steps = [("publish", model, ()),
             ("retrain", tmp_path / "rewards.txt",
              ("-D", "learner.type=exponentialWeight")),
             ("retrain", tmp_path / "rewards.txt",
              ("-D", "learner.type=sampsonSampler")),
             ("list", model, ()), ("show", model, ()),
             ("prune", model, ("-D", "lifecycle.max.keep=2")),
             ("list", model, ())]
    for command, in_path, extra in steps:
        (j_line, j_docs), (t_line, t_docs) = _lifecycle_both(
            tmp_path, capsys, command, in_path, *extra)
        assert t_line == j_line, command
        assert t_docs == j_docs, command
    assert _manifests(tmp_path / "t-reg") == _manifests(tmp_path / "j-reg")
    assert sorted(os.listdir(tmp_path / "t-reg")) == [
        "LATEST", "v0000002", "v0000003"]
