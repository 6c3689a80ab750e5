"""ReinforcementLearnerTopology on the port (``--device cpu``) against the
JAX CLI: for each of the ten learners the actions file and the JSON line
byte for byte, on bare and on stamped (``event.timestamps``) event
files, and exponentialWeight's at the sizes where its reward folds take
the fused path; the engine's keys refused by name; the JAX CLI's config
errors with its messages."""

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


@pytest.mark.parametrize("extra", [[], ["lifecycle.dir=reg"],
                                   ["broker.shards=localhost:1"]])
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
