"""ReinforcementLearnerTopology with ``checkpoint.dir`` on the port
(``--device cpu``) against the JAX CLI, for each of the ten learners: the
first run and a rerun over the same directory with more events (the
event lines already served skipped, no reward folded twice), actions
files and JSON lines byte for byte; and the job-level retry budget does
not rerun the verb."""

import pytest
import torch

from test_torch_rl_cli import EVENTS, TYPES, run_both, write_inputs

from avenir_tpu_torch.cli import main as tcli

torch.set_num_threads(2)


@pytest.mark.parametrize("learner_type", TYPES)
def test_checkpoint_resume_byte_identical(tmp_path, capsys, learner_type):
    write_inputs(tmp_path)
    with open(tmp_path / "events.txt") as fh:
        lines = fh.read()
    with open(tmp_path / "more.txt", "w") as fh:
        fh.write(lines + "".join(f"later{i:04d}\n" for i in range(70)))
    for tag, events in (("first", "events.txt"), ("resume", "more.txt")):
        (j_line, j_file), (t_line, t_file) = run_both(
            tmp_path, capsys, "-D", f"learner.type={learner_type}",
            "-D", "checkpoint.interval=50", events=events,
            own=[("checkpoint.dir", "ck")])
        assert t_line == j_line and t_file == j_file, tag
    assert t_line == (f'{{"events": {EVENTS + 70}, "rewards": '
                      f'{EVENTS // 4}, "actions": {EVENTS + 70}}}\n')
    assert t_file.decode().splitlines()[0].startswith("later0000,")


def test_the_verb_is_not_retried():
    assert tcli.run_reinforcement_learner.retry_safe is False
