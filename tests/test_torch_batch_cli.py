"""The port's UnderSamplingBalancer, BaggingSampler and Projection verbs
against the JAX CLI, byte for byte, and ``utils/projection.py``'s two
passes against each other and the JAX module."""

import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG
from avenir_tpu.utils import projection as jproj

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.utils import projection as tproj

from _torch_parity import write_csv

torch.set_num_threads(2)


def _props(path, **kv):
    path.write_text("".join(f"{k}={v}\n" for k, v in kv.items()))
    return str(path)


def _both(tmp_path, capsys, args_of):
    """The job through the JAX CLI and the port on the CPU; returns the
    two outputs' bytes and stdouts."""
    got = {}
    for tag, fn, extra in (("j", jmain, ["-D", "plan.enable=false"]),
                           ("t", tmain, ["--device", "cpu"])):
        fn(args_of(str(tmp_path / f"{tag}.txt")) + extra)
        got[tag] = ((tmp_path / f"{tag}.txt").read_bytes(),
                    capsys.readouterr().out)
    return got


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("extra", [
    (), ("-D", "streaming.bootstrap=true", "-D", "distr.batch.size=500"),
    ("-D", "streaming.bootstrap=true")])
def test_under_sampling_matches_the_jax_cli(tmp_path, capsys, seed, extra):
    write_csv(tmp_path / "churn.csv", JG.churn_rows(3000, seed=seed + 3))
    props = _props(tmp_path / "u.properties", **{
        "class.attr.ord": 6, "field.delim.regex": ",",
        "random.seed": seed})
    got = _both(tmp_path, capsys, lambda out: [
        "UnderSamplingBalancer", str(tmp_path / "churn.csv"), out,
        "--conf", props, *extra])
    assert got["t"] == got["j"]
    kept = got["t"][0].decode().splitlines()
    assert 0 < len(kept) < 3000
    # the minority class survives whole in exact mode
    if not extra:
        labels = [line.split(",")[6] for line in kept]
        counts = sorted(labels.count(v) for v in set(labels))
        assert counts[-1] <= 1.25 * counts[0]


@pytest.mark.parametrize("n,batch", [(2000, 500), (2345, 500), (300, 10000)])
def test_bagging_matches_the_jax_cli(tmp_path, capsys, n, batch):
    write_csv(tmp_path / "churn.csv", JG.churn_rows(n, seed=5))
    props = _props(tmp_path / "b.properties", **{
        "batch.size": batch, "random.seed": 9})
    got = _both(tmp_path, capsys, lambda out: [
        "BaggingSampler", str(tmp_path / "churn.csv"), out, "--conf", props])
    assert got["t"] == got["j"]
    assert len(got["t"][0].decode().splitlines()) == n


_BUY = {"field.delim.regex": ",", "field.delim.out": ",",
        "projection.operation": "groupingOrdering", "key.field": 0,
        "orderBy.field": 2, "projection.field": "2,3",
        "format.compact": "true"}


@pytest.mark.parametrize("extra", [
    {}, {"orderBy.numeric": "false"}, {"orderBy.numeric": "true"},
    {"format.compact": "false", "projection.field": "1,3"},
    {"field.delim.out": ";"}])
@pytest.mark.parametrize("part_dir", [False, True])
def test_projection_matches_the_jax_cli(tmp_path, capsys, extra, part_dir):
    """The tutorial's buyhist projection of buy_xaction rows: one file
    takes the native pass, a part-file dir the Python pass; day numbers in
    numeric and in lexicographic order."""
    rows = JG.buy_xaction_rows(400, 150, 0.05, seed=9)
    if part_dir:
        (tmp_path / "in").mkdir()
        write_csv(tmp_path / "in" / "part-00000", rows[:len(rows) // 2])
        write_csv(tmp_path / "in" / "part-00001", rows[len(rows) // 2:])
        src = str(tmp_path / "in")
    else:
        write_csv(tmp_path / "in.csv", rows)
        src = str(tmp_path / "in.csv")
    props = _props(tmp_path / "buyhist.properties", **{**_BUY, **extra})
    got = _both(tmp_path, capsys, lambda out: ["Projection", src, out,
                                               "--conf", props])
    assert got["t"] == got["j"]
    assert got["t"][0]


@pytest.mark.parametrize("numeric", [None, True, False])
@pytest.mark.parametrize("compact", [True, False])
def test_projection_native_equals_python(tmp_path, numeric, compact):
    """``project_file``'s native pass and its Python pass write the same
    bytes, and the JAX module's Python pass too."""
    rows = JG.buy_xaction_rows(300, 120, 0.06, seed=4)
    write_csv(tmp_path / "in.csv", rows)
    outs = {}
    for tag, fn, force in (("native", tproj.project_file, False),
                           ("python", tproj.project_file, True),
                           ("jax", jproj.project_file, True)):
        fn(str(tmp_path / "in.csv"), str(tmp_path / f"{tag}.txt"), 0, 2,
           [2, 3], compact=compact, numeric_order=numeric,
           force_python=force)
        outs[tag] = (tmp_path / f"{tag}.txt").read_bytes()
    assert outs["native"] == outs["python"] == outs["jax"]
    assert tproj.grouping_ordering(
        [r[:] for r in rows], 0, 2, [3], compact, numeric) == \
        jproj.grouping_ordering([r[:] for r in rows], 0, 2, [3], compact,
                                numeric)


def test_projection_refuses_what_the_jax_cli_refuses(tmp_path):
    write_csv(tmp_path / "in.csv", [["a", "2", "x"], ["a", "z", "y"]])
    props = _props(tmp_path / "p.properties", **{
        "projection.operation": "grouping"})
    with pytest.raises(ValueError, match="unsupported projection.operation"):
        tmain(["Projection", str(tmp_path / "in.csv"),
               str(tmp_path / "o.txt"), "--conf", props, "--device", "cpu"])
    for force in (False, True):
        with pytest.raises(ValueError, match="numeric ordering requested"):
            tproj.project_file(str(tmp_path / "in.csv"),
                               str(tmp_path / "o.txt"), 0, 1, [2],
                               numeric_order=True, force_python=force)
