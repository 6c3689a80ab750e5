"""Streamed and per-shard Naive Bayes and per-shard MutualInformation:
``naive_bayes.train_streamed`` against the in-memory train, and the CLI's
``streaming.train``, ``shard.parts`` and ``--resume`` paths against the
JAX CLI's files."""

import json
import os

import numpy as np
import pytest
import torch

from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG

from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.models import naive_bayes as tnb
from avenir_tpu_torch.utils.dataset import Featurizer
from avenir_tpu_torch.utils.schema import FeatureSchema

from _torch_parity import write_csv

torch.set_num_threads(2)

_SCHEMAS = {"churn": JG._CHURN_SCHEMA_JSON,
            "elearn": JG.elearn_schema_json(),
            "hosp": JG._HOSP_SCHEMA_JSON}
_ROWS = {"churn": lambda n, s: JG.churn_rows(n, seed=s),
         "elearn": lambda n, s: JG.elearn_rows(n, seed=s),
         "hosp": lambda n, s: JG.hosp_readmit_rows(n, seed=s)}


def _fixture(tmp_path, name, n, seed=11, parts=0, delim=","):
    """The rows in ``<name>.csv`` (``delim``-separated) and, with
    ``parts``, split over a part-file dir; a properties file naming the
    schema. Returns (input path, properties path)."""
    rows = _ROWS[name](n, seed)
    (tmp_path / "schema.json").write_text(json.dumps(_SCHEMAS[name]))
    props = tmp_path / "p.properties"
    props.write_text(f"feature.schema.file.path={tmp_path / 'schema.json'}\n"
                     f"field.delim.regex={delim}\nfield.delim=,\n")
    if not parts:
        (tmp_path / f"{name}.csv").write_text(
            "".join(delim.join(r) + "\n" for r in rows))
        return str(tmp_path / f"{name}.csv"), str(props)
    part_dir = tmp_path / f"{name}_parts"
    part_dir.mkdir()
    for i, chunk in enumerate(np.array_split(np.arange(n), parts)):
        write_csv(part_dir / f"part-{i:05d}", [rows[j] for j in chunk])
    write_csv(tmp_path / f"{name}.csv", rows)
    return str(part_dir), str(props)


def _mi_close(t_bytes, j_bytes):
    """Two MI files: the same lines and keys, each value within rtol 1e-5
    + atol 1e-6, the bar the merged jobs meet (``test_torch_explore.py``:
    the f32 score math rounds its last ulps otherwise)."""
    t_lines, j_lines = t_bytes.decode().splitlines(), \
        j_bytes.decode().splitlines()
    assert len(t_lines) == len(j_lines) > 0
    for t_line, j_line in zip(t_lines, j_lines):
        tf, jf = t_line.split(","), j_line.split(",")
        assert tf[:-1] == jf[:-1], (t_line, j_line)
        np.testing.assert_allclose(float(tf[-1]), float(jf[-1]), rtol=1e-5,
                                   atol=1e-6)


def _run(capsys, tag, args):
    """One CLI job through the JAX CLI (``j``) or the port (``t``);
    returns its stdout."""
    if tag == "j":
        jmain(args + ["-D", "plan.enable=false"])
    else:
        tmain(args + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("name,window", [("churn", 16 << 10),
                                         ("elearn", 8 << 10)])
def test_train_streamed_equals_in_memory(tmp_path, name, window):
    """Every count equal; the moments, float64 sums rounded once, equal
    the in-memory train's; the model file byte for byte."""
    path, _ = _fixture(tmp_path, name, 3000)
    fz = Featurizer(FeatureSchema.from_json(_SCHEMAS[name]), device="cpu")
    fz.fit([])
    rows = [line.split(",") for line in open(path).read().splitlines()]
    mem, mem_meta, _ = tnb.train(fz.transform(rows))
    st, st_meta, st_metrics = tnb.train_streamed(fz, path,
                                                 window_bytes=window,
                                                 device="cpu")
    assert st_meta == mem_meta
    assert st_metrics.to_json() == tnb.train(fz.transform(rows))[2].to_json()
    for field in ("class_counts", "post_counts", "prior_counts",
                  "cont_count", "cont_sum", "cont_sumsq"):
        assert torch.equal(getattr(st, field), getattr(mem, field)), field
    tnb.save_model(mem, mem_meta, str(tmp_path / "mem.txt"))
    tnb.save_model(st, st_meta, str(tmp_path / "st.txt"))
    assert (tmp_path / "st.txt").read_bytes() == (tmp_path / "mem.txt") \
        .read_bytes()


@pytest.mark.parametrize("name,delim", [("churn", ","), ("elearn", ","),
                                        ("churn", "::")])
def test_streaming_train_matches_the_jax_cli(tmp_path, capsys, name, delim):
    """``streaming.train=true`` over many windows (a two-byte delimiter
    takes the Python windows): model file and stdout equal the JAX CLI's
    and the port's in-memory train's."""
    path, props = _fixture(tmp_path, name, 2500, delim=delim)
    out = {}
    for tag, extra in (("j", ["-D", "streaming.train=true"]),
                       ("t", ["-D", "streaming.train=true"]), ("m", [])):
        out[tag] = _run(capsys, "j" if tag == "j" else "t", [
            "BayesianDistribution", path, str(tmp_path / f"{tag}.txt"),
            "--conf", props, "-D", "stream.window.bytes=8192", *extra])
        assert json.loads(out[tag].splitlines()[-1])[
            "Distribution Data.Records"] == 2500
    assert out["t"] == out["j"] == out["m"]
    model = (tmp_path / "t.txt").read_bytes()
    assert model == (tmp_path / "j.txt").read_bytes()
    assert model == (tmp_path / "m.txt").read_bytes()


def test_streaming_train_needs_a_fit_without_the_stream(tmp_path):
    path, props = _fixture(tmp_path, "churn", 50)
    schema = dict(_SCHEMAS["churn"])
    schema["fields"] = [dict(f) for f in schema["fields"]]
    for f in schema["fields"]:
        f.pop("cardinality", None)
    (tmp_path / "schema.json").write_text(json.dumps(schema))
    with pytest.raises(ValueError, match="featurizer.fit.data.path"):
        tmain(["BayesianDistribution", path, str(tmp_path / "o.txt"),
               "--conf", props, "-D", "streaming.train=true",
               "--device", "cpu"])
    tmain(["BayesianDistribution", path, str(tmp_path / "o.txt"),
           "--conf", props, "-D", "streaming.train=true", "-D",
           f"featurizer.fit.data.path={path}", "--device", "cpu"])
    assert (tmp_path / "o.txt").read_text()


def _sharded(tmp_path, capsys, verb, name, n, parts, extra=()):
    """The verb over a part dir with ``shard.parts=true``, through both
    CLIs, and the port's merged job over the same rows; returns the
    three outputs' bytes and stdouts."""
    path, props = _fixture(tmp_path, name, n, parts=parts)
    got = {}
    for tag, src, keys in (
            ("j", path, ["-D", "shard.parts=true", *extra]),
            ("t", path, ["-D", "shard.parts=true", *extra]),
            ("m", str(tmp_path / f"{name}.csv"), [])):
        out = _run(capsys, "j" if tag == "j" else "t", [
            verb, src, str(tmp_path / f"{tag}.txt"), "--conf", props, *keys])
        got[tag] = ((tmp_path / f"{tag}.txt").read_bytes(), out)
    return got, path, props


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_nb_shard_parts_match_the_jax_cli(tmp_path, capsys, name):
    """The per-shard train's model file and stdout equal the JAX CLI's
    and the merged train's; the journal is gone after the run."""
    got, path, _ = _sharded(tmp_path, capsys, "BayesianDistribution", name,
                            2400, 4)
    assert got["t"] == got["j"] == got["m"]
    assert not os.path.exists(tmp_path / "t.txt.shards")


def test_mi_shard_parts_match_the_jax_cli(tmp_path, capsys):
    """The per-shard MI output equals the port's merged job's byte for
    byte and the JAX CLI's per-shard output as the merged jobs agree."""
    got, _, _ = _sharded(tmp_path, capsys, "MutualInformation", "hosp",
                         2400, 4)
    assert got["t"] == got["m"]
    assert got["t"][1] == got["j"][1]
    _mi_close(got["t"][0], got["j"][0])


@pytest.mark.parametrize("verb,name", [("BayesianDistribution", "churn"),
                                       ("MutualInformation", "hosp")])
def test_resume_after_a_dropped_shard_matches_the_jax_cli(tmp_path, capsys,
                                                          verb, name):
    """A job with its journal kept, one shard's commit dropped, then
    ``--resume``: the port recounts that shard alone, and the output and
    the shard report equal the JAX CLI's doing the same."""
    path, props = _fixture(tmp_path, name, 2000, parts=4)
    got = {}
    for tag in ("j", "t"):
        out = str(tmp_path / f"{tag}.txt")
        _run(capsys, tag, [verb, path, out, "--conf", props, "-D",
                           "shard.parts=true", "-D",
                           "shard.journal.keep=true"])
        first = (tmp_path / f"{tag}.txt").read_bytes()
        os.remove(tmp_path / f"{tag}.txt.shards" / "shard-00002.json")
        stdout = _run(capsys, tag, [verb, path, out, "--conf", props,
                                    "-D", "shard.parts=true", "--resume"])
        got[tag] = (first, (tmp_path / f"{tag}.txt").read_bytes(), stdout)
        assert not os.path.exists(tmp_path / f"{tag}.txt.shards")
    first, resumed, stdout = got["t"]
    assert resumed == first and stdout == got["j"][2]
    if verb == "BayesianDistribution":
        assert got["t"] == got["j"]
    else:
        _mi_close(resumed, got["j"][1])
    report = json.loads(stdout.splitlines()[-1])
    assert (report["shards_total"], report["shards_resumed"],
            report["shards_computed"]) == (4, 3, 1)


@pytest.mark.parametrize("verb,name", [("BayesianDistribution", "churn"),
                                       ("MutualInformation", "hosp")])
def test_resume_on_one_file_takes_the_merged_path(tmp_path, capsys, verb,
                                                  name):
    """``--resume`` on a single input file changes nothing: the JAX CLI
    falls through to its merged path, and so does the port."""
    path, props = _fixture(tmp_path, name, 800)
    got = {}
    for tag, extra in (("j", ["--resume"]), ("t", ["--resume"]), ("m", [])):
        stdout = _run(capsys, "j" if tag == "j" else "t", [
            verb, path, str(tmp_path / f"{tag}.txt"), "--conf", props,
            *extra])
        got[tag] = ((tmp_path / f"{tag}.txt").read_bytes(), stdout)
    assert got["t"] == got["m"] and got["t"][1] == got["j"][1]
    if verb == "BayesianDistribution":
        assert got["t"] == got["j"]
    else:
        _mi_close(got["t"][0], got["j"][0])
    assert not os.path.exists(tmp_path / "t.txt.shards")


def test_shard_parts_needs_the_journal(tmp_path):
    path, props = _fixture(tmp_path, "churn", 400, parts=2)
    with pytest.raises(ValueError, match="shard.journal=true"):
        tmain(["BayesianDistribution", path, str(tmp_path / "o.txt"),
               "--conf", props, "-D", "shard.parts=true", "-D",
               "shard.journal=false", "--device", "cpu"])
