"""The port's plan layer (``avenir_tpu_torch/plan``, ``cli/plans.py``)
against the JAX package's: the five plan-capable verbs byte for byte on
and off the plan, the staged-table cache across a chained job, the
fingerprints, the cache's LRU, and ``--explain``."""

import contextlib
import io
import json

import pytest
import torch

from avenir_tpu import plan as jplan
from avenir_tpu.cli.main import main as jmain
from avenir_tpu.datagen import generators as JG
from avenir_tpu.plan import fingerprint as JFP
from avenir_tpu.utils.config import JobConfig as JConf

from avenir_tpu_torch import plan as tplan
from avenir_tpu_torch.cli.main import main as tmain
from avenir_tpu_torch.plan import fingerprint as TFP
from avenir_tpu_torch.plan.cache import MISS, StagedTableCache, nbytes_of
from avenir_tpu_torch.utils.config import JobConfig as TConf

torch.set_num_threads(2)

_VERBS = {
    "BayesianDistribution": "train",
    "NearestNeighbor": "test",
    "MutualInformation": "train",
    "RandomForestBuilder": "train",
    "GradientBoostBuilder": "train",
}


@pytest.fixture(autouse=True)
def _cold_caches():
    tplan.reset_cache()
    jplan.reset_cache()
    yield
    tplan.reset_cache()
    jplan.reset_cache()


def _churn(tmp_path, n=300, split=220, **keys):
    rows = JG.churn_rows(n, seed=77)
    (tmp_path / "train.csv").write_text(
        "\n".join(",".join(r) for r in rows[:split]) + "\n")
    (tmp_path / "test.csv").write_text(
        "\n".join(",".join(r) for r in rows[split:]) + "\n")
    (tmp_path / "schema.json").write_text(json.dumps(JG._CHURN_SCHEMA_JSON))
    props = tmp_path / "job.properties"
    props.write_text("".join(f"{k}={v}\n" for k, v in {
        "field.delim.regex": ",", "field.delim": ",",
        "feature.schema.file.path": tmp_path / "schema.json",
        "train.data.path": tmp_path / "train.csv",
        "top.match.count": 5, "validation.mode": "true",
        "positive.class.value": "closed", "knn.mode": "exact",
        "num.trees": 3, "forest.boost.num.rounds": 3, "max.depth": 3,
        **keys}.items()))
    return str(props)


def _run(main, verb, tmp_path, out, props, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([verb, str(tmp_path / f"{_VERBS[verb]}.csv"), str(out),
              "--conf", props, *extra])
    return buf.getvalue()


@pytest.mark.parametrize("verb", sorted(_VERBS))
def test_plan_on_equals_plan_off_and_the_jax_cli(tmp_path, verb):
    """The default plan path, cold and warm, the hand-wired body
    (plan.enable=false) and the JAX CLI's default run: the same stdout and
    the same output file, byte for byte."""
    props = _churn(tmp_path)
    cpu = ("--device", "cpu")
    want = _run(jmain, verb, tmp_path, tmp_path / "j.out", props)
    assert jplan.last_run()["verb"] == verb
    outs = [_run(tmain, verb, tmp_path, tmp_path / "cold.out", props, *cpu)]
    assert tplan.last_run()["outcomes"] == jplan.last_run()["outcomes"]
    outs.append(_run(tmain, verb, tmp_path, tmp_path / "warm.out", props,
                     *cpu))
    assert tplan.last_run()["outcomes"]["stage:train"] == "hit"
    outs.append(_run(tmain, verb, tmp_path, tmp_path / "off.out", props,
                     "-D", "plan.enable=false", *cpu))
    assert outs == [want] * 3
    j_bytes = (tmp_path / "j.out").read_bytes()
    for name in ("cold", "warm", "off"):
        assert (tmp_path / f"{name}.out").read_bytes() == j_bytes, name


@pytest.mark.parametrize("keys", [
    {}, {"ingest.workers": "3", "ingest.split.bytes": "4000"},
    {"ingest.workers": "2", "ingest.split.bytes": "4000",
     "feed.chunk.rows": "16", "feed.depth": "3"}],
    ids=["serial", "parallel", "parallel-fed"])
def test_nb_then_knn_hits_as_the_jax_cli_does(tmp_path, keys):
    """BayesianDistribution then NearestNeighbor over the same train data:
    KNN skips encode:train and hits stage:train, node for node as the
    JAX CLI's last_run() reports, with the same split plans."""
    props = _churn(tmp_path, **keys)
    runs = {}
    for tag, main, plan, extra in (("j", jmain, jplan, ()),
                                   ("t", tmain, tplan, ("--device", "cpu"))):
        outs = []
        for verb in ("BayesianDistribution", "NearestNeighbor"):
            outs.append(_run(main, verb, tmp_path,
                             tmp_path / f"{tag}_{verb}.out", props, *extra))
            outs.append(plan.last_run())
        runs[tag] = outs
    j, t = runs["j"], runs["t"]
    assert [t[0], t[2]] == [j[0], j[2]]
    for lr_t, lr_j in ((t[1], j[1]), (t[3], j[3])):
        assert lr_t["outcomes"] == lr_j["outcomes"]
        assert set(lr_t.get("ingest", {})) == set(lr_j.get("ingest", {}))
        for tag, st in lr_t.get("ingest", {}).items():
            for key in ("parallel", "workers", "splits", "rows",
                        "consume_order"):
                assert st[key] == lr_j["ingest"][tag][key], (tag, key)
    assert t[3]["outcomes"]["encode:train"] == "skipped"
    assert t[3]["outcomes"]["stage:train"] == "hit"
    for verb in ("BayesianDistribution", "NearestNeighbor"):
        assert (tmp_path / f"t_{verb}.out").read_bytes() == \
            (tmp_path / f"j_{verb}.out").read_bytes()


@pytest.mark.parametrize("verb", sorted(_VERBS))
def test_a_table_staged_on_one_device_misses_for_another(tmp_path, verb):
    """The staged cache keys on the fingerprint and the device: after a
    CPU job, the same files planned for the card miss (a hit would hand
    the card's job the CPU's tensors), while the fingerprint that
    --explain prints is the same digest on both devices."""
    from avenir_tpu_torch.cli import plans as tplans
    from avenir_tpu_torch.plan import explain as texplain
    props = _churn(tmp_path)
    _run(tmain, "BayesianDistribution", tmp_path, tmp_path / "nb.out",
         props, "--device", "cpu")
    data = str(tmp_path / f"{_VERBS[verb]}.csv")
    plans = {dev: tplans.build_plan(verb, TConf.from_file(props), data,
                                    str(tmp_path / f"{verb}.out"),
                                    torch.device(dev))
             for dev in ("cpu", "cuda:0")}
    probes = {dev: texplain.probe(plan) for dev, plan in plans.items()}
    assert probes["cpu"]["stage:train"] == "hit"
    assert probes["cuda:0"]["stage:train"] == "miss"
    assert plans["cpu"].node("stage:train").fingerprint == \
        plans["cuda:0"].node("stage:train").fingerprint
    assert {n.cache_key for n in plans["cpu"].nodes if n.fingerprint}.\
        isdisjoint(n.cache_key for n in plans["cuda:0"].nodes)


def _fps(props, train, key=None, value=None, **kw):
    out = []
    for conf_cls, fp in ((JConf, JFP), (TConf, TFP)):
        conf = conf_cls.from_file(props)
        if key is not None:
            conf.set(key, value)
        out.append(fp.staged_table_fingerprint(
            conf, train, with_labels=True, **kw))
    return out


@pytest.mark.parametrize("key,value", [
    (None, None), ("on.bad.row", "skip"), ("on.bad.row", "quarantine"),
    ("max.bad.fraction", "0.5"), ("quarantine.dir", "/tmp/q"),
    ("unseen.value.handling", "other"), ("field.delim.regex", ";"),
    ("featurizer.fit.data.path", "FIT")])
def test_fingerprints_equal_the_jax_package(tmp_path, key, value):
    """Every digest equals the JAX package's for the same files and keys,
    and each encode-affecting key moves it."""
    props, train = _churn(tmp_path), str(tmp_path / "train.csv")
    if value == "FIT":
        value = str(tmp_path / "test.csv")
    base_j, base_t = _fps(props, train)
    got_j, got_t = _fps(props, train, key, value)
    assert base_t == base_j and got_t == got_j
    assert (got_t != base_t) == (key is not None)


def test_feed_and_content_change_fingerprints_as_jax(tmp_path):
    props, train = _churn(tmp_path), str(tmp_path / "train.csv")
    base = _fps(props, train)
    for kw in ({"feed_chunk_rows": 256}, {"bucketed": True},
               {"fit_fingerprint": base[0]}):
        j, t = _fps(props, train, **kw)
        assert j == t != base[1], kw
    with open(tmp_path / "schema.json", "a") as fh:
        fh.write("\n")
    j, t = _fps(props, train)
    assert j == t != base[1]
    with open(train, "a") as fh:
        fh.write("x\n")
    assert _fps(props, train)[1] not in (t, base[1])
    assert TFP.digest({"b": 1, "a": [1, "x"]}) == \
        JFP.digest({"b": 1, "a": [1, "x"]})


def test_changed_policy_misses_on_a_full_run(tmp_path):
    props = _churn(tmp_path)
    cpu = ("--device", "cpu")
    _run(tmain, "BayesianDistribution", tmp_path, tmp_path / "a", props, *cpu)
    _run(tmain, "BayesianDistribution", tmp_path, tmp_path / "b", props,
         "-D", "on.bad.row=skip", *cpu)
    assert tplan.last_run()["outcomes"]["stage:train"] == "miss"
    assert tplan.last_run()["outcomes"]["encode:train"] == "ran"


def test_cache_lru_budget_and_oversize():
    c = StagedTableCache(budget_bytes=3000)
    assert c.get("a") is MISS
    for key in "abc":
        assert c.put(key, torch.zeros(250))            # 1000 bytes each
    assert c.stats()["entries"] == 3
    assert c.get("a") is not MISS                      # a becomes MRU
    c.put("d", torch.zeros(250))                       # evicts b, the LRU
    assert not c.contains("b") and c.contains("a")
    assert c.stats()["evictions"] == 1
    assert not c.put("huge", torch.zeros(1000))        # over the budget
    assert c.stats()["oversize_skips"] == 1 and not c.contains("huge")
    c.set_budget(1500)                                 # shrink: evict LRU
    assert c.stats()["entries"] == 1 and c.contains("d")
    s = c.stats()
    assert (s["hits"], s["misses"]) == (1, 1)
    assert c.contains("d") and c.stats() == s          # no stats touched
    c.clear()
    assert c.stats()["entries"] == 0 and c.stats()["hits"] == 0


def test_nbytes_counts_tensors_on_any_device():
    t = torch.zeros((10, 4), dtype=torch.int32)
    assert nbytes_of(t) == 160
    assert nbytes_of({"a": t, "b": [t[:5]]}) >= 160 + 80
    assert nbytes_of(torch.zeros(3, dtype=torch.float64,
                                 device="meta")) == 24


@pytest.mark.parametrize("verb", ["MutualInformation", "RandomForestBuilder",
                                  "GradientBoostBuilder"])
def test_explain_equals_the_jax_cli(tmp_path, verb):
    """--explain's text and PATH.plan.json, letter for letter, with a
    fixed ingest.workers; a warm cache shows the same hits."""
    props = _churn(tmp_path, **{"ingest.workers": "4",
                                "ingest.split.bytes": "5000"})
    for warm in (False, True):
        outs = []
        for tag, main, extra in (("j", jmain, ()),
                                 ("t", tmain, ("--device", "cpu"))):
            outs.append(_run(main, verb, tmp_path, tmp_path / "o.txt", props,
                             "--explain", "--metrics-out",
                             str(tmp_path / tag), *extra))
            if not warm:
                _run(main, "BayesianDistribution", tmp_path,
                     tmp_path / f"{tag}.nb", props, *extra)
        assert outs[0] == outs[1]
        assert (tmp_path / "j.plan.json").read_text() == \
            (tmp_path / "t.plan.json").read_text()
        assert ("cache=hit" in outs[1]) == warm
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("verb,keys", [
    ("BayesianDistribution", {"tabular.input": "false"}),
    ("NearestNeighbor", {"prediction.mode": "regression"}),
    ("GradientBoostBuilder", {"streaming.train": "true"}),
    ("BayesianPredictor", {}),
    ("BayesianDistribution", {"plan.enable": "false"})])
def test_explain_refuses_non_plan_modes_as_jax(tmp_path, verb, keys):
    props = _churn(tmp_path, **keys)
    errors = []
    for main, extra in ((jmain, ()), (tmain, ("--device", "cpu"))):
        with pytest.raises(ValueError) as err:
            main([verb, str(tmp_path / "train.csv"), str(tmp_path / "o"),
                  "--conf", props, "--explain", *extra])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "--explain" in errors[1]
