"""Port substrate against the JAX package: schema, config, featurization,
metrics, logging, generators, the chunked feed and the interop carriers."""

import json
import logging

import numpy as np
import pytest
import torch

from avenir_tpu.datagen import generators as JG
from avenir_tpu.utils import config as jconfig
from avenir_tpu.utils.dataset import normalize_numeric as j_normalize
from avenir_tpu.utils.dataset import part_file_paths as j_parts
from avenir_tpu.utils.dataset import read_csv_lines as j_read
from avenir_tpu.utils.metrics import ConfusionMatrix as JCM
from avenir_tpu.utils.schema import FeatureSchema as JSchema

from avenir_tpu_torch import interop
from avenir_tpu_torch.datagen import generators as TG
from avenir_tpu_torch.parallel.pipeline import DeviceFeed
from avenir_tpu_torch.utils import config as tconfig
from avenir_tpu_torch.utils import profiling
from avenir_tpu_torch.utils.dataset import Featurizer as TFeaturizer
from avenir_tpu_torch.utils.dataset import normalize_numeric as t_normalize
from avenir_tpu_torch.utils.dataset import part_file_paths as t_parts
from avenir_tpu_torch.utils.dataset import read_csv_lines as t_read
from avenir_tpu_torch.utils.metrics import ConfusionMatrix as TCM
from avenir_tpu_torch.utils.metrics import MetricsRegistry
from avenir_tpu_torch.utils.schema import FeatureSchema as TSchema

from _torch_parity import fixture, tables

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 42])
def test_generators_give_the_same_rows(seed):
    assert TG.churn_rows(700, seed=seed) == JG.churn_rows(700, seed=seed)
    assert TG.elearn_rows(300, seed=seed) == JG.elearn_rows(300, seed=seed)
    assert TG.elearn_schema_json() == JG.elearn_schema_json()
    assert TG._CHURN_SCHEMA_JSON == JG._CHURN_SCHEMA_JSON


@pytest.mark.parametrize("name", ["churn", "elearn"])
def test_schema_copy_matches(name):
    schema_json, _ = fixture(name, 1, 0)
    js, ts = JSchema.from_json(schema_json), TSchema.from_json(schema_json)
    assert [vars(f) for f in js.fields] == [vars(f) for f in ts.fields]
    assert ([f.ordinal for f in js.get_feature_fields()]
            == [f.ordinal for f in ts.get_feature_fields()])
    assert js.find_class_attr_field().name == ts.find_class_attr_field().name
    assert js.dist_algorithm == ts.dist_algorithm


def test_config_parse_matches():
    text = ("# c\nfield.delim=,\nnum.reducer=1\nnum.reducer=3\n"
            "a.list = x, y ,z\nflag=True\n! bang\nratio:0.25\n")
    j, t = jconfig.JobConfig.from_string(text), tconfig.JobConfig.from_string(
        text)
    assert j.as_dict() == t.as_dict()
    assert t.get_int("num.reducer") == 3 and t.get_bool("flag")
    assert t.get_list("a.list") == ["x", "y", "z"]
    assert t.get_float("ratio") == 0.25


@pytest.mark.parametrize("name,seed", [("churn", 3), ("elearn", 4)])
def test_featurizer_transform_identical(name, seed):
    j_train, j_test, t_train, t_test = tables(name, 600, 200, seed=seed)
    for jt, tt in ((j_train, t_train), (j_test, t_test)):
        assert np.array_equal(np.asarray(jt.binned), tt.binned.numpy())
        assert np.array_equal(np.asarray(jt.numeric), tt.numeric.numpy())
        assert np.array_equal(np.asarray(jt.labels), tt.labels.numpy())
        assert jt.ids == tt.ids
        assert jt.bin_labels == tt.bin_labels
        assert jt.norm_min == tt.norm_min and jt.norm_max == tt.norm_max
        assert jt.bins_per_feature == tt.bins_per_feature
        assert jt.is_continuous == tt.is_continuous
        assert jt.class_values == tt.class_values
        # normalize_numeric, zero-span -> 1 rule included: bit-identical
        assert np.array_equal(np.asarray(j_normalize(jt)),
                              t_normalize(tt).numpy())


def test_zero_span_normalizes_with_unit_span():
    schema = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "v", "ordinal": 1, "dataType": "double", "min": 3.0,
         "max": 3.0, "feature": True},
        {"name": "c", "ordinal": 2, "dataType": "categorical",
         "cardinality": ["a", "b"], "classAttribute": True}]}
    rows = [["r0", "3.0", "a"], ["r1", "5.0", "b"]]
    from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
    jt = JFeaturizer(JSchema.from_json(schema)).fit_transform(rows)
    tt = TFeaturizer(TSchema.from_json(schema), device="cpu").fit_transform(
        rows)
    assert np.array_equal(np.asarray(j_normalize(jt)), t_normalize(tt).numpy())
    assert t_normalize(tt)[:, 0].tolist() == [0.0, 2.0]


@pytest.mark.parametrize("kind", ["feature", "class"])
def test_unseen_value_raises_the_same_error(kind):
    schema_json, rows = fixture("churn", 50, 5)
    bad = list(rows[0])
    if kind == "feature":
        bad[1] = "enormous"
    else:
        bad[6] = "frozen"
    from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
    jfz = JFeaturizer(JSchema.from_json(schema_json)).fit(rows)
    tfz = TFeaturizer(TSchema.from_json(schema_json), device="cpu").fit(rows)
    with pytest.raises(KeyError) as j_err:
        jfz.transform([bad])
    with pytest.raises(KeyError) as t_err:
        tfz.transform([bad])
    assert str(j_err.value) == str(t_err.value)


def test_oov_mode_and_data_vocabulary():
    schema = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "color", "ordinal": 1, "dataType": "categorical",
         "feature": True},
        {"name": "y", "ordinal": 2, "dataType": "categorical"}]}
    rows = [["a", "red", "p"], ["b", "blue", "q"], ["c", "red", "q"]]
    from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
    jfz = JFeaturizer(JSchema.from_json(schema), unseen="oov").fit(rows)
    tfz = TFeaturizer(TSchema.from_json(schema), unseen="oov",
                      device="cpu").fit(rows)
    probe = rows + [["d", "green", "p"]]
    jt, tt = jfz.transform(probe), tfz.transform(probe)
    assert np.array_equal(np.asarray(jt.binned), tt.binned.numpy())
    assert jt.bin_labels == tt.bin_labels
    assert tfz.schema_data_dependent == jfz.schema_data_dependent


@pytest.mark.parametrize("positive", [None, "closed"])
def test_confusion_report_json_identical(positive):
    rng = np.random.default_rng(9)
    pred = rng.integers(-1, 3, 400)
    truth = rng.integers(0, 2, 400)
    jcm, tcm = JCM(["open", "closed"], positive), TCM(["open", "closed"],
                                                      positive)
    jcm.update(pred, truth)
    tcm.update(torch.from_numpy(pred), torch.from_numpy(truth))
    assert np.array_equal(jcm.matrix, tcm.matrix)
    assert jcm.report().to_json() == tcm.report().to_json()
    with pytest.raises(ValueError, match="outside"):
        tcm.update(pred, truth, strict=True)


def test_metrics_registry():
    reg = MetricsRegistry()
    reg.incr("Validation", "Total", 2)
    reg.set("Distribution Data", "Records", 7)
    assert json.loads(reg.to_json()) == {"Distribution Data.Records": 7.0,
                                         "Validation.Total": 2.0}


def test_csv_readers_and_part_dirs(tmp_path):
    d = tmp_path / "parts"
    d.mkdir()
    (d / "part-00001").write_text("b ;2\n\nc;3\n")
    (d / "part-00000").write_text("a; 1\n")
    (d / "_SUCCESS").write_text("")
    assert t_parts(str(d)) == j_parts(str(d))
    assert t_read(str(d), ";") == j_read(str(d), ";") == [
        ["a", "1"], ["b", "2"], ["c", "3"]]


def test_logger_level_override(monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_TORCH_LOG_LEVEL", "ERROR")
    assert profiling.get_logger("t1", True).level == logging.ERROR
    monkeypatch.delenv("AVENIR_TPU_TORCH_LOG_LEVEL")
    assert profiling.get_logger("t2", True).level == logging.DEBUG
    assert profiling.get_logger("t2").level == logging.DEBUG
    assert profiling.get_logger("t2", False).level == logging.WARNING


@pytest.mark.parametrize("chunk", [1, 7, 64, 100])
def test_iter_chunks_cover_rows_in_order(chunk):
    """The chunked feed (``DeviceFeed.from_arrays``, which replaced
    ``iter_chunks``) covers the rows in order."""
    a = np.arange(150, dtype=np.float32).reshape(50, 3)
    b = np.arange(50, dtype=np.int32).reshape(50, 1)
    parts = [fc.arrays for fc in DeviceFeed.from_arrays(
        (torch.from_numpy(a), None, torch.from_numpy(b)), chunk, depth=1,
        device=torch.device("cpu"))]
    assert all(p[1] is None for p in parts)
    assert np.array_equal(torch.cat([p[0] for p in parts]).numpy(), a)
    assert np.array_equal(torch.cat([p[2] for p in parts]).numpy(), b)
    assert max(p[0].shape[0] for p in parts) == min(chunk, 50)


def test_encoded_table_from_numpy_round_trip():
    j_train, _, t_train, _ = tables("elearn", 100, 10, seed=2)
    carried = interop.encoded_table_from_numpy(
        np.asarray(j_train.binned), np.asarray(j_train.numeric),
        np.asarray(j_train.labels), j_train.ids,
        feature_fields=t_train.feature_fields,
        bins_per_feature=j_train.bins_per_feature,
        is_continuous=j_train.is_continuous,
        class_values=j_train.class_values, bin_labels=j_train.bin_labels,
        norm_min=j_train.norm_min, norm_max=j_train.norm_max, device="cpu")
    assert torch.equal(carried.binned, t_train.binned)
    assert torch.equal(carried.numeric, t_train.numeric)
    assert torch.equal(carried.labels, t_train.labels)
    assert carried.n_rows == 100 and carried.device.type == "cpu"
    assert torch.equal(t_normalize(carried), t_normalize(t_train))
