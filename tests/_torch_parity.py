"""Helpers shared by the ``test_torch_*`` parity files: the same seeded
inputs for the JAX package and its PyTorch port, and the near-tie rule
the top-k comparisons use."""

from __future__ import annotations

import json

import numpy as np

from avenir_tpu.datagen import generators as JG
from avenir_tpu.utils.dataset import Featurizer as JFeaturizer
from avenir_tpu_torch.utils.dataset import Featurizer as TFeaturizer
from avenir_tpu_torch.utils.schema import FeatureSchema as TSchema


def write_csv(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")


def fixture(name: str, n: int, seed: int):
    """(schema json, rows) of the churn or elearn tutorial fixture."""
    if name == "churn":
        return JG._CHURN_SCHEMA_JSON, JG.churn_rows(n, seed=seed)
    return JG.elearn_schema_json(), JG.elearn_rows(n, seed=seed)


def tables(name: str, n_train: int, n_test: int, seed: int = 11,
           test_labels: bool = True):
    """(jax train, jax test, torch train, torch test) tables of a fixture,
    both packages fitted on the same train rows."""
    from avenir_tpu.utils.schema import FeatureSchema as JSchema
    schema_json, rows = fixture(name, n_train + n_test, seed)
    train_rows, test_rows = rows[:n_train], rows[n_train:]
    jfz = JFeaturizer(JSchema.from_json(schema_json)).fit(train_rows)
    tfz = TFeaturizer(TSchema.from_json(schema_json),
                      device="cpu").fit(train_rows)
    return (jfz.transform(train_rows),
            jfz.transform(test_rows, with_labels=test_labels),
            tfz.transform(train_rows),
            tfz.transform(test_rows, with_labels=test_labels))


def write_fixture(tmp_path, name: str, n_train: int, n_test: int,
                  seed: int = 11):
    schema_json, rows = fixture(name, n_train + n_test, seed)
    write_csv(tmp_path / "train.csv", rows[:n_train])
    write_csv(tmp_path / "test.csv", rows[n_train:])
    with open(tmp_path / "schema.json", "w") as fh:
        json.dump(schema_json, fh)
    return rows[:n_train], rows[n_train:]


def exact_metrics(x_num, y_num, x_cat=None, y_cat=None) -> np.ndarray:
    """[M, N] float64 squared euclidean (numeric) + mismatch count."""
    m = (x_num if x_num is not None else x_cat).shape[0]
    n = (y_num if y_num is not None else y_cat).shape[0]
    out = np.zeros((m, n), np.float64)
    if x_num is not None:
        xn = np.asarray(x_num, np.float64)
        yn = np.asarray(y_num, np.float64)
        out += ((xn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
    if x_cat is not None:
        out += (np.asarray(x_cat)[:, None, :]
                != np.asarray(y_cat)[None, :, :]).sum(-1)
    return out


def near_tie_rows(metrics: np.ndarray, k: int, rtol: float = 1e-5
                  ) -> np.ndarray:
    """[M] bool: rows whose k-th and (k+1)-th smallest metrics lie within
    ``rtol`` (relative) — there the f32 summation order may pick either
    neighbor."""
    if metrics.shape[1] <= k:
        return np.zeros(metrics.shape[0], bool)
    part = np.sort(metrics, axis=1)
    kth, nxt = part[:, k - 1], part[:, k]
    return (nxt - kth) <= rtol * np.maximum(np.abs(kth), 1e-12)


def featurizers(schema_json, rows, unseen: str = "error"):
    """(jax featurizer, torch featurizer on the CPU), both fitted on
    ``rows``."""
    from avenir_tpu.utils.schema import FeatureSchema as JSchema
    jfz = JFeaturizer(JSchema.from_json(schema_json), unseen=unseen)
    tfz = TFeaturizer(TSchema.from_json(schema_json), unseen=unseen,
                      device="cpu")
    return jfz.fit(rows), tfz.fit(rows)


def assert_tables_equal(a, b):
    """Two encoded tables (of either package) equal bit for bit."""
    for name in ("binned", "numeric"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))
    assert (a.labels is None) == (b.labels is None)
    if a.labels is not None:
        np.testing.assert_array_equal(np.asarray(a.labels),
                                      np.asarray(b.labels))
    assert a.n_rows == b.n_rows
    assert list(a.ids) == list(b.ids)
    assert tuple(a.bins_per_feature) == tuple(b.bins_per_feature)
    assert a.bin_labels == b.bin_labels
    assert list(a.class_values) == list(b.class_values)
