"""How far the port's multiLinearRegression lies from the JAX package's at
``chip_smoke.py`` phase 11's regression shape (100,000 train / 20,000 test
elearn rows, a planted score column, k = 5, every numeric feature).

Both solves run on the same neighborhoods: the port's ``regress`` finds
them (on the CPU, test rows in chunks of 2,000), and the JAX package's
ridge lines (``avenir_tpu/models/knn.py:858-872``) run on the port's
neighbor ids, so the gap is the solve's alone (ROADMAP C8). Prints the
share of ints that differ and the values' relative gap. Run from the repo
root on the CPU (a few minutes, ~3 GiB)::

    JAX_PLATFORMS=cpu python tests/_torch_regression_gap.py
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNK = 2000


def _tables():
    import chip_smoke as S
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.schema import FeatureSchema
    # chip_smoke.modes_phase's regression rows and schema
    elearn = G.elearn_rows(S.ELEARN_TRAIN + S.ELEARN_TEST, seed=S.SEED + 11)
    feats = np.asarray([[float(v) for v in r[1:10]] for r in elearn])
    rng = np.random.default_rng(S.SEED + 11)
    score = (0.5 * feats[:, 4] + 0.3 * feats[:, 5] + feats[:, 0] / 20.0
             + rng.normal(0, 3, len(elearn)))
    rows = [r[:10] + [f"{v:.1f}"] for r, v in zip(elearn, score)]
    schema = G.elearn_schema_json()
    fields = [f for f in schema["entity"]["fields"] if f["ordinal"] < 10]
    fields.append({"name": "score", "ordinal": 10, "dataType": "double",
                   "classAttribute": True})
    schema = dict(schema, entity=dict(schema["entity"], fields=fields))
    fz = Featurizer(FeatureSchema.from_json(schema), device="cpu")
    return fz, rows[:S.ELEARN_TRAIN], rows[S.ELEARN_TRAIN:]


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from avenir_tpu_torch.models import knn

    torch.set_num_threads(4)
    fz, train_rows, test_rows = _tables()
    fz.fit(train_rows)
    train = fz.transform(train_rows, with_labels=False)
    ords = [f.ordinal for f in fz.schema.get_feature_fields()
            if not f.is_categorical]

    def column(rows, cols):
        return np.asarray([[float(r[i]) for i in cols] for r in rows],
                          np.float32)

    target_ord = fz.schema.find_class_attr_field().ordinal
    targets = column(train_rows, [target_ord])[:, 0]
    tx, sx = column(train_rows, ords), column(test_rows, ords)
    cfg = knn.KnnConfig(top_match_count=5,
                        regression_method="multiLinearRegression")
    idx, val, pred = [], [], []
    for r0 in range(0, len(test_rows), CHUNK):
        p = knn.regress(train, fz.transform(test_rows[r0:r0 + CHUNK],
                                            with_labels=False), cfg,
                        torch.from_numpy(targets),
                        regr_input=(torch.from_numpy(tx),
                                    torch.from_numpy(sx[r0:r0 + CHUNK])))
        idx.append(p.neighbor_idx)
        val.append(p.regressed)
        pred.append(p.predicted)
    idx, val, pred = map(np.concatenate, (idx, val, pred))

    # avenir_tpu/models/knn.py:858-872 on the port's neighborhoods
    nbr_y = jnp.asarray(targets)[idx].astype(jnp.float32)
    nbr_x = jnp.asarray(tx)[idx].astype(jnp.float32)
    ones = jnp.ones(nbr_x.shape[:2] + (1,), jnp.float32)
    a = jnp.concatenate([nbr_x, ones], axis=2)
    ata = jnp.einsum("mkf,mkg->mfg", a, a)
    aty = jnp.einsum("mkf,mk->mf", a, nbr_y)
    f1 = a.shape[2]
    lam = 1e-5 * jnp.einsum("mff->m", ata)[:, None, None] / f1 + 1e-6
    w = jnp.linalg.solve(ata + lam * jnp.eye(f1, dtype=jnp.float32),
                         aty[..., None])[..., 0]
    test_aug = jnp.concatenate(
        [jnp.asarray(sx), jnp.ones((sx.shape[0], 1), jnp.float32)], axis=1)
    jval = np.asarray(jnp.sum(test_aug * w, axis=1))
    jpred = np.asarray(jnp.asarray(jnp.sum(test_aug * w, axis=1),
                                   jnp.int32))

    off = pred != jpred
    rel = (np.abs(jval.astype(np.float64) - val)
           / np.maximum(np.abs(val), 1.0))
    print(f"rows {len(pred)}; ints differing {int(off.sum())} "
          f"({off.mean():.4%}), max |difference| "
          f"{int(np.abs(pred.astype(np.int64) - jpred).max())}; relative "
          f"value gap median {np.median(rel):.3e}, p99 "
          f"{np.quantile(rel, 0.99):.3e}, max {rel.max():.3e}; rows past "
          f"rtol 1e-4: {int((rel > 1e-4).sum())}")


if __name__ == "__main__":
    main()
