"""How far the port's batch verbs lie from the JAX package's at
``chip_smoke.py`` phase 12's shapes, on the CPU (ROADMAP queue C):

- LogisticRegressionJob's f32 device loop on 1,048,576 elearn rows (32,768
  tiled, as phase 12 has them), 100 iterations: the first iteration whose
  coefficients differ and the largest relative gap of each block of
  iterations (the port sums its products in float64 in a fixed order,
  the JAX package in f32 in Eigen's; the raw features, up to ~600, make
  the unnormalized ascent swing, so a first gap does not shrink);
- FisherDiscriminant on those rows: the lines that differ and the largest
  relative gap of their values (the JAX package's moments are f32 einsum
  sums, inexact past 2^24, the port's float64 sums rounded once);
- UnderSamplingBalancer's class counts past 2^24 rows of one class: the
  JAX package's f32 one-hot sum against the exact count.

Run from the repo root (a few minutes, ~4 GiB)::

    JAX_PLATFORMS=cpu python tests/_torch_batch_gaps.py
"""

import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _elearn_rows():
    import chip_smoke as S
    from avenir_tpu_torch.datagen import generators as G
    rows = G.elearn_rows(S.BATCH_BASE_ROWS, seed=S.SEED)
    reps = -(-S.BATCH_ROWS // len(rows))
    return (rows * reps)[:S.BATCH_ROWS]


def logistic_gap(rows):
    import jax.numpy as jnp
    from avenir_tpu.models import logistic as jlog
    from avenir_tpu_torch.models import logistic as tlog
    x = np.asarray([[float(v) for v in r[1:10]] for r in rows], np.float32)
    y = np.asarray([1.0 if r[10] == "fail" else 0.0 for r in rows],
                   np.float32)
    hist = {}
    with tempfile.TemporaryDirectory() as work:
        for tag, mod, conv in (("jax", jlog, jnp.asarray),
                               ("port", tlog, torch.from_numpy)):
            path = os.path.join(work, f"{tag}.txt")
            mod.train(conv(x), conv(y),
                      mod.LogisticConfig(max_iterations=100), path)
            hist[tag] = np.loadtxt(path, delimiter=",", ndmin=2)
    j, t = hist["jax"], hist["port"]
    rel = np.abs(t - j) / np.maximum(np.abs(j), 1e-30)
    differ = np.flatnonzero(rel.max(axis=1) > 0)
    print(f"logistic f32 loop, {len(rows)} rows: {len(j)} and {len(t)} "
          f"iterations; first differing iteration "
          f"{differ[0] + 1 if len(differ) else 'none'}; largest relative "
          f"gap {rel.max():.3g}, absolute {np.abs(t - j).max():.3g}")
    for i in range(3):
        print(f"  iteration {i + 1}: {rel[i].max():.3g}")
    for lo in range(0, len(j), 20):
        print(f"  iterations {lo + 1}-{min(lo + 20, len(j))}: "
              f"{rel[lo:lo + 20].max():.3g}")


def fisher_gap(rows):
    from avenir_tpu.models import fisher as jfisher
    from avenir_tpu.utils.dataset import Featurizer as JF
    from avenir_tpu.utils.schema import FeatureSchema as JS
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import fisher as tfisher
    from avenir_tpu_torch.native.loader import transform_file
    from avenir_tpu_torch.utils.dataset import Featurizer as TF
    from avenir_tpu_torch.utils.schema import FeatureSchema as TS
    schema = G.elearn_schema_json()
    tfz = TF(TS.from_json(schema), device="cpu").fit([])
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "elearn.csv")
        with open(path, "w") as fh:
            fh.write("".join(",".join(r) + "\n" for r in rows))
        t_lines = tfisher.serialize(tfisher.train(transform_file(tfz,
                                                                 path)))
    j_lines = jfisher.serialize(jfisher.train(
        JF(JS.from_json(schema)).fit_transform(rows)))
    gaps = []
    for tl, jl in zip(t_lines, j_lines):
        tv = np.asarray([float(v) for v in tl.split(",")[1:]])
        jv = np.asarray([float(v) for v in jl.split(",")[1:]])
        gaps.append(np.abs(tv - jv) / np.maximum(np.abs(jv), 1e-30))
    gaps = np.asarray(gaps)
    differ = sum(a != b for a, b in zip(t_lines, j_lines))
    print(f"Fisher, {len(rows)} rows: {differ} of {len(t_lines)} lines "
          f"differ; largest relative gap: "
          f"logOddsPrior {gaps[:, 0].max():.3g}, pooledVariance "
          f"{gaps[:, 1].max():.3g}, boundary {gaps[:, 2].max():.3g}")


def count_gap():
    import jax
    import jax.numpy as jnp
    for n in (2 ** 24 - 1, 2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 5):
        labels = jnp.zeros((n,), jnp.int32)
        got = float(jnp.sum(jax.nn.one_hot(labels, 2, dtype=jnp.float32),
                            axis=0)[0])
        print(f"under-sampling counts, {n} rows of one class: the JAX "
              f"package's f32 count {got:.0f}, exact {n}, off by "
              f"{n - got:.0f}")


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    rows = _elearn_rows()
    logistic_gap(rows)
    fisher_gap(rows)
    count_gap()
