"""The port's counterparts of the JAX project's kernel experiments under
``scripts/``, run as modules:

- ``python -m avenir_tpu_torch.scripts.exp_fold`` — the lane-bucket fold
  top-k (K6) at five (n_acc, tile_n) configurations: rows/s and recall
  against the exact top-k, with and without bf16 rounding;
- ``python -m avenir_tpu_torch.scripts.roofline_knn`` — the KNN roofline
  decomposition: K2 (``full``) beside its isolated parts K7 (``dotmin``),
  K8 (``nodot``) and K9 (``tpose``), each against the H100's ceilings.

Both take ``--device`` (default ``cuda``; without a GPU, pass ``cpu``) and
time with :mod:`avenir_tpu_torch.scripts._timing`.
"""
