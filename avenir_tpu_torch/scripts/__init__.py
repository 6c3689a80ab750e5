"""The port's counterparts of the JAX project's kernel experiments under
``scripts/``, run as modules:

- ``python -m avenir_tpu_torch.scripts.exp_fold`` — the lane-bucket fold
  top-k (K6) at five (n_acc, tile_n) configurations: rows/s and recall
  against the exact top-k, with and without bf16 rounding;
- ``python -m avenir_tpu_torch.scripts.roofline_knn`` — the KNN roofline
  decomposition: K2 (``full``) beside its isolated parts K7 (``dotmin``),
  K8 (``nodot``) and K9 (``tpose``), each against the H100's ceilings.

- the kernel-restructure sweeps, each gating its arms on recall against
  the exact top-k and timing those it keeps against K2:
  ``sweep11_vmem`` (the production fold at larger tiles, K6),
  ``sweep14_tpose`` and ``sweep17_tpose_protocol`` (the feature-major fold,
  K9, by a best-of and by the interleaved protocol), ``sweep16_kernels``
  (an epilogue folded into bf16 operands, K10; int8 operands, K11),
  ``sweep16b_kernels`` (the same repaired for recall: ``y²`` as two bf16
  columns, an exact re-rank of 16 int8 candidates, the packed fold K12),
  ``sweep16c_kernels`` (the packed fold on centered operands, 1,024 and
  2,048 buckets) and ``sweep18_tpose_fold`` (feature-major with the cheaper
  folds, K9 and K10). What they share is in :mod:`._sweep`.

All take ``--device`` (default ``cuda``; without a GPU, pass ``cpu``),
``--m`` and ``--n``, and time with :mod:`avenir_tpu_torch.scripts._timing`.
"""
