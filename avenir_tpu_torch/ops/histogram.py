"""One-hot / segment count reductions — the MR "shuffle" as tensor ops.

Counterpart of ``avenir_tpu/ops/histogram.py`` (``class_counts``,
``feature_bin_counts``, ``class_feature_bin_counts``,
``node_class_bin_counts``, ``per_class_moments``, ``pair_counts``). Every
counting MR job of the reference is a map-side emit of small count keys +
a keyed shuffle + a reduce-side sum; here each is one reduction over the
row axis.

Ids outside their range drop out (the one-hot behavior), and integer
counts are exact. ``class_feature_bin_counts`` — the Naive Bayes joint
counts — goes through K1, as do ``class_bin_counts_exact``, the text
path's int64 (class, token) counts, and ``node_class_bin_counts``, a tree
level's histogram (one K1 launch for each chunk of its nodes, and for a
forest's level one for each tree and chunk), and
``node_channel_bin_sums``, a boosting level's exact int64 channel sums
(K1's integer mode, two launches for each chunk of its nodes), and
``pair_counts`` and ``pair_counts_multi`` —
the contingency counts of MI and correlation, one pair or every pair of a
job in one launch — through K4 (``ops/cuda_histogram.py``), whose wrappers
take their plain versions for CPU tensors and launch the kernels for CUDA
ones. All functions take an optional per-row ``weights`` vector.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from avenir_tpu_torch.ops import cuda_histogram


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``ids`` over a new last axis; ids outside [0, n)
    give an all-zero row (``jax.nn.one_hot`` semantics)."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    oh = torch.nn.functional.one_hot(torch.where(valid, ids, 0), n)
    return oh.to(torch.float32) * valid.unsqueeze(-1).to(torch.float32)


def class_counts(labels: torch.Tensor, n_classes: int,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] int labels -> [C] counts (the class-prior reduction)."""
    oh = _one_hot(labels, n_classes)
    if weights is not None:
        oh = oh * weights.reshape(-1, 1)
    return oh.sum(dim=0)


def feature_bin_counts(bins: torch.Tensor, n_bins: int,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[N, F] bin ids -> [F, B] counts (the feature-prior reduction)."""
    oh = _one_hot(bins, n_bins)                                 # [N, F, B]
    if weights is not None:
        oh = oh * weights.reshape(-1, 1, 1)
    return oh.sum(dim=0)


def class_feature_bin_counts(bins: torch.Tensor, labels: torch.Tensor,
                             n_classes: int, n_bins: int,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """[N, F] bins × [N] labels -> [C, F, B] joint counts: the whole
    BayesianDistribution train job (mapper emit (classVal, ord, bin)→1 +
    reducer sum), through K1."""
    return cuda_histogram.class_feature_bin_counts(
        bins.to(torch.int32).contiguous(), labels.to(torch.int32).contiguous(),
        n_classes, n_bins,
        None if weights is None
        else weights.to(torch.float32).contiguous())


#: most rows of one K1 launch in class_bin_counts_exact: no cell of its f32
#: result can then pass 2^24, so every count is exact
MAX_LAUNCH_ROWS = 1 << 24


def class_bin_counts_exact(ids: torch.Tensor, labels: torch.Tensor,
                           n_classes: int, n_bins: int) -> torch.Tensor:
    """[N] ids × [N] labels -> [C, B] int64 counts: K1 with one feature
    and the ids as its bins (the text path's (class, token) occurrences,
    its documents a class, the word counts). One launch for every
    ``MAX_LAUNCH_ROWS`` rows, each exact in f32, summed in int64, so a
    count stays exact past 2^24 (where the JAX package's f32 scatter-add
    of the text counts does not)."""
    out = torch.zeros((max(n_classes, 0), max(n_bins, 0)),
                      dtype=torch.int64, device=ids.device)
    if n_classes < 1 or n_bins < 1:
        return out
    ids = ids.to(torch.int32).reshape(-1, 1)
    labels = labels.to(torch.int32)
    for r0 in range(0, ids.shape[0], MAX_LAUNCH_ROWS):
        r1 = min(r0 + MAX_LAUNCH_ROWS, ids.shape[0])
        out += cuda_histogram.class_feature_bin_counts(
            ids[r0:r1].contiguous(), labels[r0:r1].contiguous(), n_classes,
            n_bins)[:, 0, :].to(torch.int64)
    return out


#: most combined (node, bin) cells of one K1 launch in node_class_bin_counts
#: (the JAX package's chunk, so that launches correspond)
_NODE_CHUNK_CB = 8192
#: most (tree, row, feature) combined ids node_class_bin_counts builds at
#: once for a forest's level (int32: 256 MiB)
_FOREST_IDS = 1 << 26


def node_class_bin_counts(bins: torch.Tensor, node_id: torch.Tensor,
                          labels: torch.Tensor, n_nodes: int, n_bins: int,
                          n_classes: int,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[N, A] bins × [N] node ids × [N] labels -> [A, n_nodes, n_bins,
    n_classes] counts: a tree level's (node, feature, bin, class)
    histogram. The node id folds into the bin axis (``node · n_bins +
    bin``) of ``class_feature_bin_counts``, one call for each chunk of
    ``_NODE_CHUNK_CB // n_bins`` nodes; rows outside the chunk, and bins
    or nodes out of range, take the combined id -1 and drop out, so the
    chunks partition the rows and the counts equal an unchunked pass.

    A forest's level passes ``node_id`` and ``weights`` with a leading
    tree axis [Kt, N] and gets [Kt, A, n_nodes, n_bins, n_classes]: the
    combined ids of a group of trees are built together, then each tree
    counts in its own K1 calls."""
    n, n_a = bins.shape
    bins = bins.to(torch.int32)
    labels = labels.to(torch.int32).contiguous()
    forest = node_id.dim() == 2
    node_b = node_id.to(torch.int32).reshape(-1, n)
    w_b = None if weights is None else \
        weights.to(torch.float32).reshape(-1, n)
    kt = node_b.shape[0]
    bin_ok = (bins >= 0) & (bins < n_bins)
    node_ok = (node_b >= 0) & (node_b < n_nodes)
    chunk = max(1, _NODE_CHUNK_CB // max(n_bins, 1))
    group = max(1, _FOREST_IDS // max(n * n_a, 1))
    parts = []
    for k0 in range(0, n_nodes, chunk):
        k1 = min(k0 + chunk, n_nodes)
        flats = []
        for g0 in range(0, kt, group):
            g1 = min(g0 + group, kt)
            nb = node_b[g0:g1]
            in_chunk = node_ok[g0:g1] & (nb >= k0) & (nb < k1)
            combined = torch.where(bin_ok & in_chunk[..., None],
                                   (nb[..., None] - k0) * n_bins + bins, -1)
            flats += [class_feature_bin_counts(
                combined[i], labels, n_classes, (k1 - k0) * n_bins,
                None if w_b is None else w_b[g0 + i])
                for i in range(g1 - g0)]
        flat = flats[0][None] if kt == 1 else torch.stack(flats)
        # [Kt, C, A, (k1-k0)·B] -> [Kt, A, k1-k0, B, C]
        parts.append(flat.reshape(kt, n_classes, n_a, k1 - k0, n_bins)
                     .permute(0, 2, 3, 4, 1))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return out if forest else out[0]


def node_channel_bin_sums(bins: torch.Tensor, node_id: torch.Tensor,
                          labels: torch.Tensor, hess_w: torch.Tensor,
                          grad_w: torch.Tensor, n_nodes: int, n_bins: int,
                          n_classes: int, max_abs_weight: float
                          ) -> torch.Tensor:
    """[N, A] bins × [N] node ids × [N] labels and two [N] integer-valued
    weight vectors -> [A, n_nodes, n_bins, n_classes + 1] int64 exact sums:
    a boosting level's channel histogram. Channel c < C sums ``hess_w``
    over the rows of label c (the hessian-weighted class counts), channel
    C sums ``grad_w`` over every row (the gradient). For each chunk of
    ``_NODE_CHUNK_CB // n_bins`` nodes, K1's integer mode runs twice on
    the same combined ids (``node · n_bins + bin``, -1 for rows outside the
    chunk or out of range, which drop out): once with the labels and the
    hessian weights, once with a single class and the gradient weights.

    The JAX package sums these quanta in f32 (exact below 2^24 a cell);
    here they are integers at any size, so chunked, streamed and atomic
    orders all give the same sums. ``max_abs_weight`` bounds the
    magnitude of both weight vectors (see
    ``cuda_histogram.class_feature_bin_sums``)."""
    n, n_a = bins.shape
    bins = bins.to(torch.int32)
    node_id = node_id.to(torch.int32)
    labels = labels.to(torch.int32).contiguous()
    hess_w = hess_w.to(torch.float32).contiguous()
    grad_w = grad_w.to(torch.float32).contiguous()
    one_class = torch.zeros_like(labels)
    bin_ok = (bins >= 0) & (bins < n_bins)
    node_ok = (node_id >= 0) & (node_id < n_nodes)
    chunk = max(1, _NODE_CHUNK_CB // max(n_bins, 1))
    parts = []
    for k0 in range(0, n_nodes, chunk):
        k1 = min(k0 + chunk, n_nodes)
        in_chunk = node_ok & (node_id >= k0) & (node_id < k1)
        combined = torch.where(bin_ok & in_chunk[:, None],
                               (node_id[:, None] - k0) * n_bins + bins,
                               -1).contiguous()
        width = (k1 - k0) * n_bins
        hess = cuda_histogram.class_feature_bin_sums(
            combined, labels, n_classes, width, hess_w, max_abs_weight)
        grad = cuda_histogram.class_feature_bin_sums(
            combined, one_class, 1, width, grad_w, max_abs_weight)
        # [C+1, A, (k1-k0)·B] -> [A, k1-k0, B, C+1]
        parts.append(torch.cat([hess, grad])
                     .reshape(n_classes + 1, n_a, k1 - k0, n_bins)
                     .permute(1, 2, 3, 0))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def pair_counts(a: torch.Tensor, b: torch.Tensor, n_a: int, n_b: int,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] × [N] ids -> [n_a, n_b] contingency counts (Cramér and the MI
    pairs reduce to this), through K4. Weights fold into the ``a`` side."""
    return cuda_histogram.pair_counts(
        a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous(),
        n_a, n_b,
        None if weights is None
        else weights.to(torch.float32).contiguous())


def pair_counts_multi(ids: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                      cards: Sequence[int],
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """[K, N] ids, pairs (c_a, c_b) of its rows and each row's cardinality
    -> the flat counts of every pair (``cuda_histogram.split_pairs`` cuts
    them into [card[c_a], card[c_b]] blocks), in one launch of K4."""
    return cuda_histogram.pair_counts_multi(
        ids.to(torch.int32).contiguous(), pairs, cards,
        None if weights is None
        else weights.to(torch.float32).contiguous())


def per_class_moments(values: torch.Tensor, labels: torch.Tensor,
                      n_classes: int,
                      weights: Optional[torch.Tensor] = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(class, feature) count / sum / sum-of-squares for continuous
    features — the Gaussian sufficient statistics the reference accumulates
    at BayesianDistribution.java:283-285. Returns ([C,F], [C,F], [C,F]).

    The reference sums integers exactly; an f32 product in whatever order
    the BLAS picks does not (integer features ≤ 600 give sums of squares
    above 2^24). So the f32 values, squares and weights are summed in
    float64 and each result is rounded to f32 once (``dtype=float64``
    keeps the float64 sums, for a caller that adds up parts)."""
    oh = _one_hot(labels, n_classes).to(torch.float64)          # [N, C]
    if weights is not None:
        oh = oh * weights.to(torch.float32).to(torch.float64).reshape(-1, 1)
    values = values.to(torch.float32).to(torch.float64)
    count = oh.T @ torch.ones_like(values)
    vsum = oh.T @ values
    vsq = oh.T @ (values * values)
    return tuple(t.to(dtype) for t in (count, vsum, vsq))
