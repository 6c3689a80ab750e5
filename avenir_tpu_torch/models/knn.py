"""K-nearest-neighbor classification on torch tensors.

Counterpart of ``avenir_tpu/models/knn.py`` (``KnnConfig``,
``validate_config``, the brute-force branches of ``neighbors``,
``_vote_kernel``, ``_decide``, ``classify``, ``validate``). It collapses
the reference's pipeline (distance MR, top-k by secondary sort, kernel
weighting, class vote) into: pairwise distance + top-k (kernel K2, or K3
on the chunked feed) → kernel weighting → class vote → arbitration.

Kernel/score semantics mirror Neighborhood.java:150-218 exactly, including
the integer arithmetic (KERNEL_SCALE=100, truncating division):

- none:                 score = 1
- linearMultiplicative: score = dist==0 ? 200 : 100 // dist
- linearAdditive:       score = 100 - dist
- gaussian:             score = int(100 * exp(-0.5 (dist/param)^2))

Distances enter these formulas as the reference's scaled ints
(``distance.scale``). Class-conditional weighting multiplies the score by
the neighbor's P(features|class) and optionally by inverse distance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import cuda_distance, cuda_fused, distance
from avenir_tpu_torch.parallel.pipeline import iter_chunks
from avenir_tpu_torch.utils.dataset import (
    EncodedTable, norm_range, normalize_numeric)
from avenir_tpu_torch.utils.metrics import ConfusionMatrix

KERNEL_SCALE = 100
PROB_SCALE = 100


@dataclass(frozen=True)
class KnnConfig:
    """Knobs, named after their reference property keys."""

    top_match_count: int = 5                 # top.match.count
    kernel_function: str = "none"            # kernel.function
    kernel_param: int = 100                  # kernel.param
    class_cond_weighted: bool = False        # class.condtion.weighted (sic)
    inverse_distance_weighted: bool = False  # inverse.distance.weighted
    decision_threshold: float = -1.0         # decision.threshold
    positive_class: Optional[str] = None     # positive.class.value
    distance_scale: int = 1000               # distance.scale
    algorithm: str = "euclidean"             # schema distAlgorithm
    block_size: int = 65536
    mode: str = "fast"                       # knn.mode: "fast" | "exact"
    # feed.chunk.rows: >0 sends test rows to the device in chunks of this
    # many rows (pinned host memory, non_blocking copies); 0 scores the
    # whole test table at once
    feed_chunk_rows: int = 0                 # feed.chunk.rows
    # knn.fused: on the chunked feed, hand RAW chunks to the fused
    # normalize→distance→top-k kernel (K3); off normalizes the test table
    # where it lies, before chunking
    fused: bool = True                       # knn.fused


def _num_cat_idx(table: EncodedTable):
    num_idx = [i for i, f in enumerate(table.feature_fields)
               if f.is_numeric or table.is_continuous[i]]
    cat_idx = [i for i, f in enumerate(table.feature_fields)
               if f.is_categorical]
    return num_idx, cat_idx


def _split_features(table: EncodedTable, raw: bool = False
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                               int]:
    """(numeric [N, Fn], categorical codes [N, Fc], max cat bins), on the
    table's device. Numeric features are range-normalized, or with ``raw``
    stay on the fit scale (the fused kernel normalizes them itself)."""
    num_idx, cat_idx = _num_cat_idx(table)
    numeric = table.numeric if raw else normalize_numeric(table)
    x_num = numeric[:, num_idx] if num_idx else None
    x_cat = table.binned[:, cat_idx] if cat_idx else None
    n_cat_bins = max((table.bins_per_feature[i] for i in cat_idx), default=0)
    return x_num, x_cat, n_cat_bins


def _numeric_range(table: EncodedTable, device: torch.device
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The fit-time (mins, span) of the numeric features on ``device``
    (zero width → 1), or ``(None, None)`` when the table records no range
    or has no numeric feature."""
    num_idx, _ = _num_cat_idx(table)
    if not (table.norm_min and num_idx):
        return None, None
    mins, span = norm_range(table)
    return (torch.from_numpy(mins[num_idx]).to(device),
            torch.from_numpy(span[num_idx]).to(device))


def validate_config(config: KnnConfig) -> None:
    """Every invalid configuration raises a ValueError naming the key and
    the accepted values, before any table is touched."""
    if config.top_match_count < 1:
        raise ValueError(
            f"top.match.count must be >= 1, got {config.top_match_count}")
    if config.mode not in ("fast", "exact"):
        raise ValueError(
            f"knn.mode must be 'fast' or 'exact', got {config.mode!r}")
    if config.algorithm not in ("euclidean", "manhattan"):
        raise ValueError(
            "schema distAlgorithm must be 'euclidean' or 'manhattan', "
            f"got {config.algorithm!r}")


def neighbors(train: EncodedTable, test: EncodedTable, config: KnnConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [M, k] scaled int32, train ids [M, k] int32) on the train
    table's device. The test table may lie on the host: the chunked feed
    moves its rows to the train table's device.

    Euclidean fast-mode jobs with k ≤ 128 and an encoded width ≤ 512 go
    through the kernel family: K2, or K3 when ``feed_chunk_rows`` chunks
    the test rows and ``fused`` is on. Everything else takes the plain
    blocked top-k of ``ops/distance.py``."""
    validate_config(config)
    tr_num, tr_cat, n_bins = _split_features(train)
    m = test.n_rows
    dev = train.device
    feed_active = 0 < config.feed_chunk_rows < m
    encoded_width = ((tr_num.shape[1] if tr_num is not None else 0) +
                     (tr_cat.shape[1] if tr_cat is not None else 0) * n_bins)
    use_kernel = cuda_distance.supported(
        algorithm=config.algorithm, k=config.top_match_count,
        mode=config.mode, encoded_width=encoded_width)
    use_fused = feed_active and use_kernel and config.fused
    # the test table stays where the caller put it: on the host it streams
    # to the card chunk by chunk, on the card the chunks are slices of it
    te_num, te_cat, _ = _split_features(test, raw=use_fused)
    mins, span = _numeric_range(test, dev) if use_fused else (None, None)

    def run(xn, xc):
        if use_fused:
            return cuda_fused.fused_topk_cuda(
                xn, tr_num, xc, tr_cat, mins=mins, span=span,
                k=config.top_match_count, n_cat_bins=n_bins,
                distance_scale=config.distance_scale)
        if use_kernel:
            return cuda_distance.pairwise_topk_cuda(
                xn, tr_num, xc, tr_cat, k=config.top_match_count,
                n_cat_bins=n_bins, distance_scale=config.distance_scale)
        return distance.pairwise_topk(
            xn, tr_num, xc, tr_cat, k=config.top_match_count,
            block_size=config.block_size, algorithm=config.algorithm,
            n_cat_bins=n_bins, distance_scale=config.distance_scale,
            mode=config.mode)

    if not feed_active:
        return run(*(None if t is None else t.to(dev) for t in (te_num, te_cat)))
    parts = [run(*chunk) for chunk in
             iter_chunks((te_num, te_cat), config.feed_chunk_rows, dev)]
    return (torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts]))


def _vote_kernel(dist: torch.Tensor, nbr_labels: torch.Tensor,
                 nbr_post: Optional[torch.Tensor], kernel_function: str,
                 kernel_param: int, n_classes: int, class_cond_weighted: bool,
                 inverse_distance_weighted: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel scores + per-class vote: (votes [M, C] f32, scores [M, k])."""
    if kernel_function == "none":
        score = torch.ones_like(dist)
    elif kernel_function == "linearMultiplicative":
        score = torch.where(dist == 0, 2 * KERNEL_SCALE,
                            KERNEL_SCALE // torch.clamp(dist, min=1))
    elif kernel_function == "linearAdditive":
        score = KERNEL_SCALE - dist
    elif kernel_function == "gaussian":
        t = dist.to(torch.float32) / kernel_param
        score = (KERNEL_SCALE * torch.exp(-0.5 * t * t)).to(torch.int32)
    else:
        raise ValueError(f"unknown kernel function {kernel_function!r}")

    w = score.to(torch.float32)
    if class_cond_weighted and nbr_post is not None:
        w = torch.where(nbr_post > 0, w * nbr_post, w)
    if inverse_distance_weighted:
        w = w / torch.clamp(dist.to(torch.float32), min=1.0)

    # one neighbor slot at a time: the same summation order for any batch
    votes = torch.zeros((dist.shape[0], n_classes), dtype=torch.float32,
                        device=dist.device)
    for s in range(dist.shape[1]):
        votes = votes + w[:, s:s + 1] * torch.nn.functional.one_hot(
            nbr_labels[:, s].long(), n_classes).to(torch.float32)
    return votes, score


@dataclass
class KnnPrediction:
    predicted: np.ndarray              # [M] class index
    class_votes: Optional[np.ndarray]  # [M, C] kernel-weighted votes
    class_prob: Optional[np.ndarray]   # [M, C] int percent (PROB_SCALE)
    neighbor_idx: np.ndarray           # [M, k]
    neighbor_dist: np.ndarray          # [M, k] scaled int


def _decide(votes_np: np.ndarray, config: KnnConfig,
            class_values) -> Tuple[np.ndarray, np.ndarray]:
    """(predicted class index, int-percent class probs) from the vote
    matrix — the decision-threshold / argmax / PROB_SCALE arbitration
    (Neighborhood.classify :272-312)."""
    if config.decision_threshold > 0:
        if config.positive_class is None or len(class_values) != 2:
            raise ValueError("decision threshold needs binary classes and "
                             "positive.class.value")
        pos = list(class_values).index(config.positive_class)
        neg = 1 - pos
        ratio = votes_np[:, pos] / np.maximum(votes_np[:, neg], 1e-9)
        predicted = np.where(ratio > config.decision_threshold, pos, neg)
    else:
        predicted = np.argmax(votes_np, axis=1)
    total = votes_np.sum(axis=1, keepdims=True)
    prob = np.floor(votes_np * PROB_SCALE /
                    np.maximum(total, 1e-9)).astype(np.int64)
    return predicted.astype(np.int64), prob


def classify(train: EncodedTable, test: EncodedTable, config: KnnConfig,
             feature_post: Optional[torch.Tensor] = None) -> KnnPrediction:
    """End-to-end KNN classification. ``feature_post`` is the optional
    [N_train, C] class-conditional probability table from Naive Bayes
    (the in-memory FeatureCondProbJoiner): each neighbor's vote is
    weighted by P(features | its own class)."""
    dist, idx = neighbors(train, test, config)
    idx_l = idx.long()
    nbr_labels = train.labels[idx_l]                              # [M, k]
    nbr_post = None
    use_post = config.class_cond_weighted and feature_post is not None
    if use_post:
        nbr_post = torch.gather(feature_post[idx_l], 2,
                                nbr_labels.long().unsqueeze(-1)).squeeze(-1)
    votes, _ = _vote_kernel(
        dist, nbr_labels, nbr_post, config.kernel_function,
        config.kernel_param, train.n_classes, use_post,
        config.inverse_distance_weighted)
    votes_np = votes.cpu().numpy()
    predicted, prob = _decide(votes_np, config, train.class_values)
    return KnnPrediction(predicted=predicted, class_votes=votes_np,
                         class_prob=prob, neighbor_idx=idx.cpu().numpy(),
                         neighbor_dist=dist.cpu().numpy())


def validate(pred: KnnPrediction, test: EncodedTable,
             positive_class: Optional[str] = None) -> ConfusionMatrix:
    cm = ConfusionMatrix(test.class_values, positive_class=positive_class)
    cm.update(pred.predicted, test.labels)
    return cm
