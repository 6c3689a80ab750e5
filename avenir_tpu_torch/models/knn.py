"""K-nearest-neighbor classification and regression on torch tensors.

Counterpart of ``avenir_tpu/models/knn.py`` (``KnnConfig``,
``validate_config``, the single-device branches of ``neighbors`` — brute
force, ``knn.quantized`` and the ``knn.ann`` index with its one-slot
cache, frozen or live (``knn.ann.live``, ``models/live_ann.py``) —
``_vote_kernel``, ``_decide``, ``classify``,
``classify_from_neighbors`` (the replay of precomputed neighbor records),
``regress``, ``validate``). It collapses the reference's pipeline
(distance MR, top-k by secondary sort, kernel weighting, class vote)
into: pairwise distance + top-k (kernel K2, K3 on the chunked feed, the
quantized scan of ``ops/quantized.py`` or the IVF index of
``ops/ivf.py``) → kernel weighting → class vote → arbitration, or the
regression over the neighbors' targets.

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

from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.ops import (
    cuda_distance, cuda_fused, distance, ivf, quantized)
from avenir_tpu_torch.ops.infotheory import _sum
from avenir_tpu_torch.parallel.pipeline import DeviceFeed
from avenir_tpu_torch.utils.dataset import (
    EncodedTable, norm_range, normalize_numeric)
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
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
    regression_method: str = "average"       # regression.method
    # feed.chunk.rows: >0 sends test rows to the device in chunks of this
    # many rows through the threaded DeviceFeed, feed.depth chunks staged
    # ahead; 0 scores the whole test table at once
    feed_chunk_rows: int = 0                 # feed.chunk.rows
    feed_depth: int = 2                      # feed.depth
    # knn.fused: on the chunked feed, hand RAW chunks to the fused
    # normalize→distance→top-k kernel (K3); off normalizes the test table
    # where it lies, before chunking
    fused: bool = True                       # knn.fused
    # knn.quantized: an int8 or bf16 candidate top-k' (k' = oversample·k)
    # + exact f32 re-rank of the survivors (ops/quantized.py); euclidean
    # only, and it takes precedence over K2 and K3
    quantized: bool = False                  # knn.quantized
    quantized_oversample: int = 4            # knn.quantized.oversample
    quantized_dtype: str = "int8"            # knn.quantized.dtype int8|bf16
    # knn.ann: the IVF index (ops/ivf.py): queries probe the knn.ann.nprobe
    # nearest of knn.ann.nlist k-means lists and run the quantized scan
    # (knn.quantized.dtype / .oversample) over their rows only; nprobe =
    # nlist gives knn.quantized's result exactly (int8). 0 auto-sizes
    # (~√N lists of ≥ 64 rows; a quarter probed, at least 8)
    ann: bool = False                        # knn.ann
    ann_nlist: int = 0                       # knn.ann.nlist (0 = auto)
    ann_nprobe: int = 0                      # knn.ann.nprobe (0 = auto)
    ann_iters: int = 15                      # knn.ann.iters (k-means)
    ann_seed: int = 0                        # knn.ann.seed (build seed)
    # knn.ann.live: queries go through the live index (models/live_ann.py):
    # per-list overflow tails for appended rows, a background re-cluster
    # and its swap. With no appends its results are the frozen index's
    ann_live: bool = False                   # knn.ann.live
    ann_live_tail_budget: int = 1024         # knn.ann.live.tail.budget


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
    if config.quantized or config.ann:
        if config.quantized_dtype not in quantized.QDTYPES:
            raise ValueError(
                f"knn.quantized.dtype must be one of {quantized.QDTYPES}, "
                f"got {config.quantized_dtype!r}")
        if config.quantized_oversample < 1:
            raise ValueError(
                "knn.quantized.oversample must be >= 1, got "
                f"{config.quantized_oversample}")
    if config.quantized and config.algorithm != "euclidean":
        raise ValueError("knn.quantized supports euclidean only; got "
                         f"distAlgorithm {config.algorithm!r}")
    if config.ann:
        if config.quantized:
            raise ValueError(
                "knn.ann and knn.quantized conflict: the ANN query path "
                "already runs the quantized candidate scan + exact f32 "
                "re-rank over the probed lists (knn.quantized.dtype / "
                "knn.quantized.oversample still apply); drop "
                "knn.quantized")
        if config.algorithm != "euclidean":
            raise ValueError("knn.ann supports euclidean only; got "
                             f"distAlgorithm {config.algorithm!r}")
        if config.mode == "exact":
            raise ValueError(
                "knn.ann is approximate by construction (unprobed lists "
                "are never scanned); knn.mode=exact requires the "
                "brute-force path — drop knn.ann or use knn.mode=fast")
        if config.ann_nlist < 0:
            raise ValueError(
                f"knn.ann.nlist must be >= 0 (0 = auto ~sqrt(N)), got "
                f"{config.ann_nlist}")
        if config.ann_nprobe < 0:
            raise ValueError(
                f"knn.ann.nprobe must be >= 0 (0 = auto), got "
                f"{config.ann_nprobe}")
        if (config.ann_nlist > 0 and config.ann_nprobe > 0
                and config.ann_nprobe > config.ann_nlist):
            raise ValueError(
                f"knn.ann.nprobe ({config.ann_nprobe}) cannot exceed "
                f"knn.ann.nlist ({config.ann_nlist}); accepted values "
                "are 1..nlist (nlist probes everything = brute-force "
                "parity)")
        if config.ann_iters < 0:
            raise ValueError(
                f"knn.ann.iters must be >= 0, got {config.ann_iters}")
        if config.ann_live and config.ann_live_tail_budget < 8:
            raise ValueError(
                "knn.ann.live.tail.budget must be >= 8 (per-list "
                f"overflow capacity), got "
                f"{config.ann_live_tail_budget}")
    elif config.ann_live:
        raise ValueError(
            "knn.ann.live is set but knn.ann=false; the live index IS "
            "the IVF index plus append tails — set knn.ann=true")
    elif config.ann_nlist or config.ann_nprobe:
        raise ValueError(
            "knn.ann.nlist/knn.ann.nprobe are set but knn.ann=false; "
            "set knn.ann=true (or drop the index parameters)")


def neighbors(train: EncodedTable, test: EncodedTable, config: KnnConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [M, k] scaled int32, train ids [M, k] int32) on the train
    table's device. The test table may lie on the host: the chunked feed
    moves its rows to the train table's device.

    ``knn.ann`` queries the IVF index (:func:`_neighbors_ann`);
    ``knn.quantized`` runs the quantized scan, before the kernels. Else
    euclidean fast-mode jobs with k ≤ 128 and an encoded width ≤ 512 go
    through the kernel family: K2, or K3 when ``feed_chunk_rows`` chunks
    the test rows and ``fused`` is on. Everything else takes the plain
    blocked top-k of ``ops/distance.py``."""
    validate_config(config)
    if config.ann:
        return _neighbors_ann(train, test, config)
    tr_num, tr_cat, n_bins = _split_features(train)
    dev = train.device
    encoded_width = ((tr_num.shape[1] if tr_num is not None else 0) +
                     (tr_cat.shape[1] if tr_cat is not None else 0) * n_bins)
    use_kernel = not config.quantized and cuda_distance.supported(
        algorithm=config.algorithm, k=config.top_match_count,
        mode=config.mode, encoded_width=encoded_width)
    use_fused = (0 < config.feed_chunk_rows < test.n_rows and use_kernel
                 and config.fused)
    mins, span = _numeric_range(test, dev) if use_fused else (None, None)

    def run(xn, xc):
        if config.quantized:
            return quantized.quantized_topk(
                xn, tr_num, xc, tr_cat, k=config.top_match_count,
                n_cat_bins=n_bins, distance_scale=config.distance_scale,
                oversample=config.quantized_oversample,
                qdtype=config.quantized_dtype, block_size=config.block_size,
                device=dev)
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

    return _feed(run, test, config, dev, raw=use_fused)


def _feed(run, test: EncodedTable, config: KnnConfig, dev: torch.device,
          raw: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run(x_num, x_cat)`` over the test rows on ``dev``: the whole table
    at once, or chunk by chunk through the threaded ``DeviceFeed``
    (``feed.depth`` chunks staged ahead, inside a ``knn.feed`` span) when
    ``feed_chunk_rows`` is below its row count. On the host the table
    streams to the card chunk by chunk; on the card the chunks are slices
    of it. ``raw`` keeps the numeric features on the fit scale."""
    te_num, te_cat, _ = _split_features(test, raw=raw)
    if not 0 < config.feed_chunk_rows < test.n_rows:
        return run(*(None if t is None else t.to(dev)
                     for t in (te_num, te_cat)))
    feed = DeviceFeed.from_arrays((te_num, te_cat), config.feed_chunk_rows,
                                  depth=config.feed_depth, device=dev)
    with telemetry.span("knn.feed"):
        parts = [run(*chunk.arrays) for chunk in feed]
    return (torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts]))


# one-slot staged-IVF cache: a job that scores many test tables against one
# train table builds the index once. Keyed on the table's identity and the
# build parameters; the strong table reference pins the id against reuse.
_ANN_INDEX_CACHE: dict = {}


def _resolved_ann_params(train: EncodedTable, config: KnnConfig
                         ) -> Tuple[int, int]:
    """(nlist, n_probe) with 0s auto-sized from the train row count."""
    nlist = config.ann_nlist or ivf.default_nlist(train.n_rows)
    n_probe = config.ann_nprobe or ivf.default_nprobe(nlist)
    if n_probe > nlist:
        raise ValueError(
            f"knn.ann.nprobe ({n_probe}) cannot exceed the index's nlist "
            f"({nlist}); accepted values are 1..nlist")
    return nlist, n_probe


def _staged_ann_index(train: EncodedTable, config: KnnConfig
                      ) -> ivf.IvfIndex:
    """Build (or reuse) the IVF index of this train table."""
    nlist, _ = _resolved_ann_params(train, config)
    key = (id(train), nlist, config.ann_iters, config.ann_seed)
    hit = _ANN_INDEX_CACHE.get(key)
    if hit is not None and hit[0] is train:
        return hit[1]
    tr_num, tr_cat, n_bins = _split_features(train)
    index = ivf.build_ivf(tr_num, tr_cat, n_cat_bins=n_bins, nlist=nlist,
                          n_iters=config.ann_iters, seed=config.ann_seed,
                          device=train.device)
    _ANN_INDEX_CACHE.clear()
    _ANN_INDEX_CACHE[key] = (train, index)
    return index


def _neighbors_ann(train: EncodedTable, test: EncodedTable,
                   config: KnnConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-indexed scoring: build or reuse the index of the train table,
    then each test chunk probes its ``n_probe`` nearest lists and runs the
    quantized scan over their rows only. ``knn.ann.live`` queries through
    the live index of the one-slot live cache (rows appended to it in this
    process are probed too; with none, the frozen index's result)."""
    _, n_probe = _resolved_ann_params(train, config)
    if config.ann_live:
        from avenir_tpu_torch.models import live_ann
        live = live_ann.live_index_for(train, config)

        def run(xn, xc):
            return live.query(
                xn, xc, k=config.top_match_count, n_probe=n_probe,
                oversample=config.quantized_oversample,
                qdtype=config.quantized_dtype,
                distance_scale=config.distance_scale)
    else:
        index = _staged_ann_index(train, config)

        def run(xn, xc):
            return ivf.ann_topk(
                index, xn, xc, k=config.top_match_count, n_probe=n_probe,
                oversample=config.quantized_oversample,
                qdtype=config.quantized_dtype,
                distance_scale=config.distance_scale)

    return _feed(run, test, config, train.device)


def _vote_kernel(dist: torch.Tensor, nbr_labels: torch.Tensor,
                 nbr_post: Optional[torch.Tensor], kernel_function: str,
                 kernel_param: int, n_classes: int, class_cond_weighted: bool,
                 inverse_distance_weighted: bool,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel scores + per-class vote: (votes [M, C] f32, scores [M, k]).
    ``valid`` (0/1 [M, k]) weighs out neighbor slots that hold no
    neighbor."""
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
    if valid is not None:
        w = w * valid

    # one neighbor slot at a time: the same summation order for any batch
    votes = torch.zeros((dist.shape[0], n_classes), dtype=torch.float32,
                        device=dist.device)
    for s in range(dist.shape[1]):
        votes = votes + w[:, s:s + 1] * torch.nn.functional.one_hot(
            nbr_labels[:, s].long(), n_classes).to(torch.float32)
    return votes, score


@dataclass
class KnnPrediction:
    predicted: np.ndarray              # [M] class index or regressed int
    class_votes: Optional[np.ndarray]  # [M, C] kernel-weighted votes
    class_prob: Optional[np.ndarray]   # [M, C] int percent (PROB_SCALE)
    neighbor_idx: np.ndarray           # [M, k]
    neighbor_dist: np.ndarray          # [M, k] scaled int
    # [M] f32 regressed values before their int cast (regression only)
    regressed: Optional[np.ndarray] = None


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
    valid = None
    if config.ann:
        # a sparse probe can return fewer than k neighbors, as (INT_BIG,
        # -1) slots: they vote with weight 0 (the gathers read row 0); a
        # query with no neighbor at all has no sound vote and is refused
        found = idx_l >= 0
        if bool((~found.any(dim=1)).any()):
            raise ValueError(
                "knn.ann found no neighbors at all for some queries "
                "(every probed list was empty); raise knn.ann.nprobe or "
                "lower knn.ann.nlist")
        valid = found.to(torch.float32)
        idx_l = torch.clamp(idx_l, min=0)
    nbr_labels = train.labels[idx_l]                              # [M, k]
    nbr_post = None
    use_post = config.class_cond_weighted and feature_post is not None
    if use_post:
        nbr_post = torch.gather(feature_post[idx_l], 2,
                                nbr_labels.long().unsqueeze(-1)).squeeze(-1)
    votes, _ = _vote_kernel(
        dist, nbr_labels, nbr_post, config.kernel_function,
        config.kernel_param, train.n_classes, use_post,
        config.inverse_distance_weighted, valid)
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


def classify_from_neighbors(records, config: KnnConfig, class_values,
                            device: DeviceLike = "cuda"
                            ) -> Tuple[KnnPrediction, list, list]:
    """Classify from precomputed neighbor records, the reference
    TopMatchesMapper's input (NearestNeighbor.java:150-159 plain layout
    ``trainId,testId,rank,trainClass[,testClass]``; :135-149
    class-conditional layout ``testId[,testClass],trainId,rank,trainClass,
    postProb``), so that a pipeline holding sifarish-format distance files
    replays without deriving the distances again.

    ``records``: an iterable of dicts with keys ``test_id``,
    ``train_class`` (name), ``rank`` (scaled-int distance), optional
    ``post`` (the class-conditional probability) and ``test_class``. They
    are grouped by test id (first-seen order) into a bounded heap of the k
    best a test id, the secondary sort and reducer cutoff (:317-348) in
    O(#test ids × k) memory however long the stream, with exactly the tie
    order of ``sorted(...)[:k]``; then the vote and arbitration of
    :func:`classify` run on ``device``. Returns (prediction, test ids in
    order, test classes where present else None)."""
    import heapq
    dev = resolve_device(device)
    k = config.top_match_count
    cls_idx = {c: i for i, c in enumerate(class_values)}
    order: list = []
    groups: dict = {}
    test_cls: dict = {}
    for r in records:
        tid = r["test_id"]
        if tid not in groups:
            groups[tid] = []
            order.append(tid)
        # a min-heap of the negated (rank, class, post) keeps the k smallest
        # with the tie order of sorted(...)[:k]
        neg = (-int(r["rank"]), -cls_idx[r["train_class"]],
               -float(r.get("post") or 0.0))
        g = groups[tid]
        if len(g) < k:
            heapq.heappush(g, neg)
        else:
            heapq.heappushpop(g, neg)
        if r.get("test_class") is not None:
            test_cls[tid] = r["test_class"]
    m = len(order)
    dist = np.zeros((m, k), np.int32)
    labels = np.zeros((m, k), np.int32)
    post = np.zeros((m, k), np.float32)
    valid = np.zeros((m, k), np.float32)
    for i, tid in enumerate(order):
        top = sorted((-a, -b, -c) for a, b, c in groups[tid])
        for j, (d, c, p) in enumerate(top):
            dist[i, j], labels[i, j], post[i, j] = d, c, p
            valid[i, j] = 1.0
    use_post = config.class_cond_weighted and bool(np.any(post > 0))
    votes, _ = _vote_kernel(
        torch.from_numpy(dist).to(dev), torch.from_numpy(labels).to(dev),
        torch.from_numpy(post).to(dev) if use_post else None,
        config.kernel_function, config.kernel_param, len(class_values),
        use_post, config.inverse_distance_weighted,
        valid=torch.from_numpy(valid).to(dev))
    votes_np = votes.cpu().numpy()
    predicted, prob = _decide(votes_np, config, class_values)
    pred = KnnPrediction(predicted=predicted, class_votes=votes_np,
                         class_prob=prob, neighbor_idx=labels,
                         neighbor_dist=dist)
    classes = [test_cls.get(t) for t in order] if test_cls else None
    return pred, order, classes


def regress(train: EncodedTable, test: EncodedTable, config: KnnConfig,
            train_targets: torch.Tensor,
            regr_input: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> KnnPrediction:
    """KNN regression over the neighbors of :func:`neighbors` (K2, or K3
    on the chunked feed, as in classification): ``average`` (the int32
    of the f32 sum, floor-divided by k), ``median``, a per-neighborhood
    ``linearRegression`` (Neighborhood.doRegression :223-250) and
    ``multiLinearRegression``, a ridge-regularized least squares over all
    neighbor features (``lam = 1e-5 · trace / (F + 1) + 1e-6``, solved
    in float64), the fit the reference left as a TODO at
    Neighborhood.java:246-249.

    ``train_targets`` [N] f32 on the train table's device; ``regr_input``
    = (train_x [N], test_x [M]) for the linear mode, or ([N, F], [M, F])
    for the multi-linear one. Sums over the k neighbors run in slot
    order."""
    dist, idx = neighbors(train, test, config)
    if config.ann and bool((idx < 0).any()):
        # a regression folds every slot into its value, so a short
        # neighbor list has no weight-0 escape as the vote has
        raise ValueError(
            "knn.ann returned fewer than top.match.count neighbors for "
            "some queries (the probed lists held too few rows); raise "
            "knn.ann.nprobe, lower knn.ann.nlist, or lower "
            "top.match.count for regression")
    idx_l = idx.long()
    nbr_y = train_targets[idx_l].to(torch.float32)               # [M, k]
    k = nbr_y.shape[1]
    method = config.regression_method
    if method == "average":
        value = _sum(nbr_y, 1)
        pred = torch.div(value.to(torch.int32), k, rounding_mode="floor")
    elif method == "median":
        sorted_y = torch.sort(nbr_y, dim=1).values
        mid = k // 2
        value = (sorted_y[:, mid] if k % 2 == 1
                 else (sorted_y[:, mid - 1] + sorted_y[:, mid]) / 2)
        pred = value.to(torch.int32)
    elif method == "linearRegression":
        if regr_input is None:
            raise ValueError("linearRegression needs regr_input")
        train_x, test_x = regr_input
        nbr_x = train_x[idx_l].to(torch.float32)                 # [M, k]
        # a divisor on the device: CUDA divides by a host scalar through
        # its reciprocal, the CPU does not
        k_t = torch.full((), float(k), dtype=torch.float32,
                         device=nbr_x.device)
        mx = (_sum(nbr_x, 1) / k_t).reshape(-1, 1)
        my = (_sum(nbr_y, 1) / k_t).reshape(-1, 1)
        dx = nbr_x - mx
        sxx = _sum(dx * dx, 1)
        sxy = _sum(dx * (nbr_y - my), 1)
        slope = sxy / torch.where(sxx > 0, sxx, torch.ones_like(sxx))
        intercept = my[:, 0] - slope * mx[:, 0]
        value = intercept + slope * test_x.to(torch.float32)
        pred = value.to(torch.int32)
    elif method == "multiLinearRegression":
        if regr_input is None:
            raise ValueError("multiLinearRegression needs regr_input")
        train_x, test_x = regr_input                             # [N, F]
        if train_x.dim() != 2 or test_x.dim() != 2:
            raise ValueError("multiLinearRegression needs [N, F]/[M, F] "
                             "feature matrices as regr_input")
        # the normal equations and their solve in float64: in f32 the
        # ridge system of raw-scale features loses up to three digits
        # (ROADMAP C8), and the card's and the CPU's solvers lose
        # different ones
        f64 = torch.float64
        nbr_x = train_x[idx_l].to(torch.float32).to(f64)         # [M, k, F]
        ones = torch.ones(nbr_x.shape[:2] + (1,), dtype=f64,
                          device=nbr_x.device)
        a = torch.cat([nbr_x, ones], dim=2)                      # [M, k, F+1]
        ata = torch.einsum("mkf,mkg->mfg", a, a)
        aty = torch.einsum("mkf,mk->mf", a, nbr_y.to(f64))
        # the scale-aware ridge keeps k < F + 1 neighborhoods (and
        # collinear neighbor features) solvable: the minimum-norm fit
        f1 = a.shape[2]
        lam = (1e-5 * torch.diagonal(ata, dim1=1, dim2=2).sum(1) / f1
               + 1e-6).reshape(-1, 1, 1)
        eye = torch.eye(f1, dtype=f64, device=a.device)
        w = torch.linalg.solve(ata + lam * eye, aty.unsqueeze(-1))[..., 0]
        test_aug = torch.cat(
            [test_x.to(torch.float32).to(f64),
             torch.ones((test_x.shape[0], 1), dtype=f64,
                        device=test_x.device)], dim=1)
        value = (test_aug * w).sum(1).to(torch.float32)
        pred = value.to(torch.int32)
    else:
        raise ValueError(f"unknown regression method {method!r}")
    return KnnPrediction(predicted=pred.cpu().numpy(), class_votes=None,
                         class_prob=None, neighbor_idx=idx.cpu().numpy(),
                         neighbor_dist=dist.cpu().numpy(),
                         regressed=value.cpu().numpy())
