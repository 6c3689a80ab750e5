"""Naive Bayes on torch tensors.

Counterpart of ``avenir_tpu/models/naive_bayes.py`` (``BayesModel``,
``BayesModelMeta``, ``train``, ``train_streamed``, ``predict``,
``validate``, ``save_model``, ``load_model``). It replaces the
reference's two MR jobs:

- **train** (BayesianDistribution): per-row emits of (classVal, ord, bin)→1
  plus a shuffle and reducer sums become the [C, F, B] joint count tensor
  (kernel K1), with Gaussian sufficient statistics (count/sum/sumSq) for
  continuous features;
- **predict** (BayesianPredictor): Bayes rule ``P(c|x) ∝ featurePostProb ·
  classPrior / featurePrior`` in log space, reported as the reference's
  scaled int percent.

The model wire format is the reference's "empty-column tagged union",
byte for byte what the JAX package writes:

    classVal,ord,bin,count        feature posterior (binned)
    classVal,ord,,mean,stddev     feature posterior (continuous, ints)
    classVal,,,count              class prior
    ,ord,bin,count                feature prior (binned)
    ,ord,,mean,stddev             feature prior (continuous, ints)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.histogram import (
    class_counts, class_feature_bin_counts, feature_bin_counts,
    per_class_moments)
from avenir_tpu_torch.ops.infotheory import (
    _sqrt, fma, xla_exp, xla_log, xla_sum)
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, MetricsRegistry


@dataclass
class BayesModel:
    """Count-space sufficient statistics (f32 tensors on one device)."""

    class_counts: torch.Tensor       # [C]
    post_counts: torch.Tensor        # [C, Fb, B] binned-feature joint counts
    prior_counts: torch.Tensor       # [Fb, B]    binned-feature marginals
    cont_count: torch.Tensor         # [C, Fc]
    cont_sum: torch.Tensor           # [C, Fc]
    cont_sumsq: torch.Tensor         # [C, Fc]

    @property
    def total(self) -> torch.Tensor:
        return self.class_counts.sum()

    def as_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in fields(self)}


@dataclass(frozen=True)
class BayesModelMeta:
    """Static (host-side) companion: names, ordinals, bin labels."""

    class_values: Tuple[str, ...]
    binned_idx: Tuple[int, ...]      # positions of binned features in the table
    cont_idx: Tuple[int, ...]        # positions of continuous features
    feature_ordinals: Tuple[int, ...]  # CSV ordinals, table order
    bin_labels: Tuple[Tuple[str, ...], ...]  # per binned feature
    n_bins: int

    @staticmethod
    def from_table(table: EncodedTable) -> "BayesModelMeta":
        binned_idx = tuple(i for i, c in enumerate(table.is_continuous)
                           if not c)
        cont_idx = tuple(i for i, c in enumerate(table.is_continuous) if c)
        return BayesModelMeta(
            class_values=tuple(table.class_values),
            binned_idx=binned_idx,
            cont_idx=cont_idx,
            feature_ordinals=tuple(f.ordinal for f in table.feature_fields),
            bin_labels=tuple(tuple(table.bin_labels[i]) for i in binned_idx),
            n_bins=max((table.bins_per_feature[i] for i in binned_idx),
                       default=0),
        )


def _split_columns(table: EncodedTable, meta: BayesModelMeta
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(binned [N, Fb] int32, continuous [N, Fc] f32) feature columns."""
    dev = table.device
    binned = (table.binned[:, list(meta.binned_idx)] if meta.binned_idx
              else torch.zeros((table.n_rows, 0), dtype=torch.int32,
                               device=dev))
    cont = (table.numeric[:, list(meta.cont_idx)] if meta.cont_idx
            else torch.zeros((table.n_rows, 0), dtype=torch.float32,
                             device=dev))
    return binned, cont


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def _counts(binned: torch.Tensor, cont: torch.Tensor, labels: torch.Tensor,
            n_classes: int, n_bins: int,
            weights: Optional[torch.Tensor] = None,
            moments: torch.dtype = torch.float32) -> BayesModel:
    """The count tensors of one pass over rows, on their device: the class
    counts, K1's (class, feature, bin) counts, the bin marginals and the
    class moments (f32, or float64 sums for a caller that adds parts)."""
    c_cnt, c_sum, c_sq = per_class_moments(cont, labels, n_classes, weights,
                                           dtype=moments)
    return BayesModel(
        class_counts=class_counts(labels, n_classes, weights),
        post_counts=class_feature_bin_counts(binned, labels, n_classes,
                                             n_bins, weights),
        prior_counts=feature_bin_counts(binned, n_bins, weights),
        cont_count=c_cnt, cont_sum=c_sum, cont_sumsq=c_sq)


def train_metrics(n_rows: int, meta: BayesModelMeta) -> MetricsRegistry:
    """The "Distribution Data" counters a train over ``n_rows`` prints."""
    n_classes = len(meta.class_values)
    metrics = MetricsRegistry()
    metrics.set("Distribution Data", "Records", n_rows)
    metrics.set("Distribution Data", "Class prior", n_classes)
    metrics.set("Distribution Data", "Feature posterior binned",
                len(meta.binned_idx) * n_classes)
    metrics.set("Distribution Data", "Feature posterior cont",
                len(meta.cont_idx) * n_classes)
    return metrics


def train(table: EncodedTable, weights: Optional[torch.Tensor] = None
          ) -> Tuple[BayesModel, BayesModelMeta, MetricsRegistry]:
    """One pass over the table's rows, on the table's device."""
    meta = BayesModelMeta.from_table(table)
    binned, cont = _split_columns(table, meta)
    model = _counts(binned, cont, table.labels, table.n_classes,
                    max(meta.n_bins, 1), weights)
    return model, meta, train_metrics(table.n_rows, meta)


def model_sum(parts: List[dict]) -> dict:
    """Field by field float64 sum of count payloads (``as_numpy`` dicts):
    the cross-window and cross-shard accumulation, exact to 2^53."""
    acc = None
    for part in parts:
        part = {k: np.asarray(v, np.float64) for k, v in part.items()}
        acc = part if acc is None else {k: acc[k] + part[k] for k in acc}
    return acc


def train_streamed(fz, path: str, delim_regex: str = ",",
                   window_bytes: int = 32 << 20, n_threads: int = 0,
                   device: DeviceLike = "cuda"
                   ) -> Tuple[BayesModel, BayesModelMeta, MetricsRegistry]:
    """Out-of-core training: each line-aligned byte window of the file is
    encoded on the host (``native/loader.iter_encoded_windows``), folded
    into the count tensors on ``device`` (K1 once a window, the moments in
    float64) and dropped, so host memory holds the model and one window.
    The windows' counts add up on the host in float64 (exact to 2^53; a
    device f32 accumulator would lose cells past 2^24), so the model
    equals the in-memory train's. A delimiter the native encoder cannot
    take (more than one byte) takes Python windows of ``window_bytes``
    characters of fields, as the JAX package's function does."""
    from avenir_tpu_torch.native import loader

    dev = resolve_device(device)
    meta = None
    parts = []           # each window's counts, summed in float64 at the end
    n_rows = 0

    def fold(binned_np, numeric_np, labels_np):
        nonlocal meta, n_rows
        if meta is None:
            # meta from a zero-row wrap: a real window would build a
            # per-row id list for nothing
            meta = BayesModelMeta.from_table(loader._wrap_table(
                fz, binned_np[:0], numeric_np[:0], labels_np[:0], None,
                "cpu"))
        rows = binned_np.shape[0]
        if rows == 0:
            return
        binned = torch.as_tensor(binned_np[:, list(meta.binned_idx)],
                                 dtype=torch.int32, device=dev)
        cont = torch.as_tensor(numeric_np[:, list(meta.cont_idx)],
                               dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels_np, dtype=torch.int32, device=dev)
        parts.append(_counts(binned, cont, labels, len(meta.class_values),
                             max(meta.n_bins, 1),
                             moments=torch.float64).as_numpy())
        n_rows += rows

    try:
        windows = loader.iter_encoded_windows(
            fz, path, delim_regex, with_labels=True, n_threads=n_threads,
            window_bytes=window_bytes, want_ids=False)
        for binned_np, numeric_np, labels_np, _ids in windows:
            fold(binned_np, numeric_np, labels_np)
    except loader.NativeUnavailable:
        from avenir_tpu_torch.utils.dataset import iter_csv_rows
        pending: list = []
        pending_bytes = 0

        def flush():
            binned_np, numeric_np, labels_np, _ = fz.transform_arrays(
                pending, with_labels=True)
            fold(binned_np, numeric_np, labels_np)

        for row in iter_csv_rows(path, delim_regex):
            pending.append(row)
            pending_bytes += sum(len(c) for c in row)
            if pending_bytes >= window_bytes:
                flush()
                pending, pending_bytes = [], 0
        if pending:
            flush()

    if not parts:
        raise ValueError(f"no rows in {path}")
    return (model_from_numpy(model_sum(parts), dev), meta,
            train_metrics(n_rows, meta))


# --------------------------------------------------------------------------
# predict
# --------------------------------------------------------------------------

_EPS = 1e-30
# jnp.sqrt(2π) as XLA folds it: the f32 square root of f32 2π
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))
_INT32 = (-2.0 ** 31, 2.0 ** 31 - 1)


def _gaussian_logpdf(x, mean, std):
    """``-0.5·z·z − log(std·√(2π))``, ``z = (x − mean) / std``, rounded as
    the JAX package's compiled predictor rounds it: the log XLA's
    (``xla_log``) of the f32 product, the square and the subtraction one
    fused multiply-add."""
    std = torch.clamp(std, min=1e-6)
    z = (x - mean) / std
    log_norm = xla_log(std * torch.full((), _SQRT_2PI, dtype=torch.float32,
                                        device=std.device))
    return fma(z * -0.5, z, -log_norm)


def _moments(count, vsum, vsq):
    """(mean, std) of f32 count/sum/sum-of-squares: the divisions by
    device tensors, ``sumsq/n − mean²`` one fused multiply-add, the square
    root through float64 (each correctly rounded on every device)."""
    cnt = torch.clamp(count, min=1.0)
    mean = vsum / cnt
    var = torch.clamp(fma(-mean, mean, vsq / cnt), min=1e-12)
    return mean, _sqrt(var)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: saturating, NaN to 0 (a plain cast of
    inf differs between the CPU and the GPU)."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.double().clamp(*_INT32).to(torch.int32)


def _predict_kernel(model: BayesModel, binned: torch.Tensor,
                    cont: torch.Tensor, laplace: float = 0.0):
    """Per-row per-class int-percent posterior plus the feature
    prior/posterior probabilities (for output.feature.prob.only mode).

    Every operation rounds as the JAX package's jitted kernel does on the
    CPU (its optimized HLO): XLA's ``log`` and ``exp``, sums over features
    and classes in XLA's order (``xla_sum``), divisions by device tensors,
    so the card's bits equal the CPU's."""
    total = torch.clamp(xla_sum(model.class_counts, 0), min=1.0)
    n_feat_b = model.post_counts.shape[1]
    n_bins = model.post_counts.shape[2]
    dev = binned.device
    f_idx = torch.arange(n_feat_b, device=dev).reshape(1, -1)
    # out-of-range bins (values outside the fit-time range) get zero counts
    valid = (binned >= 0) & (binned < n_bins)
    safe_bins = torch.clamp(binned, 0, n_bins - 1).long()

    # P(x_f | c): gather -> [C, N, Fb]
    post = torch.where(valid.unsqueeze(0),
                       model.post_counts[:, f_idx, safe_bins], 0.0)
    cls = torch.clamp(model.class_counts, min=_EPS).reshape(-1, 1, 1)
    p_post = (post + laplace) / (cls + laplace * n_bins)
    log_post = xla_sum(xla_log(torch.clamp(p_post, min=_EPS)), 2)  # [C, N]

    # P(x_f): [N, Fb]
    prior = torch.where(valid, model.prior_counts[f_idx, safe_bins], 0.0)
    p_prior = (prior + laplace) / (total + laplace * n_bins)
    log_prior = xla_sum(xla_log(torch.clamp(p_prior, min=_EPS)), 1)  # [N]

    # continuous features: class-conditional and marginal Gaussians
    if model.cont_count.shape[1]:
        mean, std = _moments(model.cont_count, model.cont_sum,
                             model.cont_sumsq)                     # [C, Fc]
        log_post = log_post + xla_sum(_gaussian_logpdf(
            cont.unsqueeze(0), mean.unsqueeze(1), std.unsqueeze(1)), 2)
        m_mean, m_std = _moments(*(xla_sum(t, 0) for t in (
            model.cont_count, model.cont_sum, model.cont_sumsq)))  # [Fc]
        log_prior = log_prior + xla_sum(_gaussian_logpdf(
            cont, m_mean.reshape(1, -1), m_std.reshape(1, -1)), 1)

    log_class_prior = xla_log(torch.clamp(model.class_counts / total,
                                          min=_EPS))
    # P(c|x) = postProb * classPrior / featurePrior (BayesianPredictor.java:416)
    log_p = log_post + log_class_prior.reshape(-1, 1) - log_prior.reshape(1, -1)
    pct = _to_int32(torch.floor(xla_exp(log_p) * 100.0)).T        # [N, C]
    if laplace == 0.0 and n_feat_b:
        # a bin with zero marginal count makes the reference compute 0/0
        # -> NaN -> (int)NaN == 0
        row_unseen = (prior == 0).any(dim=1)                        # [N]
        pct = torch.where(row_unseen.reshape(-1, 1), 0, pct)
    feature_post = xla_exp(log_post).T                              # [N, C]
    feature_prior = xla_exp(log_prior)                              # [N]
    return pct, feature_post, feature_prior


@dataclass
class Prediction:
    class_percent: np.ndarray     # [N, C] int percent posteriors
    predicted: np.ndarray         # [N] class indices after arbitration
    prob: np.ndarray              # [N] winning int percent
    ambiguous: Optional[np.ndarray]  # [N] bool, set when diff threshold active
    feature_post: np.ndarray      # [N, C] product of class-cond feature probs
    feature_prior: np.ndarray     # [N]


def predict(model: BayesModel, meta: BayesModelMeta, table: EncodedTable,
            laplace: float = 0.0,
            predicting_classes: Optional[Tuple[str, str]] = None,
            class_cost: Optional[Tuple[int, int]] = None,
            class_prob_diff_threshold: int = -1) -> Prediction:
    """Predict + arbitrate. ``predicting_classes`` is ``bp.predict.class``
    (negative, positive); ``class_cost`` is ``bp.predict.class.cost``
    (falseNegCost, falsePosCost), which switches on cost-based arbitration."""
    binned, cont = _split_columns(table, meta)
    pct_d, fpost_d, fprior_d = _predict_kernel(model, binned, cont, laplace)
    pct = pct_d.cpu().numpy()

    if class_cost is not None:
        if predicting_classes is None:
            if len(meta.class_values) < 2:
                raise ValueError("cost-based arbitration needs binary classes")
            predicting_classes = (meta.class_values[0], meta.class_values[1])
        neg_i = meta.class_values.index(predicting_classes[0])
        pos_i = meta.class_values.index(predicting_classes[1])
        false_neg_cost, false_pos_cost = class_cost
        neg_prob, pos_prob = pct[:, neg_i], pct[:, pos_i]
        # CostBasedArbitrator.arbitrate: pick pos iff posCost < negCost
        neg_cost = false_neg_cost * pos_prob + neg_prob
        pos_cost = false_pos_cost * neg_prob + pos_prob
        predicted = np.where(pos_cost < neg_cost, pos_i, neg_i).astype(np.int64)
        prob = np.full(pct.shape[0], 100, dtype=np.int64)
        ambiguous = None
    else:
        predicted = np.argmax(pct, axis=1)
        prob = pct[np.arange(pct.shape[0]), predicted]
        ambiguous = None
        if class_prob_diff_threshold > 0:
            part = np.sort(pct, axis=1)
            diff = part[:, -1] - part[:, -2] if pct.shape[1] > 1 else part[:, -1]
            ambiguous = diff <= class_prob_diff_threshold

    return Prediction(class_percent=pct, predicted=predicted, prob=prob,
                      ambiguous=ambiguous,
                      feature_post=fpost_d.cpu().numpy(),
                      feature_prior=fprior_d.cpu().numpy())


def validate(pred: Prediction, table: EncodedTable,
             positive_class: Optional[str] = None) -> ConfusionMatrix:
    cm = ConfusionMatrix(table.class_values, positive_class=positive_class)
    cm.update(pred.predicted, table.labels)
    return cm


# --------------------------------------------------------------------------
# wire format
# --------------------------------------------------------------------------

def _cont_stats(count, vsum, vsq) -> Tuple[int, int]:
    cnt = max(float(count), 1.0)
    mean = float(vsum) / cnt
    var = max(float(vsq) / cnt - mean * mean, 0.0)
    return int(round(mean)), int(round(math.sqrt(var)))


def save_model(model: BayesModel, meta: BayesModelMeta, path: str,
               delim: str = ",") -> None:
    arrays = model.as_numpy()
    cls_counts = arrays["class_counts"]
    post = arrays["post_counts"]
    prior = arrays["prior_counts"]
    c_cnt, c_sum, c_sq = (arrays["cont_count"], arrays["cont_sum"],
                          arrays["cont_sumsq"])

    lines: List[str] = []
    for ci, cls in enumerate(meta.class_values):
        # feature posterior, binned
        for bi, fpos in enumerate(meta.binned_idx):
            ordinal = meta.feature_ordinals[fpos]
            for b, label in enumerate(meta.bin_labels[bi]):
                count = int(round(post[ci, bi, b]))
                if count > 0:
                    lines.append(delim.join(
                        [cls, str(ordinal), label, str(count)]))
        # feature posterior, continuous
        for fi, fpos in enumerate(meta.cont_idx):
            ordinal = meta.feature_ordinals[fpos]
            mean, std = _cont_stats(c_cnt[ci, fi], c_sum[ci, fi], c_sq[ci, fi])
            lines.append(delim.join([cls, str(ordinal), "", str(mean),
                                     str(std)]))
        # class prior
        lines.append(delim.join([cls, "", "",
                                 str(int(round(cls_counts[ci])))]))
    # feature prior, binned
    for bi, fpos in enumerate(meta.binned_idx):
        ordinal = meta.feature_ordinals[fpos]
        for b, label in enumerate(meta.bin_labels[bi]):
            count = int(round(prior[bi, b]))
            if count > 0:
                lines.append(delim.join(["", str(ordinal), label, str(count)]))
    # feature prior, continuous
    for fi, fpos in enumerate(meta.cont_idx):
        ordinal = meta.feature_ordinals[fpos]
        mean, std = _cont_stats(c_cnt[:, fi].sum(), c_sum[:, fi].sum(),
                                c_sq[:, fi].sum())
        lines.append(delim.join(["", str(ordinal), "", str(mean), str(std)]))

    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def model_from_numpy(arrays: dict, device: DeviceLike = "cuda"
                     ) -> BayesModel:
    """A :class:`BayesModel` from numpy arrays of its six fields."""
    dev = resolve_device(device)
    return BayesModel(**{
        f.name: torch.tensor(np.asarray(arrays[f.name], np.float32),
                                device=dev)
        for f in fields(BayesModel)})


def load_model(path: str, meta: BayesModelMeta, delim: str = ",",
               device: DeviceLike = "cuda") -> BayesModel:
    """Parse the 4/5-field tagged-union lines back into count tensors.

    Continuous Gaussians round-trip through integer mean/stddev (the
    reference's Long parse), reconstructed as count/sum/sumSq moments.
    """
    n_classes = len(meta.class_values)
    n_binned = len(meta.binned_idx)
    n_cont = len(meta.cont_idx)
    n_bins = max(meta.n_bins, 1)
    cls_counts = np.zeros((n_classes,), np.float32)
    post = np.zeros((n_classes, n_binned, n_bins), np.float32)
    prior = np.zeros((n_binned, n_bins), np.float32)
    cont_mean = np.zeros((n_classes, n_cont), np.float64)
    cont_std = np.zeros((n_classes, n_cont), np.float64)

    cls_index = {c: i for i, c in enumerate(meta.class_values)}
    ord_to_binned = {meta.feature_ordinals[fpos]: bi
                     for bi, fpos in enumerate(meta.binned_idx)}
    ord_to_cont = {meta.feature_ordinals[fpos]: fi
                   for fi, fpos in enumerate(meta.cont_idx)}
    bin_index = [{label: b for b, label in enumerate(labels)}
                 for labels in meta.bin_labels]

    with open(path) as fh:
        for line in fh:
            items = line.rstrip("\n").split(delim)
            if not any(items):
                continue
            if items[0] == "":
                # feature prior; the continuous prior carries no class split,
                # its moments are rebuilt from the posteriors below
                ordinal = int(items[1])
                if items[2] != "":
                    prior[ord_to_binned[ordinal],
                          bin_index[ord_to_binned[ordinal]][items[2]]] = \
                        float(items[3])
            elif items[1] == "" and items[2] == "":
                cls_counts[cls_index[items[0]]] = float(items[3])
            else:
                ci = cls_index[items[0]]
                ordinal = int(items[1])
                if items[2] != "":
                    bi = ord_to_binned[ordinal]
                    post[ci, bi, bin_index[bi][items[2]]] = float(items[3])
                else:
                    fi = ord_to_cont[ordinal]
                    cont_mean[ci, fi] = float(items[3])
                    cont_std[ci, fi] = float(items[4])

    # continuous moments from (count, mean, std): count = class prior count
    c_cnt = np.repeat(cls_counts[:, None], n_cont, axis=1).astype(np.float32)
    c_sum = (c_cnt * cont_mean).astype(np.float32)
    c_sq = (c_cnt * (cont_std ** 2 + cont_mean ** 2)).astype(np.float32)
    return model_from_numpy(
        {"class_counts": cls_counts, "post_counts": post,
         "prior_counts": prior, "cont_count": c_cnt, "cont_sum": c_sum,
         "cont_sumsq": c_sq}, device)
