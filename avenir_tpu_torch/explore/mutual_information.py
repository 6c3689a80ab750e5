"""Mutual information + feature-subset-selection scores.

Counterpart of ``avenir_tpu/explore/mutual_information.py``. The
reference's MutualInformation MR (MutualInformation.java) emits the
distribution families per row into one shuffle and computes MI variants in
the reducer cleanup (:598-783). Here every family comes from K4's
contingency counts (``ops/histogram.pair_counts_multi``, every feature
pair in one launch), as the JAX package computes them on its accelerator
(``_distributions_pallas``), and the
greedy feature-selection loops (MutualInformationScore.java: MIM :98-101,
MIFS :116-153, JMI :177-179, DISR :185-187, MRMR :265-300) run host-side
over the resulting small matrices, like the reference's reducer.

All features must be binned (categorical or bucketed numeric) — the same
requirement the reference's distribution counting imposes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.ops.infotheory import (entropy, fma,
                                             mutual_information)
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.roadmap import roadmap_item

_MULTI = f"the multi-device layer ({roadmap_item('Multi-device layer')})"


@dataclass
class MiDistributions:
    """The count families (dense, padded to the max bin count), f32."""

    class_counts: np.ndarray          # [C]
    feature: np.ndarray               # [F, B]
    feature_class: np.ndarray         # [F, B, C]
    feature_pair: np.ndarray          # [F, F, B, B]
    feature_pair_class: np.ndarray    # [F, F, B, B, C]
    feature_ordinals: Tuple[int, ...]
    class_values: Tuple[str, ...]


def compute_distributions(table: EncodedTable, mesh=None,
                          mask=None) -> MiDistributions:
    """One pass over the table on its device -> every family.

    ``feature_pair_class[f, g]`` is the pair count of ``bins_f`` and
    ``bins_g·C + label`` reshaped to [B, B, C]: all F² pairs in one launch
    of K4 over the 2F columns. Every other family is an exact-integer
    marginal of it: ``feature_pair`` drops the class axis;
    ``feature_class`` is the diagonal (bin_f == bin_g when f == g) summed
    over the redundant second bin axis; ``feature`` drops the class axis
    from that. The counts are exact integers, so each family equals the JAX
    package's einsum path (``_distribution_kernel``) byte for byte. The
    five families come to the host in one copy (into pinned memory from a
    card).

    A row whose label lies outside [0, C) drops out of the combined id
    (-1), as it drops out of the einsum path's class one-hot; the JAX
    package's combined id would alias a label of -1 into the previous
    bin's last class."""
    if mesh is not None or mask is not None:
        raise ValueError("mesh= and mask= (a row-sharded distribution pass) "
                         f"are not supported by avenir_tpu_torch yet: {_MULTI}"
                         " ports them; run avenir_tpu for this job")
    if any(table.is_continuous):
        raise ValueError("mutual information needs all features binned "
                         "(categorical or bucketWidth numeric)")
    n_f = table.binned.shape[1]
    n_bins = max(table.bins_per_feature)
    n_classes = table.n_classes
    labels = table.labels
    cls = histogram.class_counts(labels, n_classes)
    # [F, N] rows: each column of the table becomes a contiguous id vector
    bins_t = table.binned.T.contiguous()
    valid = (labels >= 0) & (labels < n_classes)
    combined_t = torch.where(valid.reshape(1, -1),
                             bins_t * n_classes + labels.reshape(1, -1),
                             torch.full_like(bins_t, -1))
    pairs = [(f, n_f + g) for f in range(n_f) for g in range(n_f)]
    cards = [n_bins] * n_f + [n_bins * n_classes] * n_f
    fpc = histogram.pair_counts_multi(
        torch.cat([bins_t, combined_t]), pairs, cards) \
        .reshape(n_f, n_f, n_bins, n_bins, n_classes)      # [F, F, B, B, C]
    fp = fpc.sum(dim=-1)                                   # [F, F, B, B]
    fc = torch.stack([fpc[f, f].sum(dim=1) for f in range(n_f)])  # [F, B, C]
    feature = fc.sum(dim=-1)                               # [F, B]
    families = (cls, feature, fc, fp, fpc)
    flat = torch.cat([t.reshape(-1) for t in families])
    host = torch.empty(flat.shape, dtype=flat.dtype,
                       pin_memory=flat.device.type == "cuda")
    host.copy_(flat)
    arrays, start = [], 0
    for t in families:
        arrays.append(host[start:start + t.numel()].numpy().reshape(t.shape))
        start += t.numel()
    return MiDistributions(
        *arrays,
        feature_ordinals=tuple(f.ordinal for f in table.feature_fields),
        class_values=tuple(table.class_values))


@dataclass
class MiScores:
    """The reducer-cleanup outputs (MutualInformation.java:598-783)."""

    feature_class_mi: Dict[int, float]                  # I(Xi; Y)
    feature_pair_mi: Dict[Tuple[int, int], float]       # I(Xi; Xj)
    feature_pair_class_mi: Dict[Tuple[int, int], float]  # I((Xi,Xj); Y)
    feature_pair_class_entropy: Dict[Tuple[int, int], float]  # H(Xi,Xj,Y)
    class_cond_pair_mi: Dict[Tuple[int, int], float]    # I(Xi; Xj | Y)


def compute_scores(d: MiDistributions,
                   device: DeviceLike = "cuda") -> MiScores:
    """One batched f32 call per score family on ``device``
    (``mutual_information`` and ``entropy`` broadcast over leading dims),
    unpacked into the reducer's per-feature/per-pair output dicts
    host-side."""
    dev = resolve_device(device)
    n_f = d.feature.shape[0]
    ords = d.feature_ordinals

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    fc = host(mutual_information(on(d.feature_class)))               # [F]
    fp = host(mutual_information(on(d.feature_pair)))                # [F,F]
    pc = d.feature_pair_class                          # [F, F, B, B, C]
    f1, f2, b1, b2, c = pc.shape
    fpc = host(mutual_information(on(pc.reshape(f1, f2, b1 * b2, c))))
    fpc_ent = host(entropy(on(pc.reshape(f1, f2, b1 * b2 * c))))
    # class-conditional pair MI: sum_c p(c) I(Xi;Xj|c)
    # (XLA's contraction: a fused multiply-add a class, from 0)
    per_class = mutual_information(on(np.moveaxis(pc, -1, 2)))      # [F,F,C]
    weights = on(d.class_counts / max(d.class_counts.sum(), 1))
    ccp = torch.zeros_like(per_class[..., 0])
    for ci in range(per_class.shape[-1]):
        ccp = fma(per_class[..., ci], weights[ci], ccp)
    ccp = host(ccp)

    fc_mi = {ords[i]: float(fc[i]) for i in range(n_f)}
    fp_mi, fpc_mi, fpc_h, ccp_mi = {}, {}, {}, {}
    for i in range(n_f):
        for j in range(i + 1, n_f):
            key = (ords[i], ords[j])
            fp_mi[key] = float(fp[i, j])
            fpc_mi[key] = float(fpc[i, j])
            fpc_h[key] = float(fpc_ent[i, j])
            ccp_mi[key] = float(ccp[i, j])
    return MiScores(fc_mi, fp_mi, fpc_mi, fpc_h, ccp_mi)


# --------------------------------------------------------------------------
# greedy feature-subset-selection algorithms (MutualInformationScore.java)
# --------------------------------------------------------------------------

def _pair_value(pairs: Dict[Tuple[int, int], float], a: int, b: int) -> float:
    return pairs.get((a, b), pairs.get((b, a), 0.0))


def mim(scores: MiScores) -> List[Tuple[int, float]]:
    """Mutual Information Maximization: sort by I(Xi;Y) (:98-101)."""
    return sorted(scores.feature_class_mi.items(), key=lambda kv: -kv[1])


def mifs(scores: MiScores, redundancy_factor: float = 1.0
         ) -> List[Tuple[int, float]]:
    """MIFS: greedily add argmax I(Xi;Y) − β Σ_selected I(Xi;Xs) (:116-153)."""
    selected: List[Tuple[int, float]] = []
    chosen: set = set()
    features = list(scores.feature_class_mi.keys())
    while len(chosen) < len(features):
        best, best_score = None, -np.inf
        for f in features:
            if f in chosen:
                continue
            redundancy = sum(_pair_value(scores.feature_pair_mi, f, s)
                             for s, _ in selected)
            score = scores.feature_class_mi[f] - redundancy_factor * redundancy
            if score > best_score:
                best, best_score = f, score
        selected.append((best, best_score))
        chosen.add(best)
    return selected


def _jmi_disr(scores: MiScores, joint: bool) -> List[Tuple[int, float]]:
    ranked = mim(scores)
    first = ranked[0]
    selected = [first]
    chosen = {first[0]}
    features = list(scores.feature_class_mi.keys())
    while len(chosen) < len(features):
        best, best_score = None, -np.inf
        for f in features:
            if f in chosen:
                continue
            total = 0.0
            for s in chosen:
                val = _pair_value(scores.feature_pair_class_mi, f, s)
                if not joint:
                    h = _pair_value(scores.feature_pair_class_entropy, f, s)
                    val = val / h if h > 0 else 0.0
                total += val
            if total > best_score:
                best, best_score = f, total
        selected.append((best, best_score))
        chosen.add(best)
    return selected


def jmi(scores: MiScores) -> List[Tuple[int, float]]:
    """Joint Mutual Information (:177-179)."""
    return _jmi_disr(scores, joint=True)


def disr(scores: MiScores) -> List[Tuple[int, float]]:
    """Double Input Symmetrical Relevance: JMI normalized by the pair-class
    entropy (:185-241)."""
    return _jmi_disr(scores, joint=False)


def mrmr(scores: MiScores) -> List[Tuple[int, float]]:
    """Min-redundancy max-relevance: I(Xi;Y) − mean_selected I(Xi;Xs)
    (:265-300)."""
    selected: List[Tuple[int, float]] = []
    chosen: set = set()
    features = list(scores.feature_class_mi.keys())
    while len(chosen) < len(features):
        best, best_score = None, -np.inf
        for f in features:
            if f in chosen:
                continue
            relevance = scores.feature_class_mi[f]
            if chosen:
                redundancy = sum(
                    _pair_value(scores.feature_pair_mi, f, s)
                    for s in chosen) / len(chosen)
                score = relevance - redundancy
            else:
                score = relevance
            if score > best_score:
                best, best_score = f, score
        selected.append((best, best_score))
        chosen.add(best)
    return selected


SCORE_ALGORITHMS = {
    "mutualInfoMaximizer": lambda s, **kw: mim(s),
    "mutualInfoFeatureSelection": lambda s, **kw: mifs(
        s, kw.get("redundancy_factor", 1.0)),
    "jointMutualInfo": lambda s, **kw: jmi(s),
    "doubleInputSymmetricalRelevance": lambda s, **kw: disr(s),
    "minRedundancyMaxRelevance": lambda s, **kw: mrmr(s),
}

# the reference's own dotted algorithm names (MutualInformation.java:797-821,
# as configured in resource/hosp.properties) alias the registry entries
SCORE_ALGORITHMS.update({
    "mutual.info.maximization": SCORE_ALGORITHMS["mutualInfoMaximizer"],
    "mutual.info.selection": SCORE_ALGORITHMS["mutualInfoFeatureSelection"],
    "joint.mutual.info": SCORE_ALGORITHMS["jointMutualInfo"],
    "double.input.symmetric.relevance":
        SCORE_ALGORITHMS["doubleInputSymmetricalRelevance"],
    "min.redundancy.max.relevance":
        SCORE_ALGORITHMS["minRedundancyMaxRelevance"],
})
