"""Gradient-boosted histogram trees: Newton rounds on the decision tree's
device growth, in-core and out of core, and the boosted artifact.

Counterpart of ``avenir_tpu/models/boost.py`` with the same names, the
same rounds and the same artifact:

- **second-order channels**: each round turns the current margins into
  fixed-point quanta, ``gq = round((σ(score) − y) · 2^10)`` and
  ``hq = round(σ(1 − σ) · 2^10)``, with σ as XLA computes it on the CPU
  (``ops.infotheory.xla_sigmoid``), so the quanta equal the JAX package's
  and the card's equal the CPU's. A level's channel histogram
  (``ops.histogram.node_channel_bin_sums``) is K1's integer mode run twice
  per chunk of nodes: the hessian quanta over each row's class, the
  gradient quanta over one class. Its cells are int64 sums, exact at any
  row count and in any order (the JAX package's f32 sums are exact below
  2^24 a cell);
- **structure selection** is the tree's ``_level_select`` on the
  hessian-weighted class counts (the class channels × 2^-10), and every
  node's and every selected child's Newton value −G/(H+λ) comes from the
  same segment sums. One round from a constant score is a tree grown with
  constant row weights p(1−p);
- **value tracking**: a row whose route stops at a level takes the value
  of the node it stops at (:func:`_value_level_step`), and the round ends with
  ``score + lr · value`` as one fused multiply-add, as XLA contracts it;
- **records stay on the device** across rounds; one device-to-host copy
  fetches every round's level records at the end (early stopping reads
  one holdout loss a round);
- **out of core** (:func:`grow_boosted_streaming`): one pass over the part
  files keeps each chunk's bins, labels and score on the device, and each
  round is the in-core round over the chunks: every level adds their int64
  channel histograms and advances each chunk's rows one level. Equal to
  in-core growth over the same rows;
- **margins**: a host walk, or every tree routed on the table's device
  through the forest's stacked router in ``mode="sum"``.

Binary classification only (log-odds of class index 1). Artifact: the
forest JSON family with ``kind: "boosted"``, the same bytes as the JAX
package's. Entry points run on the device of the table they are given
(streamed growth on the featurizer's device).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.models import forest as F
from avenir_tpu_torch.models import tree as T
from avenir_tpu_torch.models.tree import TreeConfig, TreeNode
from avenir_tpu_torch.ops import histogram as hg
from avenir_tpu_torch.ops import infotheory as it
from avenir_tpu_torch.utils.atomicio import atomic_json_dump
from avenir_tpu_torch.utils.dataset import EncodedTable

#: fixed-point scale of the gradient and hessian quanta: |gq| ≤ 2^10,
#: hq ≤ 2^8; a power of two, so the unscale after the sums is exact
_Q = 1024.0


@dataclass(frozen=True)
class BoostConfig:
    n_rounds: int = 10                    # forest.boost.num.rounds
    learning_rate: float = 0.3            # forest.boost.learning.rate
    base_score: float = 0.0               # forest.boost.base.score
    reg_lambda: float = 1.0               # forest.boost.reg.lambda
    # forest.boost.early.stop.rounds: > 0 holds out every
    # round(1/holdout_fraction)-th training row, scores it after every
    # round and stops once its logloss has not improved for this many
    # rounds, keeping the ensemble up to the best round. 0 = off.
    early_stop_rounds: int = 0            # forest.boost.early.stop.rounds
    holdout_fraction: float = 0.2         # forest.boost.early.stop.holdout
    tree: TreeConfig = field(default_factory=TreeConfig)


def _validate_boost_config(config: BoostConfig) -> None:
    """Every invalid combination raises naming the key and the accepted
    values; nothing is clamped."""
    if not isinstance(config.n_rounds, int) or isinstance(
            config.n_rounds, bool) or config.n_rounds < 1:
        raise ValueError(
            f"n_rounds must be an int >= 1, got {config.n_rounds!r}")
    lr = config.learning_rate
    if not isinstance(lr, (int, float)) or isinstance(lr, bool) or not (
            np.isfinite(lr) and 0.0 < lr <= 1.0):
        raise ValueError(
            f"learning_rate must be a finite number in (0, 1], got {lr!r}")
    bs = config.base_score
    if not isinstance(bs, (int, float)) or isinstance(
            bs, bool) or not np.isfinite(bs):
        raise ValueError(
            f"base_score must be a finite number (a log-odds margin), "
            f"got {bs!r}")
    rl = config.reg_lambda
    if not isinstance(rl, (int, float)) or isinstance(rl, bool) or not (
            np.isfinite(rl) and rl >= 0.0):
        raise ValueError(
            f"reg_lambda must be a finite number >= 0, got {rl!r}")
    es = config.early_stop_rounds
    if not isinstance(es, int) or isinstance(es, bool) or es < 0:
        raise ValueError(
            "forest.boost.early.stop.rounds must be an int >= 0 "
            f"(0 = off), got {es!r}")
    if es:
        hf = config.holdout_fraction
        if not isinstance(hf, (int, float)) or isinstance(hf, bool) \
                or not (np.isfinite(hf) and 0.0 < hf <= 0.5):
            raise ValueError(
                "forest.boost.early.stop.holdout must be a fraction in "
                f"(0, 0.5], got {hf!r}")
    if config.tree.split_selection_strategy != "best":
        raise ValueError(
            "tree.split_selection_strategy must be 'best' for boosting "
            f"(got {config.tree.split_selection_strategy!r}; randomFromTop "
            "consumes host randomness per node, which a device-resident "
            "round cannot)")
    if config.tree.max_depth < 1:
        raise ValueError(
            f"tree.max_depth must be >= 1, got {config.tree.max_depth}")


def _require_binary(n_classes: int) -> None:
    if n_classes != 2:
        raise ValueError(
            f"boosting supports binary classification (2 classes) only, "
            f"got {n_classes}: the leaf values are log-odds margins for "
            "the positive class (class index 1)")


# --------------------------------------------------------------------------
# a round: quanta → channel histograms → selection → Newton values
# --------------------------------------------------------------------------

def _channels(labels: torch.Tensor, score: torch.Tensor):
    """The logistic objective's fixed-point quanta of every row, ([N] f32
    hessian quanta ``round(p(1−p)·2^10)``, [N] f32 gradient quanta
    ``round((p−y)·2^10)``), integers in f32, ``p = σ(score)`` as XLA's
    CPU code computes it. The JAX package's [N, C+1] channel matrix is
    ``onehot(label) · hq`` beside ``gq``."""
    p = it.xla_sigmoid(score)
    y01 = (labels == 1).to(torch.float32)
    gq = torch.round((p - y01) * _Q)
    hq = torch.round(p * (1.0 - p) * _Q)
    return hq, gq


def _newton_values(g: torch.Tensor, h: torch.Tensor,
                   reg_lambda: torch.Tensor) -> torch.Tensor:
    """−G/(H+λ), 0 where H + λ is 0 (no rows and λ = 0)."""
    denom = h + reg_lambda
    ok = denom > 0
    return torch.where(ok, -g / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(g))


def _boost_level_select(hist_cc: torch.Tensor, cand, reg_lambda, *,
                        n_classes: int, algorithm: str, min_node_size: int,
                        min_gain: float) -> dict:
    """A level's selection and Newton values from its int64 channel
    histogram [A, K, B, C+1]: the class channels × 2^-10 go to the tree's
    selection (structure search on hessian-weighted class counts), and
    the segment sums of the same candidates give every node's value
    (``node_val`` [K]) and every selected child's (``child_val`` [K, S])."""
    cc = T._counts_from_hist(hist_cc, cand)               # [T, S, K, D] i64
    rec = T._level_select(
        cc[..., :n_classes].to(torch.float32) * (1.0 / _Q),
        algorithm=algorithm, min_node_size=min_node_size, min_gain=min_gain)
    node_tot = cc[0].sum(dim=0)                           # [K, D]
    rec["node_val"] = _newton_values(
        node_tot[:, n_classes].to(torch.float32) * (1.0 / _Q),
        node_tot[:, :n_classes].sum(dim=1).to(torch.float32) * (1.0 / _Q),
        reg_lambda)
    k_nodes = cc.shape[2]
    child = cc.permute(2, 0, 1, 3)[torch.arange(k_nodes, device=cc.device),
                                   rec["best_t"]]       # [K, S, D]
    rec["child_val"] = _newton_values(
        child[..., n_classes].to(torch.float32) * (1.0 / _Q),
        child[..., :n_classes].sum(dim=-1).to(torch.float32) * (1.0 / _Q),
        reg_lambda)
    return rec


def _value_level_step(node_id, row_w, value_row, rec, cand, *, k_next: int,
                      is_last: bool):
    """One level of value tracking beside the routing: a row whose route
    stops here takes its node's own value when the node did not split,
    its child's when the child is a leaf, and at the last level every row
    still alive takes its child's. Returns the next (node_id, row_w,
    value_row)."""
    alive = row_w > 0
    t_row = rec["best_t"][node_id]
    col_row = cand.col_of_t[t_row]
    bin_row = cand.bins_rows.gather(1, col_row[:, None])[:, 0].long()
    seg_row = cand.seg_of_bin.reshape(-1)[t_row * cand.b_max + bin_row]
    child_val_row = rec["child_val"].reshape(-1)[node_id * cand.s_max
                                                 + seg_row]
    new_node, new_w = T._route_level_hist(
        node_id, row_w, rec["best_t"], rec["child_slot"].reshape(-1), cand,
        k_next=k_next)
    stopped = alive & (new_w <= 0)
    value_row = torch.where(
        stopped, torch.where(rec["split"][node_id], child_val_row,
                             rec["node_val"][node_id]), value_row)
    if is_last:
        value_row = torch.where(alive & (new_w > 0), child_val_row,
                                value_row)
    return new_node, new_w, value_row


def _level_sums(cand, labels, node_id, hq, gq, row_w, k_nodes: int,
                n_classes: int) -> torch.Tensor:
    """A level's [A, K, B, C+1] int64 channel histogram of the rows alive
    at it (the quanta times the 0/1 routing weights)."""
    return hg.node_channel_bin_sums(
        cand.bins_rows, node_id, labels, hq * row_w, gq * row_w, k_nodes,
        cand.b_max, n_classes, max_abs_weight=_Q)


def _boost_round(parts, cand, reg_lambda, learning_rate, *, depth: int,
                 n_classes: int, algorithm: str, min_node_size: int,
                 min_gain: float, node_budget: int):
    """One boosting round on the device, with no host synchronization, over
    the rows of ``parts``: (candidates holding the part's bins, labels,
    routing weights ``row_w0``, ``hist_mask``, score) for each part, the
    whole table in core or one chunk each when streamed. Quanta from each
    part's score; at each of ``depth`` levels the parts' int64 channel
    histograms add, selection and Newton values run once on the sum, and
    each part's rows take a value-tracked routing step, their (node id,
    routing weight, value) carried to the next level; then the score
    update ``fma(lr, value, score)``. Returns (each part's new score, the
    level records).

    ``row_w0`` is the routing weight (0 stops a row); ``hist_mask`` also
    takes a row out of every histogram while it still routes to a leaf and
    takes a value, as the early-stopping holdout rows do."""
    state = []
    for _cand, labels, row_w0, hist_mask, score in parts:
        hq, gq = _channels(labels, score)
        state.append([torch.zeros(labels.shape[0], dtype=torch.int64,
                                  device=labels.device),
                      row_w0, torch.zeros_like(score),
                      hq * hist_mask, gq * hist_mask])
    records = []
    widths = T._level_widths(depth, cand.s_max, node_budget)
    for d in range(depth):
        hist = None
        for (part_cand, labels, *_), (node_id, row_w, _v, hq, gq) in zip(
                parts, state):
            h = _level_sums(part_cand, labels, node_id, hq, gq, row_w,
                            widths[d], n_classes)
            hist = h if hist is None else hist + h
        rec = _boost_level_select(
            hist, cand, reg_lambda, n_classes=n_classes, algorithm=algorithm,
            min_node_size=min_node_size, min_gain=min_gain)
        for (part_cand, *_), st in zip(parts, state):
            st[:3] = _value_level_step(
                *st[:3], rec, part_cand,
                k_next=min(widths[d] * cand.s_max, node_budget),
                is_last=(d == depth - 1))
        records.append(rec)
    return ([it.fma(learning_rate, st[2], part[4])
             for part, st in zip(parts, state)], records)


# --------------------------------------------------------------------------
# host assembly and the model
# --------------------------------------------------------------------------

def _build_boost_tree(records, keys, class_values: List[str],
                      n_classes: int) -> TreeNode:
    """``tree._build_tree`` with the Newton values: a node with a record
    carries its own ``node_val``, a leaf child its parent record's
    ``child_val`` (what :func:`_value_level_step` gave its rows).
    ``class_counts`` are the hessian-weighted counts selection ran on."""

    def build(level: int, slot: int, counts: np.ndarray,
              value: float) -> Optional[TreeNode]:
        if counts.sum() <= 0:
            return None
        node = TreeNode(class_counts=counts, class_values=class_values,
                        leaf_value=float(np.float32(value)))
        if slot < 0 or level >= len(records):
            return node
        rec = records[level]
        node.leaf_value = float(np.float32(rec["node_val"][slot]))
        if not bool(rec["split"][slot]):
            return node
        t = int(rec["best_t"][slot])
        attr, key, n_seg = keys[t]
        node.attr_ordinal, node.split_key = attr, key
        for s in range(n_seg):
            child = build(level + 1, int(rec["child_slot"][slot, s]),
                          np.asarray(rec["child_counts"][slot, s]),
                          float(rec["child_val"][slot, s]))
            if child is not None:
                node.children[s] = child
        return node

    root_counts = np.asarray(records[0]["child_counts"][0]).sum(axis=0)
    root = build(0, 0, root_counts, float(records[0]["node_val"][0]))
    if root is None:
        root = TreeNode(class_counts=np.zeros(n_classes),
                        class_values=class_values, leaf_value=0.0)
    return root


def _assemble(rounds, widths, cfg: TreeConfig, keys, class_values,
              n_classes: int) -> List[TreeNode]:
    """Every round's level records to the host in one copy, each round's
    frontier budget checked, and the trees built."""
    depth = len(rounds[0])
    flat = T._fetch_records([rec for records in rounds for rec in records])
    trees = []
    for r in range(len(rounds)):
        records = flat[r * depth:(r + 1) * depth]
        T._check_frontier_budget(records, widths, cfg.device_node_budget,
                                 "raise the budget or lower max_depth")
        trees.append(_build_boost_tree(records, keys, class_values,
                                       n_classes))
    return trees


@dataclass
class BoostedModel:
    """The boosted ensemble: margin(x) = base_score + learning_rate ·
    Σ trees' routed leaf values; class 1 iff the margin is positive."""
    trees: List[TreeNode]
    class_values: List[str]
    base_score: float
    learning_rate: float
    reg_lambda: float = 1.0
    # the rounds an early-stopped fit kept (None without early stopping),
    # written to the artifact as roundsUsed
    rounds_used: Optional[int] = None

    def margins(self, table: EncodedTable,
                device: bool = False) -> np.ndarray:
        """[N] f32 log-odds margins by a host walk of each tree, or with
        ``device=True`` every tree routed on the table's device and the
        routed values summed there (the same classes; the margins agree to
        the f32 order of that sum)."""
        F._validate_trees(self.trees)
        if device:
            return self._margins_device(table)
        acc = np.zeros(table.n_rows, np.float32)
        seg_cache: Dict = {}
        for tree in self.trees:
            acc += _tree_values_host(tree, table, seg_cache)
        return (np.float32(self.base_score)
                + np.float32(self.learning_rate) * acc)

    def _margins_device(self, table: EncodedTable) -> np.ndarray:
        (segs, oks, split_of_b, child_b, _pred_b, val_b, valid, depth,
         s_w) = F._stack_route_tables(self.trees, table)
        out, ok = F._route_forest(
            segs, oks, split_of_b, child_b, val_b, valid, depth=depth,
            s_width=s_w, n_classes=len(self.class_values), mode="sum")
        host = torch.cat([out, ok.to(torch.float32)[None]]).cpu().numpy()
        if not host[-1]:
            raise ValueError("split segment not found for some value")
        return (np.float32(self.base_score)
                + np.float32(self.learning_rate) * host[:-1])

    def predict(self, table: EncodedTable,
                device: bool = False) -> np.ndarray:
        """[N] class indices (0/1): the margins thresholded at 0."""
        return (self.margins(table, device=device) > 0).astype(np.int64)


def _tree_values_host(tree: TreeNode, table: EncodedTable,
                      seg_cache: Dict) -> np.ndarray:
    """One tree's routed leaf value of every row by a host walk; a segment
    with no trained child takes the node's own value (as the device
    routing's stay-put does)."""
    out = np.zeros(table.n_rows, np.float32)

    def val(n: TreeNode) -> np.float32:
        return np.float32(0.0 if n.leaf_value is None else n.leaf_value)

    def walk(node: TreeNode, rows: np.ndarray):
        if node.is_leaf or not node.children:
            out[rows] = val(node)
            return
        key = (node.attr_ordinal, node.split_key)
        if key not in seg_cache:
            seg_cache[key] = T.segment_of_rows(table, *key)
        segs = seg_cache[key][rows]
        known = np.isin(segs, list(node.children.keys()))
        out[rows[~known]] = val(node)
        for seg, child in node.children.items():
            sel = rows[segs == seg]
            if sel.size:
                walk(child, sel)

    walk(tree, np.arange(table.n_rows))
    return out


# --------------------------------------------------------------------------
# in-core training
# --------------------------------------------------------------------------

def build_boost_catalog(table: EncodedTable, tree_cfg) -> tuple:
    """(attribute split plans, the device candidates every round scans):
    the binned catalog, built once a fit."""
    attrs = list(tree_cfg.split_attributes) or T.splittable_ordinals(table)
    plans = T._attr_plans(table, attrs, tree_cfg.max_cat_attr_split_groups)
    if not plans:
        raise ValueError("no splittable attributes for boosting")
    return plans, T._device_candidates(table, plans)


def _holdout_logloss(score: torch.Tensor, idx: torch.Tensor,
                     y01: torch.Tensor) -> float:
    """Mean logistic loss ``softplus(s) − y·s`` of the holdout rows' margins
    (the objective the rounds descend), summed in float64 and scaled by
    the f32 reciprocal of the count, as XLA scales its sum. The margins
    come to the host in one copy and the loss is computed there, so that
    the early-stopping decision does not hang on a device's ``log1p``."""
    s = score[idx].cpu()
    y01 = y01.cpu()
    total = (it.xla_softplus(s) - y01 * s).double().sum().float()
    return float(total * np.float32(1.0 / idx.shape[0]))


def _holdout_split(n_rows: int, fraction: float) -> np.ndarray:
    """Every ``round(1/fraction)``-th row (stride at least 2, so that both
    sides are non-empty from 2 rows on): seed-free, so that a stopped
    ensemble is a prefix of the same config run to the end."""
    step = max(int(round(1.0 / fraction)), 2)
    return (np.arange(n_rows) % step) == 0


def _device_scalar(x: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def grow_boosted(table: EncodedTable, config: BoostConfig,
                 catalog: tuple = None) -> BoostedModel:
    """``n_rounds`` Newton rounds on the table's device over one binned
    catalog (``catalog`` may pass it prebuilt), the score kept on the
    device from round to round and every round's records fetched in one
    copy at the end.

    With ``early_stop_rounds`` > 0 the strided holdout rows leave every
    histogram but keep routing (their margins advance), each round reads
    their logloss, and the fit stops after that many rounds without
    improvement, keeping the trees up to the best round (``rounds_used``):
    the first ``rounds_used`` trees of the same config run to the end."""
    _validate_boost_config(config)
    _require_binary(table.n_classes)
    cfg = config.tree
    if catalog is None:
        catalog = build_boost_catalog(table, cfg)
    _plans, cand = catalog
    dev = T._table_device(table)

    score = torch.full((table.n_rows,), np.float32(config.base_score),
                       dtype=torch.float32, device=dev)
    row_w0 = torch.ones(table.n_rows, dtype=torch.float32, device=dev)
    hist_mask = row_w0
    es_rounds = config.early_stop_rounds
    if es_rounds:
        hmask = _holdout_split(table.n_rows, config.holdout_fraction)
        if hmask.all():
            raise ValueError(
                "forest.boost.early.stop.rounds needs >= 2 training "
                f"rows to carve a holdout, got {table.n_rows}")
        hist_mask = torch.from_numpy(
            np.where(hmask, 0.0, 1.0).astype(np.float32)).to(dev)
        h_idx = torch.from_numpy(np.nonzero(hmask)[0]).to(dev)
        h_y01 = (table.labels[h_idx] == 1).to(torch.float32).cpu()
    reg = _device_scalar(config.reg_lambda, dev)
    lr = _device_scalar(config.learning_rate, dev)
    rounds = []
    best_loss, best_round, stale = math.inf, -1, 0
    for r in range(config.n_rounds):
        (score,), records = _boost_round(
            [(cand, table.labels, row_w0, hist_mask, score)], cand, reg, lr,
            depth=cfg.max_depth, n_classes=table.n_classes,
            algorithm=cfg.algorithm, min_node_size=cfg.min_node_size,
            min_gain=cfg.min_gain, node_budget=cfg.device_node_budget)
        rounds.append(records)
        if es_rounds:
            loss = _holdout_logloss(score, h_idx, h_y01)
            if loss < best_loss:
                best_loss, best_round, stale = loss, r, 0
            else:
                stale += 1
                if stale >= es_rounds:
                    break
    if es_rounds:
        rounds = rounds[:best_round + 1]
    widths = T._level_widths(cfg.max_depth, cand.s_max,
                             cfg.device_node_budget)
    trees = _assemble(rounds, widths, cfg, cand.keys, table.class_values,
                      table.n_classes)
    return BoostedModel(trees=trees,
                        class_values=list(table.class_values),
                        base_score=float(config.base_score),
                        learning_rate=float(config.learning_rate),
                        reg_lambda=float(config.reg_lambda),
                        rounds_used=len(trees) if es_rounds else None)


# --------------------------------------------------------------------------
# out-of-core training: chunks kept on the device, int64 channel folds
# --------------------------------------------------------------------------

def grow_boosted_streaming(fz, paths: Sequence[str], config: BoostConfig,
                           *, delim_regex: str = ",",
                           loader_kwargs: Optional[dict] = None
                           ) -> BoostedModel:
    """Boosting out of core on ``fz.device``: ONE pass over the part files
    through ``PrefetchLoader`` keeps each chunk's bins (binned on the host
    as ``forest._chunk_bins_host`` bins them), labels and score on the
    device, and each round is :func:`_boost_round` over the chunks: every
    level adds the chunks' int64 channel histograms, selects once on the
    sum and advances each chunk's rows one level. The trees and leaf values equal :func:`grow_boosted`'s
    over the concatenated rows. ``fz`` must be fitted (the first non-empty
    chunk defines the catalog). Early stopping is refused, as the JAX
    package refuses it here."""
    from avenir_tpu_torch.native.prefetch import PrefetchLoader
    _validate_boost_config(config)
    if config.early_stop_rounds:
        raise ValueError(
            "forest.boost.early.stop.rounds is not supported by the "
            "streaming trainer: the per-round holdout scoring would "
            "re-stream every cached chunk's score slice per round — use "
            "the in-core path, or drop the early-stop key (0 = off)")
    if not paths:
        raise ValueError("no part files to stream")
    loader_kwargs = dict(loader_kwargs or {})
    cfg = config.tree
    dev = fz.device

    first = None
    for path in paths:
        first = next(iter(PrefetchLoader(
            fz, [path], delim_regex=delim_regex, **loader_kwargs)), None)
        if first is not None and first.n_rows > 0:
            break
    if first is None or first.n_rows == 0:
        raise ValueError("streamed part files produced no rows")
    _require_binary(first.n_classes)
    attrs = (list(cfg.split_attributes)
             or sorted(T.splittable_ordinals(first)))
    plans = T._attr_plans(first, tuple(attrs),
                          cfg.max_cat_attr_split_groups)
    if not plans:
        raise ValueError("no splittable attributes for boosting")
    cand = T._device_candidates(first, plans)
    cand = replace(cand, col_of_t=cand.col_of_t.to(dev),
                   seg_of_bin=cand.seg_of_bin.to(dev))
    specs = F._chunk_bin_specs(first, plans)

    # the one streaming pass: (candidates with the chunk's bins, labels,
    # routing weights, histogram mask, score) of every chunk, on the device
    chunks: List[list] = []
    for chunk in PrefetchLoader(fz, list(paths), delim_regex=delim_regex,
                                **loader_kwargs):
        if chunk.n_rows == 0:
            continue
        bins_c = torch.from_numpy(F._chunk_bins_host(chunk, specs)).to(dev)
        ones = torch.ones(chunk.n_rows, dtype=torch.float32, device=dev)
        chunks.append([replace(cand, bins_rows=bins_c),
                       chunk.labels.to(dev), ones, ones,
                       torch.full((chunk.n_rows,),
                                  np.float32(config.base_score),
                                  dtype=torch.float32, device=dev)])
    if not chunks:
        raise ValueError("streamed part files produced no rows")

    widths = T._level_widths(cfg.max_depth, cand.s_max,
                             cfg.device_node_budget)
    reg = _device_scalar(config.reg_lambda, dev)
    lr = _device_scalar(config.learning_rate, dev)
    rounds = []
    for _ in range(config.n_rounds):
        scores, records = _boost_round(
            chunks, cand, reg, lr, depth=cfg.max_depth,
            n_classes=first.n_classes, algorithm=cfg.algorithm,
            min_node_size=cfg.min_node_size, min_gain=cfg.min_gain,
            node_budget=cfg.device_node_budget)
        for entry, score in zip(chunks, scores):
            entry[4] = score
        rounds.append(records)
    trees = _assemble(rounds, widths, cfg, cand.keys, first.class_values,
                      first.n_classes)
    return BoostedModel(trees=trees,
                        class_values=list(first.class_values),
                        base_score=float(config.base_score),
                        learning_rate=float(config.learning_rate),
                        reg_lambda=float(config.reg_lambda))


# --------------------------------------------------------------------------
# artifact
# --------------------------------------------------------------------------

def save_boosted(model: BoostedModel, path: str) -> None:
    """Rename-atomic dump in the ensemble JSON family, ``kind:
    "boosted"`` (the bagged loader refuses it by kind), with
    ``roundsUsed`` when early stopping ran."""
    F._validate_trees(model.trees)
    payload = {"format": F.ARTIFACT_FORMAT, "kind": "boosted",
               "classValues": model.class_values,
               "baseScore": model.base_score,
               "learningRate": model.learning_rate,
               "regLambda": model.reg_lambda,
               "trees": [t.to_dict() for t in model.trees]}
    if model.rounds_used is not None:
        payload["roundsUsed"] = int(model.rounds_used)
    atomic_json_dump(payload, path)


def model_from_payload(payload: dict, path: str = "<dict>") -> BoostedModel:
    """The model of an artifact's JSON object; a bagged forest's, or an
    unknown format, is refused naming both kinds."""
    F.check_artifact_kind(payload, expect="boosted", path=path)
    class_values = list(payload["classValues"])
    return BoostedModel(
        trees=[TreeNode.from_dict(d, class_values)
               for d in payload["trees"]],
        class_values=class_values,
        base_score=float(payload["baseScore"]),
        learning_rate=float(payload["learningRate"]),
        reg_lambda=float(payload.get("regLambda", 1.0)),
        rounds_used=(int(payload["roundsUsed"])
                     if "roundsUsed" in payload else None))


def load_boosted(path: str) -> BoostedModel:
    with open(path) as fh:
        return model_from_payload(json.load(fh), path)


# ---------------------------------------------------------------------------
# engine serving: routing tables of a fixed shape and the batch's margins
# ---------------------------------------------------------------------------

def _serving_specs(table: EncodedTable):
    """For each splittable attribute, in ordinal order (the serving column
    order): (ordinal, feature position, is_cat, numeric grid or None,
    n_bins). Shapes downstream depend on this alone, that is on the
    schema, never on a fitted model."""
    ord_to_pos = {f.ordinal: i for i, f in enumerate(table.feature_fields)}
    specs = []
    for attr in sorted(T.splittable_ordinals(table)):
        pos = ord_to_pos[attr]
        f = table.feature_fields[pos]
        if f.is_categorical:
            specs.append((attr, pos, True, None,
                          len(table.bin_labels[pos])))
        else:
            grid = np.asarray(T.numeric_grid(f), np.float64)
            specs.append((attr, pos, False, grid, int(grid.shape[0]) + 1))
    return specs


def serving_bins(table: EncodedTable) -> np.ndarray:
    """[N, A] int32 bin ids in serving column order, on the host, by the
    training catalog's rule: a numeric bin is the count of grid points
    strictly below the f32 value, a categorical bin its vocabulary code."""
    binned = table.binned.cpu().numpy()
    numeric = table.numeric.cpu().numpy()
    cols = []
    for _attr, pos, is_cat, grid, _n_b in _serving_specs(table):
        if is_cat:
            cols.append(np.asarray(binned[:, pos], np.int32))
        else:
            col = np.asarray(numeric[:, pos], np.float32)
            cols.append(np.sum(
                col[:, None] > grid.astype(np.float32)[None, :],
                axis=1).astype(np.int32))
    return np.stack(cols, axis=1)


def serving_tables(model: BoostedModel, table: EncodedTable, *,
                   rounds_budget: Optional[int] = None,
                   node_budget: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """The ensemble flattened into a dict of tensors whose every shape is
    a function of (schema, rounds_budget, node_budget) alone, so a
    retrained model's tables pass ``install_state``'s structure and shape
    check however its trees differ, and swap in between batches.
    Routing goes by bins: for each node in BFS order, ``seg_of_bin`` maps
    a row's bin id to the node's child segment and ``child`` maps the
    segment to a child slot, −1 to stay (leaves, padding and segments
    training never produced: the node's own value is then the host
    predictor's fallback for an unseen segment). ``base`` and ``lr`` are
    0-d f32 tensors. The tables live on the table's device."""
    dev = table.device
    specs = _serving_specs(table)
    col_of_attr = {attr: a for a, (attr, *_rest) in enumerate(specs)}
    b_max = max(n_b for *_head, n_b in specs)
    sw = b_max  # numeric segments <= points + 1 <= n_bins; groups <= vocab

    per_tree = []
    for tree in model.trees:
        nodes: List[TreeNode] = []
        frontier = [tree]
        while frontier:
            nxt = []
            for n in frontier:
                nodes.append(n)
                nxt.extend(v for _k, v in sorted(n.children.items()))
            frontier = nxt
        per_tree.append(nodes)

    kt = F._pow2(rounds_budget if rounds_budget is not None
                 else max(1, len(model.trees)))
    if len(model.trees) > kt:
        raise ValueError(
            f"boosted model has {len(model.trees)} rounds but the serving "
            f"rounds budget holds {kt}; raise rounds_budget")
    nn = F._pow2(node_budget if node_budget is not None
                 else max([1] + [len(ns) for ns in per_tree]))
    if any(len(ns) > nn for ns in per_tree):
        raise ValueError(
            f"a boosted tree has {max(len(ns) for ns in per_tree)} nodes "
            f"but the serving node budget holds {nn}; raise node_budget")

    split_col = np.zeros((kt, nn), np.int32)
    sob = np.zeros((kt, nn, b_max), np.int32)
    child = np.full((kt, nn * sw), -1, np.int32)
    value = np.zeros((kt, nn), np.float32)
    valid = np.zeros(kt, np.float32)
    for t_i, nodes in enumerate(per_tree):
        valid[t_i] = 1.0
        slot_of = {id(n): k for k, n in enumerate(nodes)}
        for k, n in enumerate(nodes):
            value[t_i, k] = np.float32(
                0.0 if n.leaf_value is None else n.leaf_value)
            if n.split_key is None:
                continue
            a = col_of_attr[n.attr_ordinal]
            split_col[t_i, k] = a
            _attr, _pos, is_cat, grid, n_b = specs[a]
            if is_cat:
                vocab = table.bin_labels[specs[a][1]]
                for gi, grp in enumerate(
                        T.parse_categorical_split_key(n.split_key)):
                    for v in grp:
                        sob[t_i, k, vocab.index(v)] = gi
            else:
                points = np.asarray(
                    [int(p) for p in n.split_key.split(T.SPLIT_SEP)],
                    np.float64)
                edges = np.concatenate([[-np.inf], grid])
                sob[t_i, k, :n_b] = np.sum(
                    points[None, :] <= edges[:n_b, None], axis=1)
            for seg, ch in n.children.items():
                child[t_i, k * sw + int(seg)] = slot_of[id(ch)]
    return {"split_col": torch.from_numpy(split_col).to(dev),
            "seg_of_bin": torch.from_numpy(sob).to(dev),
            "child": torch.from_numpy(child).to(dev),
            "value": torch.from_numpy(value).to(dev),
            "valid": torch.from_numpy(valid).to(dev),
            "base": torch.tensor(np.float32(model.base_score), device=dev),
            "lr": torch.tensor(np.float32(model.learning_rate), device=dev)}


def _serve_margins(tables: Dict[str, torch.Tensor], bins: torch.Tensor, *,
                   depth: int):
    """[M, A] bin ids (a tensor on the tables' device) -> ([M] f32
    margins, [M] int32 class indices), every tree of the batch routed
    together by gathers, with nothing read back to the host. ``depth`` is
    a cap, not the trees' depth: a step past a leaf reads child −1 and
    stays, so one cap serves every retrained model whose trees fit under
    it. The trees' values add in the order XLA's CPU code gives the padded
    rounds axis ``kt`` in this program (read off its LLVM IR and held by
    the tests): one by one up to 4 rounds, in 8 vector lanes halved
    pairwise from 8 (for 16 rounds measured at batches of 1 and of 16 or
    more). The margin is ``base + lr · sum`` rounded once, as that code
    contracts it. So the margins equal the JAX package's bit for bit."""
    split_col = tables["split_col"].long()                  # [kt, nn]
    kt, nn = split_col.shape
    b_max = tables["seg_of_bin"].shape[2]
    sw = tables["child"].shape[1] // nn
    sob_flat = tables["seg_of_bin"].reshape(kt, nn * b_max).long()
    child = tables["child"].long()
    bins_t = bins.long().t()                                # [A, M]
    m = bins_t.shape[1]
    node = torch.zeros((kt, m), dtype=torch.int64, device=bins_t.device)
    for _ in range(depth):
        a = torch.gather(split_col, 1, node)                # [kt, M]
        b = torch.gather(bins_t, 0, a)                      # [kt, M]
        seg = torch.gather(sob_flat, 1, node * b_max + b)
        ch = torch.gather(child, 1, node * sw + seg)
        node = torch.where(ch >= 0, ch, node)
    vals = torch.gather(tables["value"], 1, node) \
        * tables["valid"][:, None]                          # [kt, M]
    if kt <= 4:
        total = it.xla_sum(vals, 0)
    else:
        # XLA's loop vectorizer runs the rounds axis in 8 lanes (tree r
        # into lane r % 8), then halves the lanes pairwise
        acc = vals[:8]
        for r in range(8, kt, 8):
            acc = acc + vals[r:r + 8]
        while acc.shape[0] > 1:
            half = acc.shape[0] // 2
            acc = acc[:half] + acc[half:]
        total = acc[0]
    margin = it.fma(tables["lr"], total, tables["base"])
    return margin, (margin > 0).to(torch.int32)
