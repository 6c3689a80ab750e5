"""Decision trees: candidate splits, their gains, tree growth and
prediction.

Counterpart of ``avenir_tpu/models/tree.py`` with the same names, the same
split-key wire formats ("10:20" numeric, "[a, b]:[c]" categorical) and the
same artifacts:

- **Candidate splits** (ClassPartitionGenerator): every increasing tuple
  of grid points of a numeric attribute, every set partition of a
  categorical one into 2..maxSplit groups; the class counts of every
  segment of every candidate (plain torch ops: segment ids, then one
  ``index_add``), the split statistic and the gain ratio.
- **Host growth** (``grow_tree``): the SplitGenerator → DataPartitioner
  rounds of a whole tree in memory, one pass of candidate counts for each
  level, ``best`` or ``randomFromTop`` selection.
- **Device growth** (``grow_tree_device``, ``grow_levels_batched``, and
  ``models/forest.py``'s forests, with a leading tree axis): a
  level's (node, feature, bin, class) histogram from K1
  (``ops.histogram.node_class_bin_counts``, one launch for each chunk of
  8,192 (node, bin) cells), every candidate's segment counts summed from
  it, the best split of each node, the compaction of the live frontier
  and the routing of the rows, all on the table's device; the level
  records come back in one device-to-host copy a tree.
- **Prediction**: a host walk (``predict``) and a gather chain on the
  device (``predict_device``), with the same output.

Counts are integers, exact in f32, so every formulation gives the same
counts; the statistics follow ``ops.infotheory``'s rounding (eager JAX's),
but the device growth's level selection computes its gain ratios in the
order XLA compiles the JAX package's (``_level_select``), bit for bit with
two classes, so it breaks ties as the JAX package does. Entry points run
on the device of the table they are given.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import histogram as hg
from avenir_tpu_torch.ops import infotheory as it
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.schema import FeatureField

SPLIT_SEP = ":"
#: f32(1/ln 2): XLA's compiled x·log2 x multiplies by it
_INV_LN2 = float(np.float32(1.0 / np.log(2.0)))


# --------------------------------------------------------------------------
# candidate-split enumeration (host side)
# --------------------------------------------------------------------------

def numeric_grid(f: FeatureField) -> List[int]:
    """The bucket grid every candidate split point of a numeric attribute
    comes from (points from min+bw to max-bw); a row's histogram bin is the
    number of grid points strictly below its value."""
    if f.min is None or f.max is None or f.bucket_width is None:
        raise ValueError(f"numeric split attr {f.name} needs min/max/bucketWidth")
    lo, hi, bw = int(f.min + 0.01), int(f.max + 0.01), int(f.bucket_width)
    return list(range(lo + bw, hi, bw))


def enumerate_numeric_splits(f: FeatureField) -> List[Tuple[int, ...]]:
    """All increasing split-point tuples on the bucket grid, sizes 1 to
    maxSplit-1."""
    grid = numeric_grid(f)
    max_points = max((f.max_split or 2) - 1, 1)
    splits: List[Tuple[int, ...]] = []
    for size in range(1, max_points + 1):
        splits.extend(itertools.combinations(grid, size))
    return splits


def enumerate_categorical_splits(cardinality: Sequence[str], max_split: int,
                                 max_cat_attr_split_groups: int = 3
                                 ) -> List[Tuple[Tuple[str, ...], ...]]:
    """All set partitions of the cardinality into exactly g groups, for
    g in 2..max_split, groups ordered by first occurrence (the reference's
    enumeration order), under the max.cat.attr.split.groups guard."""
    if max_split > max_cat_attr_split_groups:
        raise ValueError(
            f"more than {max_cat_attr_split_groups} split groups not allowed "
            "for categorical attr")
    values = list(cardinality)
    results: List[Tuple[Tuple[str, ...], ...]] = []

    def partitions_into(groups: int):
        # restricted-growth strings of exactly `groups` blocks
        n = len(values)
        assignment = [0] * n

        def rec(i: int, used: int):
            if i == n:
                if used == groups:
                    blocks: List[List[str]] = [[] for _ in range(used)]
                    for v, a in zip(values, assignment):
                        blocks[a].append(v)
                    results.append(tuple(tuple(b) for b in blocks))
                return
            for a in range(min(used + 1, groups)):
                assignment[i] = a
                rec(i + 1, max(used, a + 1))

        rec(0, 0)

    for g in range(2, max_split + 1):
        partitions_into(g)
    return results


def numeric_split_key(points: Tuple[int, ...]) -> str:
    return SPLIT_SEP.join(str(p) for p in points)


def categorical_split_key(groups: Tuple[Tuple[str, ...], ...]) -> str:
    return SPLIT_SEP.join("[" + ", ".join(g) + "]" for g in groups)


def parse_categorical_split_key(key: str) -> Tuple[Tuple[str, ...], ...]:
    groups = []
    for part in key.split(SPLIT_SEP):
        inner = part.strip()[1:-1]
        groups.append(tuple(v.strip() for v in inner.split(",")))
    return tuple(groups)


# --------------------------------------------------------------------------
# gains of every candidate split
# --------------------------------------------------------------------------

@dataclass
class CandidateSplit:
    attr_ordinal: int
    key: str
    stat: float          # weighted entropy/gini (or hellinger/ccr stat)
    gain: float          # parent_info - stat (info algorithms only)
    gain_ratio: float    # gain / intrinsic info


def _table_device(table: EncodedTable) -> torch.device:
    return table.binned.device


def _class_counts(table: EncodedTable,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C] f32 class counts of the table's rows, optionally weighted."""
    w = (torch.ones(table.n_rows, dtype=torch.float32,
                    device=_table_device(table))
         if weights is None else weights.to(torch.float32))
    return torch.zeros(table.n_classes, dtype=torch.float32,
                       device=w.device).index_add_(0, table.labels.long(), w)


def root_info(table: EncodedTable, algorithm: str = "giniIndex",
              row_mask: Optional[torch.Tensor] = None) -> float:
    """The at.root bootstrap: info content of the whole node
    (ClassPartitionGenerator at.root :161-163, :206-209)."""
    return float(it.info(_class_counts(table, row_mask), algorithm))


#: candidate splits counted together
_SPLIT_CHUNK = 1024


def _segments(column: torch.Tensor, aux: torch.Tensor,
              is_cat: bool) -> torch.Tensor:
    """[S, N] segment of every row under each candidate: the number of
    split points (``aux`` [S, P], +inf padded) strictly below a numeric
    value (IntegerSplit.getSegmentIndex), or the group of a categorical
    code (``aux`` [S, V] group-of-code)."""
    if is_cat:
        return aux[:, column.long()]
    seg = torch.zeros((aux.shape[0], column.shape[0]), dtype=torch.int64,
                      device=column.device)
    for p in range(aux.shape[1]):
        seg += column[None, :] > aux[:, p:p + 1]
    return seg


def _seg_class_counts(column, labels, aux, is_cat: bool, n_segments: int,
                      n_classes: int, weights: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """[S, G, C] f32 class counts of every segment of every candidate."""
    seg = _segments(column, aux, is_cat)
    s, n = seg.shape
    cells = n_segments * n_classes
    flat = (torch.arange(s, device=seg.device)[:, None] * cells
            + seg * n_classes + labels.long()[None, :])
    w = (torch.ones(n, dtype=torch.float32, device=seg.device)
         if weights is None else weights.to(torch.float32))
    counts = torch.zeros(s * cells, dtype=torch.float32, device=seg.device)
    counts.index_add_(0, flat.reshape(-1), w.expand(s, n).reshape(-1))
    return counts.reshape(s, n_segments, n_classes)


def _info_algorithm(algorithm: str) -> bool:
    return algorithm in ("entropy", "giniIndex")


def _attr_plans(table: EncodedTable, attr_ordinals: Sequence[int],
                max_cat_attr_split_groups: int):
    """Each attribute's candidate catalog and count operands: (attr, keys,
    is_categorical, column, aux numpy array, n_segments)."""
    ord_to_pos = {f.ordinal: i for i, f in enumerate(table.feature_fields)}
    plans = []
    for attr in attr_ordinals:
        pos = ord_to_pos[attr]
        f = table.feature_fields[pos]
        if f.is_categorical:
            card = f.cardinality or table.bin_labels[pos]
            groups_list = enumerate_categorical_splits(
                card, f.max_split or 2, max_cat_attr_split_groups)
            keys = [categorical_split_key(g) for g in groups_list]
            vocab = {v: i for i, v in enumerate(table.bin_labels[pos])}
            n_seg = max(len(g) for g in groups_list)
            lookup = np.zeros((len(groups_list), len(vocab)), np.int32)
            for s, groups in enumerate(groups_list):
                for gi, group in enumerate(groups):
                    for v in group:
                        if v in vocab:
                            lookup[s, vocab[v]] = gi
            plans.append((attr, keys, True, table.binned[:, pos], lookup,
                          n_seg))
        else:
            splits = enumerate_numeric_splits(f)
            keys = [numeric_split_key(p) for p in splits]
            max_pts = max(len(p) for p in splits)
            pts = np.full((len(splits), max_pts), np.inf, np.float32)
            for s, p in enumerate(splits):
                pts[s, :len(p)] = p
            plans.append((attr, keys, False, table.numeric[:, pos], pts,
                          max_pts + 1))
    return plans


def _plan_stats(table: EncodedTable, plans, algorithm: str,
                weights: Optional[torch.Tensor], with_counts: bool = False):
    """(stats [T], intrinsic [T]) over every plan's candidates, and with
    ``with_counts`` each plan's [S, G, C] counts, from one device-to-host
    copy."""
    dev = _table_device(table)
    stats, intr, counts = [], [], []
    for _attr, keys, is_cat, column, aux, n_seg in plans:
        aux_t = torch.from_numpy(aux).to(dev)
        for c0 in range(0, len(keys), _SPLIT_CHUNK):
            cnt = _seg_class_counts(column, table.labels,
                                    aux_t[c0:c0 + _SPLIT_CHUNK], is_cat,
                                    n_seg, table.n_classes, weights)
            stats.append(it.split_stat(cnt, algorithm))
            intr.append(it.intrinsic_info_content(cnt))
            if with_counts:
                counts.append(cnt.reshape(-1))
    n_total = sum(len(keys) for _, keys, *_ in plans)
    fetched = torch.cat(stats + intr + counts).cpu().numpy()
    out = [fetched[:n_total], fetched[n_total:2 * n_total]]
    if with_counts:
        pos, per_attr = 2 * n_total, []
        for _, keys, _, _, _, n_seg in plans:
            size = len(keys) * n_seg * table.n_classes
            per_attr.append(fetched[pos:pos + size].reshape(
                len(keys), n_seg, table.n_classes))
            pos += size
        out.append(per_attr)
    return out


def _assemble_candidates(plans, stats_flat, intr_flat, algorithm,
                         parent_info) -> List[CandidateSplit]:
    info_alg = _info_algorithm(algorithm)
    out: List[CandidateSplit] = []
    cursor = 0
    for attr, keys, *_ in plans:
        n = len(keys)
        stats = stats_flat[cursor:cursor + n]
        intrinsic = intr_flat[cursor:cursor + n]
        cursor += n
        for key, stat, intr in zip(keys, stats, intrinsic):
            if info_alg:
                gain = parent_info - float(stat)
                ratio = gain / float(intr) if intr > 0 else 0.0
            else:
                # hellinger / classConfidenceRatio emit the raw stat
                gain, ratio = float(stat), float(stat)
            out.append(CandidateSplit(attr, key, float(stat), gain, ratio))
    return out


def split_gains(table: EncodedTable, attr_ordinals: Sequence[int],
                algorithm: str = "giniIndex",
                parent_info: Optional[float] = None,
                max_cat_attr_split_groups: int = 3,
                row_mask: Optional[torch.Tensor] = None
                ) -> List[CandidateSplit]:
    """Gains for every candidate split of every attribute, in the
    attributes' order, from one device-to-host copy."""
    if parent_info is None:
        parent_info = root_info(table, algorithm)
    plans = _attr_plans(table, attr_ordinals, max_cat_attr_split_groups)
    if not plans:
        return []
    stats, intr = _plan_stats(table, plans, algorithm, row_mask)
    return _assemble_candidates(plans, stats, intr, algorithm, parent_info)


def split_gains_with_class_probs(
        table: EncodedTable, attr_ordinals: Sequence[int],
        algorithm: str = "giniIndex",
        parent_info: Optional[float] = None,
        max_cat_attr_split_groups: int = 3,
) -> Tuple[List[CandidateSplit],
           Dict[Tuple[int, str], List[Tuple[int, str, float]]]]:
    """``split_gains`` plus P(class | segment) of every candidate split —
    the ``output.split.prob=true`` payload (ClassPartitionGenerator.java
    :539-560, repeating ``segment;classVal;prob`` triples), from the same
    counts."""
    if parent_info is None:
        parent_info = root_info(table, algorithm)
    plans = _attr_plans(table, attr_ordinals, max_cat_attr_split_groups)
    if not plans:
        return [], {}
    stats, intr, counts_per_attr = _plan_stats(table, plans, algorithm,
                                               None, with_counts=True)
    cands = _assemble_candidates(plans, stats, intr, algorithm, parent_info)
    probs_out: Dict[Tuple[int, str], List[Tuple[int, str, float]]] = {}
    for (attr, keys, *_), counts in zip(plans, counts_per_attr):
        seg_tot = counts.sum(axis=2, keepdims=True)     # counts: [S, G, C]
        probs = counts / np.maximum(seg_tot, 1.0)
        for s, key in enumerate(keys):
            triples = []
            for g in range(counts.shape[1]):
                if seg_tot[s, g, 0] <= 0:
                    continue          # segment absent from this split
                for c, cls in enumerate(table.class_values):
                    triples.append((g, cls, float(probs[s, g, c])))
            probs_out[(attr, key)] = triples
    return cands, probs_out


def split_gains_multi(table: EncodedTable, attr_ordinals: Sequence[int],
                      algorithm: str, parent_infos: Sequence[float],
                      max_cat_attr_split_groups: int,
                      row_masks: np.ndarray) -> List[List[CandidateSplit]]:
    """Candidate-split gains of K nodes (``row_masks`` [K, N] row
    weights), one device-to-host copy for each node."""
    plans = _attr_plans(table, attr_ordinals, max_cat_attr_split_groups)
    if not plans:
        return [[] for _ in parent_infos]
    dev = _table_device(table)
    out = []
    for mask, parent in zip(row_masks, parent_infos):
        stats, intr = _plan_stats(
            table, plans, algorithm,
            torch.from_numpy(np.asarray(mask, np.float32)).to(dev))
        out.append(_assemble_candidates(plans, stats, intr, algorithm,
                                        parent))
    return out


# --------------------------------------------------------------------------
# candidate-splits artifact (the reference's splits/part-r-00000 contract)
# --------------------------------------------------------------------------

def write_candidate_splits(splits: List[CandidateSplit], path: str,
                           delim: str = ";",
                           class_probs: Optional[Dict] = None) -> None:
    """Lines ``attr;splitKey;stat`` (DataPartitioner.java:219-226), each
    followed by its ``segment;classVal;prob`` triples when ``class_probs``
    is given."""
    with open(path, "w") as fh:
        for s in splits:
            parts = [str(s.attr_ordinal), s.key, repr(s.gain_ratio)]
            if class_probs is not None:
                for seg, cls, pr in class_probs.get(
                        (s.attr_ordinal, s.key), []):
                    parts += [str(seg), cls, repr(pr)]
            fh.write(delim.join(parts) + "\n")


def read_candidate_splits(path: str, delim: str = ";"
                          ) -> List[Tuple[int, str, float]]:
    out = []
    with open(path) as fh:
        for line in fh:
            items = line.rstrip("\n").split(delim)
            if len(items) >= 3:
                out.append((int(items[0]), items[1], float(items[2])))
    return out


def select_split(candidates: List[Tuple[int, str, float]],
                 strategy: str = "best", num_top_splits: int = 5,
                 rng: Optional[np.random.Generator] = None
                 ) -> Tuple[int, Tuple[int, str, float]]:
    """Descending sort on the stat; ``best`` takes rank 0, ``randomFromTop``
    draws among the top num.top.splits. Returns (line index of the chosen
    split in the candidates file, which names ``split=<i>``, split)."""
    if strategy not in ("best", "randomFromTop"):
        raise ValueError(
            f"unknown split selection strategy {strategy!r} "
            f"(expected 'best' or 'randomFromTop')")
    order = sorted(range(len(candidates)), key=lambda i: -candidates[i][2])
    pick = 0
    if strategy == "randomFromTop":
        rng = rng or np.random.default_rng()
        pick = int(rng.integers(0, min(num_top_splits, len(order))))
    idx = order[pick]
    return idx, candidates[idx]


def _categorical_seg_table(vocab: Sequence[str], split_key: str
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """code -> (segment, covered?) of one categorical split key, shared by
    the host and device routing."""
    groups = parse_categorical_split_key(split_key)
    seg_of_code = np.zeros(len(vocab), np.int32)
    found = np.zeros(len(vocab), bool)
    vocab = list(vocab)
    for gi, group in enumerate(groups):
        for v in group:
            if v in vocab:
                ci = vocab.index(v)
                seg_of_code[ci] = gi
                found[ci] = True
    return seg_of_code, found


def split_segment_count(split_key: str) -> int:
    """Segments a split key defines: categorical its groups, numeric its
    points + 1."""
    if split_key.startswith("["):
        return len(parse_categorical_split_key(split_key))
    return len(split_key.split(SPLIT_SEP)) + 1


def _column(table: EncodedTable, attr_ordinal: int):
    pos = {f.ordinal: i for i, f in enumerate(table.feature_fields)}[
        attr_ordinal]
    return pos, table.feature_fields[pos]


def segment_of_rows(table: EncodedTable, attr_ordinal: int, split_key: str
                    ) -> np.ndarray:
    """Every row's split segment, on the host (DataPartitioner mapper
    :324-337)."""
    pos, f = _column(table, attr_ordinal)
    if f.is_categorical:
        seg_of_code, found = _categorical_seg_table(
            table.bin_labels[pos], split_key)
        codes = table.binned[:, pos].cpu().numpy()
        if not found[codes].all():
            raise ValueError("split segment not found for some value")
        return seg_of_code[codes]
    points = np.asarray([int(p) for p in split_key.split(SPLIT_SEP)])
    values = table.numeric[:, pos].cpu().numpy()
    return np.sum(values[:, None] > points[None, :], axis=1).astype(np.int32)


# --------------------------------------------------------------------------
# trees, and their growth on the host
# --------------------------------------------------------------------------

@dataclass
class TreeNode:
    class_counts: np.ndarray
    class_values: List[str]
    attr_ordinal: Optional[int] = None
    split_key: Optional[str] = None
    children: Dict[int, "TreeNode"] = field(default_factory=dict)
    # a boosted tree's Newton value of this node (models/boost.py): the
    # margin a row adds when its route stops here. None for other trees,
    # whose artifacts then carry no "value"
    leaf_value: Optional[float] = None

    @property
    def is_leaf(self) -> bool:
        return self.attr_ordinal is None

    @property
    def prediction(self) -> int:
        return int(np.argmax(self.class_counts))

    def to_dict(self) -> dict:
        d = {
            "classCounts": self.class_counts.tolist(),
            "attr": self.attr_ordinal,
            "splitKey": self.split_key,
            "children": {str(k): v.to_dict() for k, v in self.children.items()},
        }
        if self.leaf_value is not None:
            d["value"] = self.leaf_value
        return d

    @classmethod
    def from_dict(cls, d: dict, class_values: List[str]) -> "TreeNode":
        node = cls(class_counts=np.asarray(d["classCounts"], np.float64),
                   class_values=list(class_values),
                   attr_ordinal=d.get("attr"),
                   split_key=d.get("splitKey"),
                   leaf_value=d.get("value"))
        for k, child in d.get("children", {}).items():
            node.children[int(k)] = cls.from_dict(child, class_values)
        return node


@dataclass(frozen=True)
class TreeConfig:
    split_attributes: Tuple[int, ...] = ()    # split.attributes (empty = all)
    algorithm: str = "giniIndex"              # split.algorithm
    max_depth: int = 3
    min_node_size: int = 10
    max_cat_attr_split_groups: int = 3        # max.cat.attr.split.groups
    split_selection_strategy: str = "best"    # split.selection.strategy
    num_top_splits: int = 5                   # num.top.splits
    min_gain: float = 1e-6
    # grow_tree_device: most live nodes a level may carry; more raises
    device_node_budget: int = 2048


def canonical_tree(n: Optional[TreeNode], with_values: bool = False):
    """Order-insensitive fingerprint of a tree — (attr, key, int class
    counts, sorted children) per node: what "identical tree" means.
    ``with_values`` appends each node's f32 ``leaf_value``, so that
    boosted trees compare by their Newton values too."""
    if n is None:
        return None
    base = (n.attr_ordinal, n.split_key,
            tuple(int(c) for c in n.class_counts),
            tuple(sorted((k, canonical_tree(v, with_values))
                         for k, v in n.children.items())))
    if with_values:
        return base + (None if n.leaf_value is None
                       else float(np.float32(n.leaf_value)),)
    return base


def splittable_ordinals(table: EncodedTable) -> List[int]:
    """The attributes candidate splits can be enumerated for: categorical,
    or numeric with a bucket grid."""
    return [f.ordinal for f in table.feature_fields
            if f.is_categorical or
            (f.is_numeric and f.bucket_width is not None)]


def grow_tree(table: EncodedTable, config: TreeConfig,
              rng: Optional[np.random.Generator] = None,
              row_weights: Optional[np.ndarray] = None) -> TreeNode:
    """The reference's SplitGenerator→DataPartitioner rounds, breadth
    first: every node works on the full table under a row-weight mask (the
    reference's per-node partition), a level's candidate gains come back
    together, and ``rng`` (randomFromTop) draws in BFS order.
    ``row_weights`` seeds the root mask (as in ``grow_tree_device``)."""
    attrs = list(config.split_attributes) or splittable_ordinals(table)
    dev = _table_device(table)
    oh_labels = np.eye(table.n_classes, dtype=np.float32)[
        table.labels.cpu().numpy()]

    root: Optional[TreeNode] = None
    # (mask, parent node, child segment id, depth)
    root_mask = (np.ones(table.n_rows, np.float32) if row_weights is None
                 else np.asarray(row_weights, np.float32))
    frontier = [(root_mask, None, None, 0)]
    while frontier:
        splittable = []
        for mask, parent, seg, depth in frontier:
            counts = (oh_labels * mask[:, None]).sum(axis=0)
            node = TreeNode(class_counts=counts,
                            class_values=table.class_values)
            if parent is None:
                root = node
            else:
                parent.children[seg] = node
            n_node = int(mask.sum())
            if not (depth >= config.max_depth
                    or n_node < config.min_node_size
                    or np.count_nonzero(counts) <= 1):
                splittable.append((mask, node, depth, counts))
        frontier = []
        if not splittable:
            break
        parents = it.info(torch.from_numpy(
            np.stack([c for *_, c in splittable])).to(dev),
            config.algorithm).cpu().numpy()
        masks_b = np.stack([m for m, *_ in splittable]).astype(np.float32)
        cands_b = split_gains_multi(
            table, attrs, config.algorithm, [float(p) for p in parents],
            config.max_cat_attr_split_groups, masks_b)
        for (mask, node, depth, _), cands in zip(splittable, cands_b):
            if not cands:
                continue
            triples = [(c.attr_ordinal, c.key, c.gain_ratio) for c in cands]
            _, (attr, key, stat) = select_split(
                triples, config.split_selection_strategy,
                config.num_top_splits, rng)
            if stat <= config.min_gain:
                continue
            node.attr_ordinal, node.split_key = attr, key
            segs = segment_of_rows(table, attr, key)
            for seg_val in np.unique(segs[mask > 0]):
                frontier.append(
                    (mask * (segs == seg_val).astype(np.float32), node,
                     int(seg_val), depth + 1))
    return root


# --------------------------------------------------------------------------
# growth on the device: a level's histogram from K1, one readback a tree
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class _DeviceCandidates:
    """Every (attr, split) of every plan on one candidate axis T: a row's
    bin of a feature fixes its segment under every candidate of that
    feature, so a level's (node, feature, bin, class) histogram gives every
    candidate's segment counts."""
    keys: List[Tuple[int, str, int]]      # (attr_ordinal, key, n_seg) per t
    col_of_t: torch.Tensor                # [T] i64 feature of candidate t
    s_max: int
    bins_rows: torch.Tensor               # [N, A] i32 per-feature bin ids
    seg_of_bin: torch.Tensor              # [T, b_max] i64 segment per bin
    b_max: int                            # most bins of a plan feature


def _plan_bins(table: EncodedTable, plans) -> Tuple[torch.Tensor, List[int]]:
    """([N, A] i32 bin of every row under every plan feature, bins of each
    plan): numeric, the number of grid points strictly below the value (an
    f32 compare); categorical, the vocabulary code."""
    dev = _table_device(table)
    cols, n_bins = [], []
    for attr, _keys, is_cat, column, _aux, _n_seg in plans:
        pos, f = _column(table, attr)
        if is_cat:
            cols.append(column.to(torch.int32))
            n_bins.append(len(table.bin_labels[pos]))
        else:
            grid = torch.tensor(numeric_grid(f), dtype=torch.float32,
                                device=dev)
            cols.append((column.to(torch.float32)[:, None] > grid[None, :])
                        .sum(dim=1).to(torch.int32))
            n_bins.append(int(grid.shape[0]) + 1)
    return torch.stack(cols, dim=1).contiguous(), n_bins


def _plan_seg_of_bin(table: EncodedTable, plans,
                     n_bins: List[int]) -> np.ndarray:
    """[T, b_max] segment of every (candidate, bin): numeric, the
    candidate points at or below the bin's lower edge; categorical, the
    group-of-code lookup. Bins a feature never produces carry 0; their
    histogram cells are zero."""
    b_max = max(n_bins)
    rows = []
    for (attr, keys, is_cat, _col, aux, _n_seg), n_b in zip(plans, n_bins):
        sob = np.zeros((len(keys), b_max), np.int32)
        if is_cat:
            sob[:, :aux.shape[1]] = aux
        else:
            _, f = _column(table, attr)
            edges = np.concatenate(
                [[-np.inf], np.asarray(numeric_grid(f), np.float64)])
            # [S, P] points vs [B] lower edges; +inf padding never counts
            sob[:, :n_b] = np.sum(
                aux[:, None, :] <= edges[None, :n_b, None], axis=2)
        rows.append(sob)
    return np.concatenate(rows)


def _device_candidates(table: EncodedTable, plans) -> _DeviceCandidates:
    keys: List[Tuple[int, str, int]] = []
    col_l = []
    for a, (attr, ks, is_cat, _col, aux, _n_seg) in enumerate(plans):
        if is_cat:
            # the host routing raises for a value in no split group; the
            # device lookup would send it to group 0, so refuse up front
            pos, _ = _column(table, attr)
            vocab = list(table.bin_labels[pos])
            for key in ks:
                covered = {v for g in parse_categorical_split_key(key)
                           for v in g}
                missing = [v for v in vocab if v not in covered]
                if missing:
                    raise ValueError(
                        f"categorical value(s) {missing} of attribute "
                        f"{attr} not covered by split {key!r}")
        for key, aux_row in zip(ks, aux):
            n_seg = (int(aux_row.max()) + 1 if is_cat
                     else int(np.sum(np.isfinite(aux_row))) + 1)
            keys.append((attr, key, n_seg))
        col_l.extend([a] * len(ks))
    dev = _table_device(table)
    bins_rows, n_bins = _plan_bins(table, plans)
    return _DeviceCandidates(
        keys=keys,
        col_of_t=torch.tensor(col_l, dtype=torch.int64, device=dev),
        s_max=max(p[5] for p in plans),
        bins_rows=bins_rows,
        seg_of_bin=torch.from_numpy(
            _plan_seg_of_bin(table, plans, n_bins)).long().to(dev),
        b_max=int(max(n_bins)))


def _level_hist(node_id, row_w, labels, bins_rows, *, k_nodes: int,
                b_max: int, n_classes: int) -> torch.Tensor:
    """The level's binned counts [A, K, B, C] through K1 ([Kt, A, K, B, C]
    for node ids and weights with a leading tree axis). Row weights pass
    through bf16 first, as the JAX package's growth rounds them."""
    w = row_w.to(torch.bfloat16).to(torch.float32)
    return hg.node_class_bin_counts(bins_rows, node_id, labels, k_nodes,
                                    b_max, n_classes, w)


def _counts_from_hist(hist: torch.Tensor, cand: _DeviceCandidates
                      ) -> torch.Tensor:
    """[..., T, S, K, C] segment counts of every candidate, summed from the
    level's histogram ``hist`` [..., A, K, B, C] over the bins of each
    segment (integers, exact in any order); a leading tree axis rides
    along."""
    h = hist.index_select(-4, cand.col_of_t)             # [..., T, K, B, C]
    return torch.stack(
        [(h * (cand.seg_of_bin == s)[:, None, :, None]).sum(dim=-2)
         for s in range(cand.s_max)], dim=-3)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over a last axis of 4 or 8 as XLA's CPU code compiles the
    segment sum of ``_level_select``: four lanes at a time from +0, then
    the lanes as (0 + 2) + (1 + 3)."""
    n = x.shape[-1]
    lanes = torch.zeros_like(x[..., :4])
    for j in range(0, n, 4):
        lanes = lanes + x[..., j:j + 4]
    return (lanes[..., 0] + lanes[..., 2]) + (lanes[..., 1] + lanes[..., 3])


# XLA's CPU code for ``_level_select`` at 16 to 32 segments, read off the
# LLVM IR of the compiled function (``XLA_FLAGS=--xla_dump_to``) and held
# bit for bit at every S from 16 to 32, K from 1 to 5 and C from 2 to 4:
# the loop over segments is vectorized in this many lanes; it leaves a
# whole last vector to the scalar epilogue when S divides by the lanes
# and the counts' interleaved loads (C of every K·C floats) have gaps,
# K ≥ 2 and K·C ≤ 8 (_needs_epilogue). The segment-size entropy of the
# denominator is a scalar chain below 30 segments and 8 lanes from 30.
_SEG_LANES = {**{s: 8 for s in (16, 17, 18, 19, 24, 25, 26, 27, 32)},
              **{s: 4 for s in (20, 21, 22, 23, 28, 29, 30, 31)}}
_INTR_LANES_FROM = 30


def _needs_epilogue(k_nodes: int, n_classes: int) -> bool:
    return k_nodes >= 2 and k_nodes * n_classes <= 8


def _vector_sum(x: torch.Tensor, y: Optional[torch.Tensor], lanes: int,
                main: int) -> torch.Tensor:
    """f32 sum over the last axis of ``x`` (of ``x·y`` with each product
    fused into its add when ``y`` is given) as a vectorized loop compiles
    it: the first ``main`` elements into ``lanes`` accumulators from +0,
    the lanes halved pairwise, then the rest one by one."""
    prod = ((lambda a, b, acc: it.fma(a, b, acc)) if y is not None
            else (lambda a, b, acc: acc + a))
    acc = torch.zeros_like(x[..., :lanes])
    for j in range(0, main, lanes):
        acc = prod(x[..., j:j + lanes],
                   None if y is None else y[..., j:j + lanes], acc)
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    acc = acc[..., 0]
    for s in range(main, x.shape[-1]):
        acc = prod(x[..., s], None if y is None else y[..., s], acc)
    return acc


def _level_select(counts: torch.Tensor, *, algorithm: str,
                  min_node_size: int, min_gain: float,
                  cand_mask: Optional[torch.Tensor] = None,
                  with_ratio: bool = False):
    """Best split of every node from the level's [T, S, K, C] counts, the
    class counts of every child through it, and compact next-level slots
    for the children that can split again (a cumsum over their
    liveness).

    ``counts`` may carry a leading tree axis [Kt, T, S, K, C] (a forest's
    level); every record then carries it too. ``cand_mask`` [Kt, T]
    (each tree's attribute subset) sinks the ratios of the candidates
    outside it to -inf before the first-index argmax: the catalog is
    sorted by attribute, so this picks what the subset's own catalog
    would. The statistics are elementwise over (tree, candidate, node),
    so a tree's stats round as they do alone.

    For ``entropy`` and ``giniIndex`` the gain ratio rounds as the JAX
    package's compiled ``_level_select`` (XLA's CPU code) rounds it, not
    as ``split_gains`` does: two candidates that split a node's rows into
    the same children in another segment order tie only up to that
    rounding, and the argmax then picks the candidate JAX picks. Bit for
    bit at any class count with up to 32 segments (``_SEG_LANES``) and,
    where XLA cuts the segment sums into windows of 32 (``xla_sum``), at
    the 33, 40, 48 and 64 segments the tests hold."""
    single = counts.dim() == 4
    if single:
        counts = counts[None]
    kt, t_total, s_max, k_nodes, n_classes = counts.shape
    node_counts = counts[:, 0].sum(dim=1)                # [Kt, K, C]
    flat_sgc = counts.permute(0, 1, 3, 2, 4).reshape(
        kt * t_total * k_nodes, s_max, n_classes)
    if _info_algorithm(algorithm):
        # the gain ratio in the order XLA's CPU code computes it compiled:
        # x·log2 x as a product by f32(1/ln 2), and every sum of products
        # (the gini's squares, the segments' count-weighted stats) as a
        # chain of fused multiply-adds from +0
        def xlog2x(p):
            return torch.where(
                p > 0, p * it.xla_log(it._nonzero(p)) * _INV_LN2,
                torch.zeros_like(p))

        def node_info(c):
            p = c / it._nonzero(c.sum(dim=-1, keepdim=True))
            if algorithm == "entropy":
                return -it._sum(xlog2x(p), -1)
            sq = torch.zeros_like(p[..., 0])
            for j in range(n_classes):
                sq = it.fma(p[..., j], p[..., j], sq)
            return 1.0 - sq

        seg_n = flat_sgc.sum(dim=-1)                     # [M, S]
        seg_info = node_info(flat_sgc)
        if s_max in (4, 8):
            # XLA vectorizes a segment axis of 4 or 8 and sums its
            # products in four-lane vectors
            acc = _lane_sum(seg_info * seg_n)
        elif s_max in _SEG_LANES:
            lanes = _SEG_LANES[s_max]
            main = s_max - s_max % lanes
            if main == s_max and _needs_epilogue(k_nodes, n_classes):
                main -= lanes
            acc = _vector_sum(seg_info, seg_n, lanes, main)
        elif s_max > 32:
            # XLA rewrites the reduction into windows of 32 over the
            # products, each rounded on its own (``xla_sum``)
            acc = it.xla_sum(seg_info * seg_n, -1)
        else:
            acc = torch.zeros_like(seg_n[:, 0])
            for s in range(s_max):
                acc = it.fma(seg_info[:, s], seg_n[:, s], acc)
        stat = (acc / it._nonzero(seg_n.sum(dim=-1))).reshape(
            kt, t_total, k_nodes)
        seg_x = xlog2x(seg_n / it._nonzero(seg_n.sum(dim=-1, keepdim=True)))
        if _INTR_LANES_FROM <= s_max <= 32:
            intr = -_vector_sum(seg_x, None, 8, s_max - s_max % 8)
        elif s_max > 32:
            intr = -it.xla_sum(seg_x, -1)
        else:
            intr = -it._sum(seg_x, -1)
        intr = intr.reshape(kt, t_total, k_nodes)
        gain = node_info(node_counts)[:, None, :] - stat
        ratio = torch.where(intr > 0, gain / it._nonzero(intr),
                            torch.zeros_like(gain))
    else:
        ratio = it.split_stat(flat_sgc, algorithm).reshape(kt, t_total,
                                                           k_nodes)
    if cand_mask is not None:
        ratio = torch.where(cand_mask[:, :, None], ratio,
                            torch.full_like(ratio, float("-inf")))
    best_t = torch.argmax(ratio, dim=1)                  # [Kt, K], first max
    best_ratio = ratio.gather(1, best_t[:, None, :])[:, 0]
    split_k = ((node_counts.sum(dim=-1) >= min_node_size)
               & ((node_counts > 0).sum(dim=-1) > 1)
               & (best_ratio > min_gain))                # [Kt, K]
    child_counts = counts.permute(0, 3, 1, 2, 4).gather(
        2, best_t[:, :, None, None, None].expand(
            kt, k_nodes, 1, s_max, n_classes))[:, :, 0]  # [Kt, K, S, C]
    # live = could split again: its own level's size and purity tests
    live = (split_k[..., None] & (child_counts.sum(dim=-1) >= min_node_size)
            & ((child_counts > 0).sum(dim=-1) > 1))      # [Kt, K, S]
    ls = live.reshape(kt, -1)
    slot = torch.cumsum(ls.to(torch.int64), dim=1) - 1
    rec = {"best_t": best_t, "split": split_k, "child_counts": child_counts,
           "child_slot": torch.where(ls, slot, -1).reshape(kt, k_nodes,
                                                           s_max),
           "n_live": ls.sum(dim=1)}
    if with_ratio:
        rec["ratio"] = ratio
    return {k: v[0] for k, v in rec.items()} if single else rec


def _route_level_hist(node_id, row_w, best_t, child_slot_flat,
                      cand: _DeviceCandidates, *, k_next: int):
    """Each row's child slot: its segment under its node's chosen candidate
    is ``seg_of_bin[t, bin]``. Rows whose child is a leaf (or past the
    budget) keep a slot and get weight 0. ``node_id`` and ``row_w`` [N],
    ``best_t`` [K] and ``child_slot_flat`` [K·S], or each with a leading
    tree axis."""
    t_row = best_t.gather(-1, node_id)
    col_row = cand.col_of_t[t_row]
    bin_row = cand.bins_rows.T.gather(
        0, col_row.reshape(-1, col_row.shape[-1])).reshape(col_row.shape)
    seg_row = cand.seg_of_bin.reshape(-1)[t_row * cand.b_max + bin_row]
    cs_row = child_slot_flat.gather(-1, node_id * cand.s_max + seg_row)
    in_budget = (cs_row >= 0) & (cs_row < k_next)
    return (cs_row.clamp(0, k_next - 1),
            row_w * in_budget.to(row_w.dtype))


def _level_widths(depth: int, s_max: int, budget: int) -> List[int]:
    """Static slot counts of each level: the live frontier grows at most
    s_max× a level, capped by the node budget."""
    widths, k = [], 1
    for _ in range(depth):
        widths.append(k)
        k = min(k * s_max, budget)
    return widths


def _grow_levels(labels: torch.Tensor, cand: _DeviceCandidates,
                 row_w0: torch.Tensor, *, depth: int, n_classes: int,
                 algorithm: str, min_node_size: int, min_gain: float,
                 node_budget: int, with_ratio: bool = False,
                 cand_mask: Optional[torch.Tensor] = None):
    """The level records of a depth-D growth, left on the device: for each
    level one K1 histogram (per chunk), selection, compaction and
    routing, with no host synchronization. A forest passes ``row_w0``
    [Kt, N] (each tree's bootstrap weights) and ``cand_mask`` [Kt, T]
    (each tree's attribute subset): the tree axis then leads every
    tensor and record, and a level's torch operations do not multiply
    with the trees (K1 launches once for each tree and chunk)."""
    node_id = torch.zeros(row_w0.shape, dtype=torch.int64,
                          device=labels.device)
    row_w = row_w0
    records = []
    widths = _level_widths(depth, cand.s_max, node_budget)
    for d in range(depth):
        k_next = min(widths[d] * cand.s_max, node_budget)
        hist = _level_hist(node_id, row_w, labels, cand.bins_rows,
                           k_nodes=widths[d], b_max=cand.b_max,
                           n_classes=n_classes)
        rec = _level_select(_counts_from_hist(hist, cand),
                            algorithm=algorithm, min_node_size=min_node_size,
                            min_gain=min_gain, cand_mask=cand_mask,
                            with_ratio=with_ratio)
        node_id, row_w = _route_level_hist(
            node_id, row_w, rec["best_t"], rec["child_slot"].flatten(-2),
            cand, k_next=k_next)
        records.append(rec)
    return records


def _fetch_records(records) -> List[Dict[str, np.ndarray]]:
    """Every level record on the host from ONE device-to-host copy: each
    tensor as int32 words (f32 by its bit pattern) in one buffer."""
    words, layout = [], []
    for rec in records:
        for key, t in rec.items():
            layout.append((key, t.dtype, tuple(t.shape), t.numel()))
            flat = t.reshape(-1)
            words.append(flat.view(torch.int32) if t.dtype == torch.float32
                         else flat.to(torch.int32))
    host = torch.cat(words).cpu().numpy()
    out, pos, i = [], 0, 0
    for rec in records:
        fetched = {}
        for _ in rec:
            key, dtype, shape, size = layout[i]
            part = host[pos:pos + size].reshape(shape)
            fetched[key] = (part.view(np.float32) if dtype == torch.float32
                            else part.astype(bool) if dtype == torch.bool
                            else part.astype(np.int64))
            pos, i = pos + size, i + 1
        out.append(fetched)
    return out


def _check_frontier_budget(records, widths, node_budget: int,
                           hint: str) -> None:
    """Only a level whose live children feed a next level can overflow
    the budget (the last level's children are leaves, rebuilt from its
    child counts)."""
    for d, rec in enumerate(records[:-1]):
        if int(rec["n_live"]) > widths[d + 1]:
            raise ValueError(
                f"live frontier {int(rec['n_live'])} at depth {d + 1} "
                f"exceeds the device node budget {node_budget}; {hint}")


def grow_tree_device(table: EncodedTable, config: TreeConfig,
                     row_weights: Optional[torch.Tensor] = None) -> TreeNode:
    """``grow_tree`` on the table's device with ONE readback: node
    membership as a row→node id, a level's histogram from K1, selection,
    frontier compaction (the node axis carries only nodes that can still
    split) and routing on the device, and the level records copied to the
    host once a tree. A live frontier wider than
    ``config.device_node_budget`` raises with a pointer to grow_tree.
    ``best`` selection only (randomFromTop draws on the host).

    ``row_weights`` weight every count: a row of weight c grows the tree
    of a table holding it c times."""
    if config.split_selection_strategy != "best":
        raise ValueError("grow_tree_device supports the 'best' strategy; "
                         "use grow_tree for randomFromTop")
    attrs = list(config.split_attributes) or splittable_ordinals(table)
    plans = _attr_plans(table, attrs, config.max_cat_attr_split_groups)
    dev = _table_device(table)
    weights = (None if row_weights is None
               else torch.as_tensor(row_weights, dtype=torch.float32,
                                    device=dev))
    if not plans or config.max_depth < 1:
        # no splittable attribute or zero depth: a single leaf
        return TreeNode(class_counts=_class_counts(table, weights)
                        .cpu().numpy(), class_values=table.class_values)
    cand = _device_candidates(table, plans)
    row_w0 = (torch.ones(table.n_rows, dtype=torch.float32, device=dev)
              if weights is None else weights)
    records = _fetch_records(_grow_levels(
        table.labels, cand, row_w0, depth=config.max_depth,
        n_classes=table.n_classes, algorithm=config.algorithm,
        min_node_size=config.min_node_size, min_gain=config.min_gain,
        node_budget=config.device_node_budget))
    _check_frontier_budget(
        records, _level_widths(config.max_depth, cand.s_max,
                               config.device_node_budget),
        config.device_node_budget,
        "raise the budget or use grow_tree (masked, per-level)")
    return _build_tree(records, cand.keys, table.class_values,
                       table.n_classes)


def _build_tree(records, keys, class_values: List[str],
                n_classes: int) -> TreeNode:
    """The tree from its fetched level records."""

    def build(level: int, slot: int, counts: np.ndarray
              ) -> Optional[TreeNode]:
        if counts.sum() <= 0:
            return None
        node = TreeNode(class_counts=counts, class_values=class_values)
        if slot < 0 or level >= len(records):
            return node                       # leaf: counts came from the
        rec = records[level]                  # parent's child_counts row
        if not bool(rec["split"][slot]):
            return node
        t = int(rec["best_t"][slot])
        attr, key, n_seg = keys[t]
        node.attr_ordinal, node.split_key = attr, key
        for s in range(n_seg):
            child = build(level + 1, int(rec["child_slot"][slot, s]),
                          np.asarray(rec["child_counts"][slot, s]))
            if child is not None:
                node.children[s] = child
        return node

    root_counts = np.asarray(records[0]["child_counts"][0]).sum(axis=0)
    root = build(0, 0, root_counts)
    if root is None:
        # zero-row table: a leaf root with empty counts
        root = TreeNode(class_counts=np.zeros(n_classes),
                        class_values=class_values)
    return root


def grow_levels_batched(table: EncodedTable, attr_ordinals: Sequence[int],
                        algorithm: str, depth: int, *,
                        max_cat_attr_split_groups: int = 3,
                        min_node_size: int = 2,
                        node_budget: int = 2048):
    """L tree levels in one device pass and one readback: the raw level
    records (with every candidate's stat of every node, ``ratio`` [T, K])
    and the candidate keys, from which the batched DataPartitioner writes
    every artifact the sequential rounds would. Candidates come in
    ``split_gains``' order, so ``best_t`` is the reference's
    ``split=<i>`` line index. No gain gate (``min_gain`` -inf): only size
    and purity stop descent."""
    plans = _attr_plans(table, attr_ordinals, max_cat_attr_split_groups)
    if not plans:
        raise ValueError("no splittable attributes for batched growth")
    cand = _device_candidates(table, plans)
    row_w = torch.ones(table.n_rows, dtype=torch.float32,
                       device=_table_device(table))
    records = _fetch_records(_grow_levels(
        table.labels, cand, row_w, depth=depth, n_classes=table.n_classes,
        algorithm=algorithm, min_node_size=min_node_size,
        min_gain=float("-inf"), node_budget=node_budget, with_ratio=True))
    _check_frontier_budget(
        records, _level_widths(depth, cand.s_max, node_budget), node_budget,
        "raise tree.device.node.budget or lower "
        "tree.levels.per.invocation")
    return records, cand.keys


# --------------------------------------------------------------------------
# prediction
# --------------------------------------------------------------------------

def _device_segments(table: EncodedTable, attr_ordinal: int,
                     split_key: str):
    """:func:`segment_of_rows` on the device: (segs [N] int8, ok bool
    scalar), ``ok`` False where a categorical value falls in no group —
    checked after one readback for all splits."""
    pos, f = _column(table, attr_ordinal)
    dev = _table_device(table)
    if f.is_categorical:
        seg_of_code, found = _categorical_seg_table(
            table.bin_labels[pos], split_key)
        codes = table.binned[:, pos].long()
        segs = torch.from_numpy(seg_of_code).to(dev)[codes]
        ok = torch.from_numpy(found).to(dev)[codes].all()
    else:
        points = torch.tensor([int(p) for p in split_key.split(SPLIT_SEP)],
                              dtype=torch.float32, device=dev)
        segs = (table.numeric[:, pos][:, None] > points[None, :]).sum(dim=1)
        ok = torch.ones((), dtype=torch.bool, device=dev)
    return segs.to(torch.int8), ok


def _route_rows(flat_segs: torch.Tensor, split_of_node: torch.Tensor,
                child_flat: torch.Tensor, s_width: int,
                pred_of_node: torch.Tensor, depth: int) -> torch.Tensor:
    """Every row down a flattened tree in ``depth`` gather rounds. A row at
    a leaf, or at a segment with no child (empty in training), keeps its
    node."""
    n = flat_segs.shape[1]
    idx = torch.arange(n, device=flat_segs.device)
    fs = flat_segs.reshape(-1).long()
    node_id = torch.zeros(n, dtype=torch.int64, device=flat_segs.device)
    for _ in range(depth):
        seg = fs[split_of_node[node_id] * n + idx]
        ch = child_flat[node_id * s_width + seg]
        node_id = torch.where(ch >= 0, ch, node_id)
    return pred_of_node[node_id]


def _flatten_tree(tree: TreeNode):
    """BFS arrays for :func:`_route_rows`: (split slot of each node into
    the unique (attr, key) list, 0 for leaves; child table
    [num_nodes * s_width], -1 for none; s_width, the most segments a split
    defines; prediction of each node; depth; the unique (attr, key) pairs
    in first-use order; f32 leaf value of each node, 0 where unset)."""
    nodes = [tree]
    i = 0
    while i < len(nodes):
        nodes.extend(nodes[i].children.values())
        i += 1
    order: Dict[int, int] = {id(n): k for k, n in enumerate(nodes)}
    split_slot: Dict[Tuple[int, str], int] = {}
    # from what the splits define, not the children seen in training:
    # unseen data can land in a training-empty segment
    s_width = max([split_segment_count(n.split_key)
                   for n in nodes if not n.is_leaf] + [1])
    split_of = np.zeros(len(nodes), np.int64)
    child = np.full((len(nodes), s_width), -1, np.int64)
    pred = np.asarray([n.prediction for n in nodes], np.int64)
    val = np.asarray([0.0 if n.leaf_value is None else n.leaf_value
                      for n in nodes], np.float32)
    for k, n in enumerate(nodes):
        if n.is_leaf:
            continue
        split_of[k] = split_slot.setdefault((n.attr_ordinal, n.split_key),
                                            len(split_slot))
        for seg, c in n.children.items():
            child[k, seg] = order[id(c)]

    def depth_of(n):
        return 0 if not n.children else 1 + max(
            depth_of(c) for c in n.children.values())
    return (split_of, child.reshape(-1), s_width, pred, depth_of(tree),
            list(split_slot), val)


def predict_device(tree: TreeNode, table: EncodedTable,
                   seg_cache: Optional[Dict] = None) -> np.ndarray:
    """Class index of every row, routed on the table's device with one
    readback; equal to :func:`predict`. ``seg_cache`` may be shared across
    trees."""
    split_of, child_flat, s_width, pred, depth, splits, _ = \
        _flatten_tree(tree)
    dev = _table_device(table)
    if depth == 0:
        return np.full(table.n_rows, tree.prediction, np.int64)
    seg_cache = {} if seg_cache is None else seg_cache
    for key in splits:
        if key not in seg_cache:
            seg_cache[key] = _device_segments(table, *key)
    out = _route_rows(
        torch.stack([seg_cache[k][0] for k in splits]),
        torch.from_numpy(split_of).to(dev),
        torch.from_numpy(child_flat).to(dev), s_width,
        torch.from_numpy(pred).to(dev), depth)
    oks = torch.stack([seg_cache[k][1] for k in splits])
    host = torch.cat([out, oks.to(torch.int64)]).cpu().numpy()
    if not host[table.n_rows:].all():
        raise ValueError("split segment not found for some value")
    return host[:table.n_rows]


def predict(tree: TreeNode, table: EncodedTable,
            seg_cache: Optional[Dict[Tuple[int, str], np.ndarray]] = None
            ) -> np.ndarray:
    """Class index of every row by walking the tree on the host.
    ``seg_cache`` may be shared across trees."""
    out = np.zeros(table.n_rows, np.int64)
    if seg_cache is None:
        seg_cache = {}

    def segments(attr: int, key: str) -> np.ndarray:
        if (attr, key) not in seg_cache:
            seg_cache[(attr, key)] = segment_of_rows(table, attr, key)
        return seg_cache[(attr, key)]

    def walk(node: TreeNode, rows: np.ndarray):
        if node.is_leaf or not node.children:
            out[rows] = node.prediction
            return
        segs = segments(node.attr_ordinal, node.split_key)[rows]
        known = np.isin(segs, list(node.children.keys()))
        # rows whose segment has no child (empty in training) take this
        # node's majority
        out[rows[~known]] = node.prediction
        for seg, child in node.children.items():
            sel = rows[segs == seg]
            if sel.size:
                walk(child, sel)

    walk(tree, np.arange(table.n_rows))
    return out
