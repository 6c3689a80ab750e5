"""Random forests over the tree growth of ``models/tree.py``: batched,
serial and out-of-core growth, the majority vote, and the stacked
artifact.

Counterpart of ``avenir_tpu/models/forest.py`` with the same names, the
same draws and the same artifact:

- each tree draws a random attribute subset (``random.split.set.size``)
  and a bootstrap of the rows, kept as per-row multiplicity weights: a
  row of weight c counts as c copies of it in every count;
- **batched growth** (the default for ``best`` selection): the tree axis
  is a leading dimension of the level's tensors. A level is K1 counting
  each tree's (node, feature, bin, class) histogram (one launch for each
  tree and chunk of nodes; ``ops.histogram.node_class_bin_counts``), then
  one selection and one routing for every tree at once, so a level costs
  the same number of torch operations at 3 trees or 50. Each tree's
  candidates outside its subset are masked to -inf before the argmax; the
  catalog is sorted by attribute, so each tree equals the one the serial
  loop grows from the same seed. The records of every level of every tree
  come to the host in one copy. The JAX package pads the tree axis to a
  power of two for its compile cache; here there is nothing to pad;
- **serial growth**: one ``grow_tree_device`` (or, for randomFromTop and
  past the node budget, ``grow_tree``) for each tree, from the same draws;
- **out-of-core growth** (``grow_forest_streaming``): ``max_depth`` passes
  over part files through ``native.prefetch.PrefetchLoader``; each chunk
  replays the levels chosen so far and adds its histogram to the level's
  f32 sum on the device (integers, exact below 2^24), and selection runs
  once a level on the sum;
- prediction: a host walk of each tree, or every tree routed and the vote
  taken on the table's device.

Artifact: JSON ``{"format": 1, "kind": "bagged", "classValues": [...],
"trees": [root dicts]}``, TreePredictor's tree format stacked, written
rename-atomically; the same bytes as the JAX package's.

Entry points run on the device of the table they are given (streamed
growth on the featurizer's device).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.models import tree as T
from avenir_tpu_torch.models.tree import (
    TreeConfig, TreeNode, grow_tree, grow_tree_device,
    predict as predict_tree, splittable_ordinals)
from avenir_tpu_torch.utils.atomicio import atomic_json_dump
from avenir_tpu_torch.utils.dataset import EncodedTable

_GROWTH_MODES = ("auto", "batched", "serial")


@dataclass(frozen=True)
class ForestConfig:
    n_trees: int = 10                     # num.trees
    attrs_per_tree: int = 3               # random.split.set.size
    bagging: bool = True                  # bootstrap rows per tree
    seed: int = 0                         # random.seed
    # "auto" grows the whole forest batched when the tree strategy is
    # `best` (the serial loop past the node budget or out of device
    # memory); "batched"/"serial" pin a path
    growth: str = "auto"                  # forest.growth
    tree: TreeConfig = field(default_factory=TreeConfig)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _validate_forest_config(table_or_none, config: ForestConfig
                            ) -> List[int]:
    if config.n_trees < 1:
        raise ValueError("n_trees must be >= 1")
    if config.attrs_per_tree < 1:
        # an empty split_attributes tuple means "all" to the growers —
        # a zero subset must not silently invert into full-attribute trees
        raise ValueError("attrs_per_tree must be >= 1")
    if config.growth not in _GROWTH_MODES:
        raise ValueError(f"unknown forest growth mode {config.growth!r} "
                         f"(expected one of {_GROWTH_MODES})")
    splittable = (sorted(splittable_ordinals(table_or_none))
                  if table_or_none is not None else [])
    if table_or_none is not None and not splittable:
        raise ValueError("no splittable attributes for a forest")
    return splittable


def _draw_tree_plans(rng: np.random.Generator, splittable: Sequence[int],
                     config: ForestConfig, n_rows: int
                     ) -> List[Tuple[Tuple[int, ...],
                                     Optional[np.ndarray]]]:
    """Per-tree (attribute subset, bootstrap multiplicities): per tree a
    ``choice``, then with bagging a ``multinomial``. This order defines the
    forest; the serial and batched growers share it."""
    size = min(config.attrs_per_tree, len(splittable))
    plans = []
    for _ in range(config.n_trees):
        attrs = tuple(sorted(
            int(a) for a in rng.choice(splittable, size=size,
                                       replace=False)))
        weights = None
        if config.bagging:
            weights = rng.multinomial(
                n_rows, np.full(n_rows, 1.0 / n_rows)).astype(np.float32)
        plans.append((attrs, weights))
    return plans


def grow_forest(table: EncodedTable, config: ForestConfig
                ) -> List[TreeNode]:
    """K trees, each on a random attribute subset and a bootstrap of the
    rows.

    ``best`` selection grows the forest batched (``config.growth`` pins a
    path); randomFromTop draws on the host per node and runs the serial
    loop. Under ``auto`` the batched growth falls back to the serial loop,
    which grows the same forest, in two cases only: a tree's live frontier
    past ``device_node_budget`` (a ValueError naming ``grow_tree``) and
    ``torch.cuda.OutOfMemoryError`` (with a warning). Any other error
    raises."""
    _validate_forest_config(table, config)
    if (config.tree.split_selection_strategy == "best"
            and config.growth in ("auto", "batched")):
        try:
            return grow_forest_batched(table, config)
        except torch.cuda.OutOfMemoryError as exc:
            if config.growth == "batched":
                raise
            from avenir_tpu_torch.utils.profiling import get_logger
            get_logger("models.forest").warning(
                "batched forest growth ran out of device memory, using "
                "the serial per-tree loop: %r", exc)
        except ValueError as exc:
            if config.growth == "batched" or "use grow_tree" not in str(
                    exc):
                raise
    return _grow_forest_serial(table, config)


def _grow_forest_serial(table: EncodedTable, config: ForestConfig
                        ) -> List[TreeNode]:
    """One tree at a time: ``grow_tree_device`` (one readback a tree), or
    ``grow_tree`` for randomFromTop and for a tree past the node budget."""
    splittable = _validate_forest_config(table, config)
    rng = np.random.default_rng(config.seed)
    dev = T._table_device(table)
    trees = []
    for attrs, host_weights in _draw_tree_plans(rng, splittable, config,
                                                table.n_rows):
        # replace() carries every TreeConfig field through
        cfg = replace(config.tree, split_attributes=attrs)
        if cfg.split_selection_strategy != "best":
            # randomFromTop draws from the host rng per node
            trees.append(grow_tree(table, cfg, rng=rng,
                                   row_weights=host_weights))
            continue
        try:
            trees.append(grow_tree_device(
                table, cfg,
                row_weights=None if host_weights is None
                else torch.from_numpy(host_weights).to(dev)))
        except ValueError as exc:
            if "use grow_tree" not in str(exc):
                raise
            # the live frontier overflowed cfg.device_node_budget: the
            # host loop regrows this tree with the same weights
            trees.append(grow_tree(table, cfg, row_weights=host_weights))
    return trees


def _tree_batch_operands(cand, plans_rt, n_rows: int):
    """(cand_mask [Kt, T] bool, row_w0 [Kt, N] f32) of the real trees: each
    tree's attribute subset over the shared catalog, and its bootstrap
    weights (ones without bagging)."""
    attr_of_t = np.asarray([k[0] for k in cand.keys])
    kt = len(plans_rt)
    cand_mask = np.ones((kt, len(cand.keys)), bool)
    row_w0 = np.zeros((kt, n_rows), np.float32)
    for i, (attrs, weights) in enumerate(plans_rt):
        cand_mask[i] = np.isin(attr_of_t, attrs)
        row_w0[i] = 1.0 if weights is None else weights
    return cand_mask, row_w0


def _check_forest_budget(records, kt: int, widths, node_budget: int
                         ) -> None:
    """The single tree's frontier-budget check, tree by tree, with the
    same ``use grow_tree`` hint."""
    for i in range(kt):
        T._check_frontier_budget(
            [{"n_live": rec["n_live"][i]} for rec in records], widths,
            node_budget,
            "raise the budget or use grow_tree (masked, per-level)")


def _build_forest(records, kt: int, keys, class_values: List[str],
                  n_classes: int) -> List[TreeNode]:
    return [T._build_tree(
        [{k: v[i] for k, v in rec.items()} for rec in records],
        keys, class_values, n_classes) for i in range(kt)]


def grow_forest_batched(table: EncodedTable, config: ForestConfig
                        ) -> List[TreeNode]:
    """Every tree of the forest grown together on the table's device: each
    level one K1 histogram for each tree (and chunk of nodes), one
    selection and one routing over the tree axis, and one readback of all
    levels' records. The trees equal :func:`_grow_forest_serial`'s from
    the same config and seed."""
    splittable = _validate_forest_config(table, config)
    if config.tree.split_selection_strategy != "best":
        raise ValueError("batched forest growth supports the 'best' "
                         "strategy; use growth='serial' for randomFromTop")
    if config.tree.max_depth < 1:
        # zero-depth trees are bare leaf roots: the serial loop's shape
        return _grow_forest_serial(table, config)
    plans_rt = _draw_tree_plans(np.random.default_rng(config.seed),
                                splittable, config, table.n_rows)
    return _grow_drawn(table, config, splittable, plans_rt)


def _grow_drawn(table: EncodedTable, config: ForestConfig,
                splittable: Sequence[int], plans_rt) -> List[TreeNode]:
    """:func:`grow_forest_batched` from its drawn per-tree plans."""
    plans = T._attr_plans(table, tuple(splittable),
                          config.tree.max_cat_attr_split_groups)
    cand = T._device_candidates(table, plans)
    cand_mask, row_w0 = _tree_batch_operands(cand, plans_rt, table.n_rows)
    dev = T._table_device(table)
    cfg = config.tree
    records = T._fetch_records(T._grow_levels(
        table.labels, cand, torch.from_numpy(row_w0).to(dev),
        depth=cfg.max_depth, n_classes=table.n_classes,
        algorithm=cfg.algorithm, min_node_size=cfg.min_node_size,
        min_gain=cfg.min_gain, node_budget=cfg.device_node_budget,
        cand_mask=torch.from_numpy(cand_mask).to(dev)))
    kt = len(plans_rt)
    widths = T._level_widths(cfg.max_depth, cand.s_max,
                             cfg.device_node_budget)
    _check_forest_budget(records, kt, widths, cfg.device_node_budget)
    return _build_forest(records, kt, cand.keys, table.class_values,
                         table.n_classes)


# --------------------------------------------------------------------------
# out-of-core growth: level passes over part-file shards
# --------------------------------------------------------------------------

def _chunk_bin_specs(table: EncodedTable, plans) -> List[tuple]:
    """Per-plan (column position, is_categorical, numeric grid): what a
    streamed chunk needs to bin its rows."""
    ord_to_pos = {f.ordinal: i for i, f in enumerate(table.feature_fields)}
    specs = []
    for attr, _keys, is_cat, _column, _aux, _n_seg in plans:
        pos = ord_to_pos[attr]
        grid = (None if is_cat else np.asarray(
            T.numeric_grid(table.feature_fields[pos]), np.float32))
        specs.append((pos, is_cat, grid))
    return specs


def _chunk_bins_host(chunk: EncodedTable, specs) -> np.ndarray:
    """[n, A] int32 bin of every row of a host chunk under every plan
    feature, as ``tree._plan_bins`` bins them (grid points strictly
    below a numeric value, the code of a categorical one)."""
    binned = chunk.binned.cpu().numpy()
    numeric = chunk.numeric.cpu().numpy()
    cols = []
    for pos, is_cat, grid in specs:
        if is_cat:
            cols.append(np.asarray(binned[:, pos], np.int32))
        else:
            col = np.asarray(numeric[:, pos], np.float32)
            cols.append(np.sum(col[:, None] > grid[None, :],
                               axis=1).astype(np.int32))
    return np.stack(cols, axis=1)


def _chunk_weights(config: ForestConfig, kt: int, chunk_index: int,
                   n_rows: int) -> np.ndarray:
    """[Kt, n] bootstrap multiplicities of one chunk, drawn from the seed
    (seed, tree, chunk index), so every level pass redraws the same
    weights. Streamed bagging resamples within each chunk; without
    bagging streamed growth equals :func:`grow_forest_batched` over the
    same rows."""
    w = np.zeros((kt, n_rows), np.float32)
    for i in range(kt):
        if config.bagging:
            rng = np.random.default_rng((config.seed, i, chunk_index))
            w[i] = rng.multinomial(
                n_rows, np.full(n_rows, 1.0 / n_rows)).astype(np.float32)
        else:
            w[i] = 1.0
    return w


def grow_forest_streaming(fz, paths: Sequence[str], config: ForestConfig,
                          *, delim_regex: str = ",",
                          loader_kwargs: Optional[dict] = None
                          ) -> List[TreeNode]:
    """The batched forest grown out of core on ``fz.device``: ``max_depth``
    passes over the part files through ``PrefetchLoader``. Each chunk is
    binned on the host, replays the levels chosen so far for every tree,
    and adds its [Kt, A, K, B, C] histogram (K1) to the level's f32 sum;
    each level's selection runs once on the sum. No two chunks need to be
    resident together.

    ``fz`` must be fitted: the candidate catalog comes from the fit, so
    every chunk sees the same one (the first non-empty chunk defines it;
    empty part files are skipped)."""
    from avenir_tpu_torch.native.prefetch import PrefetchLoader
    if config.tree.split_selection_strategy != "best":
        raise ValueError("streaming forest growth supports the 'best' "
                         "strategy only")
    if config.tree.max_depth < 1:
        raise ValueError("streaming forest growth needs max_depth >= 1")
    _validate_forest_config(None, config)
    if not paths:
        raise ValueError("no part files to stream")
    loader_kwargs = dict(loader_kwargs or {})

    def chunks():
        return PrefetchLoader(fz, list(paths), delim_regex=delim_regex,
                              **loader_kwargs)

    # the catalog from one shard at a time, past empty part files
    first = None
    for path in paths:
        first = next(iter(PrefetchLoader(
            fz, [path], delim_regex=delim_regex, **loader_kwargs)), None)
        if first is not None and first.n_rows > 0:
            break
    if first is None or first.n_rows == 0:
        raise ValueError("streamed part files produced no rows")
    splittable = sorted(splittable_ordinals(first))
    if not splittable:
        raise ValueError("no splittable attributes for a forest")
    rng = np.random.default_rng(config.seed)
    size = min(config.attrs_per_tree, len(splittable))
    subsets = [tuple(sorted(int(a) for a in rng.choice(
        splittable, size=size, replace=False)))
        for _ in range(config.n_trees)]
    cfg = config.tree
    dev = fz.device
    plans = T._attr_plans(first, tuple(splittable),
                          cfg.max_cat_attr_split_groups)
    cand = T._device_candidates(first, plans)
    cand = replace(cand, col_of_t=cand.col_of_t.to(dev),
                   seg_of_bin=cand.seg_of_bin.to(dev))
    bin_specs = _chunk_bin_specs(first, plans)
    kt = config.n_trees
    attr_of_t = np.asarray([k[0] for k in cand.keys])
    cand_mask = torch.from_numpy(np.stack(
        [np.isin(attr_of_t, attrs) for attrs in subsets])).to(dev)

    widths = T._level_widths(cfg.max_depth, cand.s_max,
                             cfg.device_node_budget)
    records: List[dict] = []
    for d in range(cfg.max_depth):
        hist_acc: Optional[torch.Tensor] = None
        for ci, chunk in enumerate(chunks()):
            if chunk.n_rows == 0:
                continue
            bins_c = torch.from_numpy(
                _chunk_bins_host(chunk, bin_specs)).to(dev)
            chunk_cand = replace(cand, bins_rows=bins_c)
            labels = chunk.labels.to(dev)
            row_w = torch.from_numpy(
                _chunk_weights(config, kt, ci, chunk.n_rows)).to(dev)
            node_id = torch.zeros(row_w.shape, dtype=torch.int64,
                                  device=dev)
            for lvl, rec in enumerate(records):
                node_id, row_w = T._route_level_hist(
                    node_id, row_w, rec["best_t"],
                    rec["child_slot"].flatten(-2), chunk_cand,
                    k_next=min(widths[lvl] * cand.s_max,
                               cfg.device_node_budget))
            h = T._level_hist(node_id, row_w, labels, bins_c,
                              k_nodes=widths[d], b_max=cand.b_max,
                              n_classes=first.n_classes)
            hist_acc = h if hist_acc is None else hist_acc + h
        records.append(T._level_select(
            T._counts_from_hist(hist_acc, cand), algorithm=cfg.algorithm,
            min_node_size=cfg.min_node_size, min_gain=cfg.min_gain,
            cand_mask=cand_mask))
    records = T._fetch_records(records)
    _check_forest_budget(records, kt, widths, cfg.device_node_budget)
    return _build_forest(records, kt, cand.keys, first.class_values,
                         first.n_classes)


# --------------------------------------------------------------------------
# prediction + artifact
# --------------------------------------------------------------------------

def _validate_trees(trees: Sequence[TreeNode]) -> List[str]:
    """At least one tree, every tree on the same class vocabulary."""
    if not len(trees):
        raise ValueError(
            "empty forest: no trees to predict with (grow or load a "
            "forest first)")
    class_values = trees[0].class_values
    for i, tree in enumerate(trees):
        if tree.class_values != class_values:
            raise ValueError(
                f"forest trees disagree on class_values: tree 0 has "
                f"{class_values}, tree {i} has {tree.class_values}")
    return class_values


def _route_forest(flat_segs: torch.Tensor, oks: torch.Tensor,
                  split_of_b: torch.Tensor, child_b: torch.Tensor,
                  pred_b: torch.Tensor, valid: torch.Tensor, *, depth: int,
                  s_width: int, n_classes: int, mode: str = "vote"):
    """Every tree's rows routed down its flattened tables at once (the
    tree axis leading), then the majority vote: each valid tree's routed
    class counted, the first class of most votes taken. With
    ``mode="sum"`` (boosted margins) ``pred_b`` holds each node's f32 leaf
    value and the reduction is the sum of the valid trees' routed values.
    Returns (class or summed value of each row, every segmentation
    found)."""
    n = flat_segs.shape[1]
    fs = flat_segs.reshape(-1).long()
    idx = torch.arange(n, device=flat_segs.device)
    node = torch.zeros((split_of_b.shape[0], n), dtype=torch.int64,
                       device=flat_segs.device)
    for _ in range(depth):
        seg = fs[split_of_b.gather(1, node) * n + idx]
        ch = child_b.gather(1, node * s_width + seg)
        node = torch.where(ch >= 0, ch, node)
    preds = pred_b.gather(1, node)                            # [Kt, N]
    if mode == "sum":
        return (preds * valid[:, None].to(preds.dtype)).sum(dim=0), \
            oks.all()
    votes = torch.stack([((preds == c) & valid[:, None]).sum(dim=0)
                         for c in range(n_classes)], dim=1)   # [N, C]
    return torch.argmax(votes, dim=1), oks.all()


def _stack_route_tables(trees: Sequence[TreeNode], table: EncodedTable):
    """The stacked routing operands of :func:`_route_forest`: each
    (attr, key) segmentation computed once across all trees, the
    flattened-tree tables padded to shared power-of-two (tree, node) axes
    (padding trees are not ``valid`` and never vote). Returns (segs, oks,
    split_of_b, child_b, pred_b, val_b, valid, depth, s_width) on the
    table's device: ``pred_b`` each node's class, ``val_b`` its f32 leaf
    value (0 where unset)."""
    dev = T._table_device(table)
    flats = [T._flatten_tree(tree) for tree in trees]
    depth = max(f[4] for f in flats)
    seg_cache: Dict = {}
    global_slot: Dict[Tuple[int, str], int] = {}
    for f in flats:
        for key in f[5]:
            if key not in seg_cache:
                seg_cache[key] = T._device_segments(table, *key)
            global_slot.setdefault(key, len(global_slot))
    ordered = sorted(global_slot, key=global_slot.get)
    if ordered:
        segs = torch.stack([seg_cache[k][0] for k in ordered])
        oks = torch.stack([seg_cache[k][1] for k in ordered])
    else:
        # all-leaf ensemble: one dummy segmentation keeps shapes legal
        segs = torch.zeros((1, table.n_rows), dtype=torch.int8, device=dev)
        oks = torch.ones((1,), dtype=torch.bool, device=dev)

    s_w = max(f[2] for f in flats)
    nn = _pow2(max(len(f[3]) for f in flats))
    kt = _pow2(len(trees))
    split_of_b = np.zeros((kt, nn), np.int64)
    child_b = np.full((kt, nn * s_w), -1, np.int64)
    pred_b = np.zeros((kt, nn), np.int64)
    val_b = np.zeros((kt, nn), np.float32)
    valid = np.zeros(kt, bool)
    for i, (split_of, child_flat, s_width, pred, _d, splits, val) in \
            enumerate(flats):
        n_nodes = len(pred)
        remap = (np.asarray([global_slot[k] for k in splits], np.int64)
                 if splits else np.zeros(1, np.int64))
        split_of_b[i, :n_nodes] = remap[split_of]
        child = np.full((nn, s_w), -1, np.int64)
        child[:n_nodes, :s_width] = child_flat.reshape(n_nodes, s_width)
        child_b[i] = child.reshape(-1)
        pred_b[i, :n_nodes] = pred
        val_b[i, :n_nodes] = val
        valid[i] = True
    return (segs, oks, *(torch.from_numpy(a).to(dev) for a in
                         (split_of_b, child_b, pred_b, val_b, valid)),
            depth, int(s_w))


def _predict_forest_device(trees: Sequence[TreeNode], table: EncodedTable
                           ) -> np.ndarray:
    """Every tree routed and the vote taken on the table's device, one
    readback; equal to the host walk."""
    n_classes = len(trees[0].class_values)
    if max(T._flatten_tree(t)[4] for t in trees) == 0:
        # every tree is a leaf: a constant vote, no routing
        votes = np.zeros(n_classes, np.int64)
        for tree in trees:
            votes[tree.prediction] += 1
        return np.full(table.n_rows, votes.argmax(), np.int64)
    (segs, oks, split_of_b, child_b, pred_b, _val_b, valid, depth,
     s_w) = _stack_route_tables(trees, table)
    out, ok = _route_forest(segs, oks, split_of_b, child_b, pred_b, valid,
                            depth=depth, s_width=s_w, n_classes=n_classes)
    host = torch.cat([out, ok.to(torch.int64)[None]]).cpu().numpy()
    if not host[-1]:
        raise ValueError("split segment not found for some value")
    return host[:-1]


def predict_forest(trees: Sequence[TreeNode], table: EncodedTable,
                   device: bool = False) -> np.ndarray:
    """Majority vote of the trees' per-row leaf predictions (ties to the
    first class); the (attr, key) segmentations are computed once across
    all trees. ``device=True`` routes every tree and votes on the table's
    device; the predictions are the same."""
    _validate_trees(trees)
    n_classes = len(trees[0].class_values)
    if device:
        return _predict_forest_device(trees, table)
    seg_cache: dict = {}
    votes = np.zeros((table.n_rows, n_classes), np.int64)
    for tree in trees:
        pred = predict_tree(tree, table, seg_cache=seg_cache)
        votes[np.arange(table.n_rows), pred] += 1
    return votes.argmax(axis=1)


#: artifact schema version of the tree-ensemble JSON family (bagged
#: forests here; the JAX package's boosted ensembles share it)
ARTIFACT_FORMAT = 1

_KNOWN_KINDS = (
    "'bagged' (majority-vote forest: load_forest/predict_forest), "
    "'boosted' (additive margin ensemble: boost.load_boosted/"
    "BoostedModel.predict)")


def check_artifact_kind(model: dict, *, expect: str, path: str) -> None:
    """Refuse an unknown format version, and a model of the wrong kind
    with an error naming both kinds. Artifacts written before versioning
    carry neither field and are bagged."""
    fmt = model.get("format", ARTIFACT_FORMAT)
    if fmt != ARTIFACT_FORMAT:
        raise ValueError(
            f"unsupported ensemble artifact format {fmt!r} in {path} "
            f"(this build reads format {ARTIFACT_FORMAT})")
    kind = model.get("kind", "bagged")
    if kind != expect:
        raise ValueError(
            f"artifact {path} holds a {kind!r} model but was loaded on "
            f"the {expect!r} predict path; known kinds: {_KNOWN_KINDS}")


def save_forest(trees: Sequence[TreeNode], path: str) -> None:
    """Rename-atomic dump: a failure mid-write leaves any previous artifact
    whole. Stamped with the format version and ``kind: bagged``."""
    class_values = _validate_trees(trees)
    atomic_json_dump(
        {"format": ARTIFACT_FORMAT, "kind": "bagged",
         "classValues": class_values,
         "trees": [t.to_dict() for t in trees]}, path)


def load_forest(path: str) -> List[TreeNode]:
    with open(path) as fh:
        model = json.load(fh)
    check_artifact_kind(model, expect="bagged", path=path)
    return [TreeNode.from_dict(d, model["classValues"])
            for d in model["trees"]]
