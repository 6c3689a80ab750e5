"""The verbs' plan builders.

Counterpart of ``avenir_tpu/cli/plans.py``. Each builder returns a
:class:`~avenir_tpu_torch.plan.Plan` that follows the verb's hand-wired
body node for node, or None where the mode runs no plan (text Naive
Bayes, the streamed trains, KNN's neighbor-record and regression modes,
the journaled per-shard NB and MI passes); the caller then runs the
hand-wired body, which is also the ``plan.enable=false`` path and the
byte-identity oracle.

Builders read the keys as the bodies do (same keys, same defaults) and
import the models inside the node closures, so building a plan for
``--explain`` runs no model code. Keys this port refuses (the
multi-device and live-ANN ones) are refused by name when the plan is
built, as the bodies refuse them.
"""

from __future__ import annotations

from typing import Optional

import torch

from avenir_tpu_torch.plan import fingerprint as FP
from avenir_tpu_torch.plan.graph import Plan
from avenir_tpu_torch.utils.config import JobConfig


def plan_enabled(conf: JobConfig) -> bool:
    """``plan.enable`` (default on). False runs the hand-wired verb
    bodies."""
    return conf.get_bool("plan.enable", True)


def _new_plan(conf: JobConfig, verb: str) -> Plan:
    budget = conf.get_int("plan.cache.budget.bytes", -1)
    return Plan(verb,
                cache_enabled=conf.get_bool("plan.cache", True),
                cache_budget_bytes=budget if budget >= 0 else None)


def _add_staged_train(plan: Plan, conf: JobConfig, in_path: str,
                      device: torch.device, *, with_labels: bool = True,
                      out_path: Optional[str] = None) -> str:
    """The shared encode:train -> stage:train pair; returns the stage's
    fingerprint (dependent tables chain to it). The fingerprint does not
    name the verb: NB's staged train table is KNN's.

    Where the input spans several splits and the featurizer's fit comes
    from the schema alone, the encode is the parallel split ingest
    (``parallel/ingest.py``): the same fingerprint and the same table,
    with the split plan as the encode node's ``ingest`` property. Else
    the serial ``_load_table`` body runs."""
    fp = FP.staged_table_fingerprint(conf, in_path,
                                     with_labels=with_labels)
    from avenir_tpu_torch.parallel import ingest as ING
    iplan = ING.plan_ingest(conf, in_path, with_labels=with_labels)

    if iplan.parallel:
        def _encode(values):
            from avenir_tpu_torch.utils.dataset import Featurizer
            from avenir_tpu_torch.utils.schema import FeatureSchema
            schema = FeatureSchema.from_file(
                conf.get_required("feature.schema.file.path"))
            fz = Featurizer(schema, unseen=conf.get(
                "unseen.value.handling", "error"), device=device)
            fz.fit([])   # the plan checked that the schema fixes the fit
            return fz, iplan

        def _stage(values):
            fz, ip = values["train.rows"]
            table = ING.run_ingest(
                fz, ip, conf, with_labels=with_labels, table_fp=fp,
                journal_dir=(out_path + ".ingest-train")
                if out_path else None, tag="train")
            return fz, table

        plan.add(name="encode:train", kind="encode", run=_encode,
                 output="train.rows", edge_type="split-plan",
                 ingest=iplan.describe(),
                 detail=f"parallel split parse over {in_path} "
                        f"({len(iplan.splits)} splits x "
                        f"{iplan.workers} workers)")
        plan.add(name="stage:train", kind="stage", run=_stage,
                 inputs=("train.rows",), output="train.table",
                 edge_type="staged-table", fingerprint=fp,
                 device=str(device),
                 skips_on_hit=("encode:train",), fused=True,
                 detail="re-sequenced encode pool -> DeviceFeed "
                        "(decode/encode || H2D || assemble)")
        return fp

    def _encode(values):
        from avenir_tpu_torch.cli import main as cli_main
        return cli_main._load_table(conf, in_path, device)

    def _stage(values):
        fz, rows = values["train.rows"]
        return fz, fz.transform(rows, with_labels=with_labels)

    plan.add(name="encode:train", kind="encode", run=_encode,
             output="train.rows", edge_type="row-batch",
             detail=f"parse + featurizer fit over {in_path}")
    plan.add(name="stage:train", kind="stage", run=_stage,
             inputs=("train.rows",), output="train.table",
             edge_type="staged-table", fingerprint=fp,
             device=str(device),
             skips_on_hit=("encode:train",),
             detail="encoded table -> device arrays (content-addressed)")
    return fp


# -- BayesianDistribution ----------------------------------------------------

def build_nb_plan(conf: JobConfig, in_path: str, out_path: str,
                  device: torch.device) -> Optional[Plan]:
    from avenir_tpu_torch.cli import main as cli_main
    from avenir_tpu_torch.utils.dataset import part_file_paths
    if not conf.get_bool("tabular.input", True):
        return None             # text mode
    if conf.get_bool("streaming.train", False):
        return None             # the window-by-window fold
    if len(part_file_paths(in_path)) > 1 and (
            conf.get_bool("shard.parts", False)
            or conf.get_bool("job.resume", False)):
        return None             # the journaled per-shard fold
    cli_main._check_keys(conf, cli_main._LATER_NB)
    plan = _new_plan(conf, "BayesianDistribution")
    _add_staged_train(plan, conf, in_path, device, out_path=out_path)

    def _train(values):
        from avenir_tpu_torch.models import naive_bayes as nb
        _, table = values["train.table"]
        return nb.train(table)

    def _write(values):
        from avenir_tpu_torch.models import naive_bayes as nb
        model, meta, metrics = values["nb.model"]
        nb.save_model(model, meta, out_path,
                      delim=conf.get("field.delim", ","))
        print(metrics.to_json())

    plan.add(name="kernel:nb.train", kind="kernel", run=_train,
             inputs=("train.table",), output="nb.model",
             edge_type="model", detail="count fold (+psum when sharded)")
    plan.add(name="write:model", kind="write", run=_write,
             inputs=("nb.model",), detail=f"model -> {out_path}")
    return plan


# -- NearestNeighbor ---------------------------------------------------------

def _knn_config(conf: JobConfig, fz):
    """The KnnConfig of ``conf``'s keys, as the hand-wired body and the
    plan both build it."""
    from avenir_tpu_torch.models import knn
    return knn.KnnConfig(
        top_match_count=conf.get_int("top.match.count", 5),
        kernel_function=conf.get("kernel.function", "none"),
        kernel_param=conf.get_int("kernel.param", 100),
        class_cond_weighted=(
            conf.get_bool("class.condition.weighted", False)
            or conf.get_bool("class.condtion.weighted", False)),
        inverse_distance_weighted=conf.get_bool(
            "inverse.distance.weighted", False),
        decision_threshold=conf.get_float("decision.threshold", -1.0),
        positive_class=conf.get("positive.class.value"),
        distance_scale=conf.get_int("distance.scale", 1000),
        algorithm=fz.schema.dist_algorithm or "euclidean",
        regression_method=conf.get("regression.method", "average"),
        feed_chunk_rows=conf.get_int("feed.chunk.rows", 0),
        feed_depth=conf.get_int("feed.depth", 2),
        mode=conf.get("knn.mode", "fast"),
        fused=conf.get_bool("knn.fused", True),
        quantized=conf.get_bool("knn.quantized", False),
        quantized_oversample=conf.get_int("knn.quantized.oversample", 4),
        quantized_dtype=conf.get("knn.quantized.dtype", "int8"),
        ann=conf.get_bool("knn.ann", False),
        ann_nlist=conf.get_int("knn.ann.nlist", 0),
        ann_nprobe=conf.get_int("knn.ann.nprobe", 0),
        ann_iters=conf.get_int("knn.ann.iters", 15),
        ann_seed=conf.get_int("knn.ann.seed", 0),
        ann_live=conf.get_bool("knn.ann.live", False),
        ann_live_tail_budget=conf.get_int("knn.ann.live.tail.budget",
                                          1024))


def _ann_provenance(conf: JobConfig) -> Optional[dict]:
    """The knn kernel node's ANN note: the index the scoring goes through,
    whether a staged copy lives in this process already (the one-slot
    caches) and, with the live slot warm, its version, tail fill and
    swaps. A probe: it never builds."""
    if not conf.get_bool("knn.ann", False):
        return None
    live_on = conf.get_bool("knn.ann.live", False)
    prov = {
        "nlist": conf.get_int("knn.ann.nlist", 0) or "auto",
        "nprobe": conf.get_int("knn.ann.nprobe", 0) or "auto",
        "live": live_on,
        "source": "build",
        "reason": "no staged index in-process: k-means build runs "
                  "before the first query batch",
    }
    if live_on:
        prov["tail_budget"] = conf.get_int("knn.ann.live.tail.budget",
                                           1024)
        from avenir_tpu_torch.models.live_ann import peek_live_index
        slot = peek_live_index()
        if slot is not None:
            d = slot.describe()
            prov.update(
                source="cached", nlist=d["nlist"],
                version=d["version"],
                tail_fill=round(float(d["tail_fill"]), 4),
                tail_rows=d["tail_rows"], swaps=d["swaps"],
                reason="live slot is warm (reused when the train table "
                       "and build params match; appended rows probe "
                       "through the overflow tails)")
    else:
        from avenir_tpu_torch.models import knn as knn_mod
        if knn_mod._ANN_INDEX_CACHE:
            prov.update(
                source="cached",
                reason="staged IVF slot is warm (reused when the train "
                       "table and build params match)")
    return prov


def build_knn_plan(conf: JobConfig, in_path: str, out_path: str,
                   device: torch.device) -> Optional[Plan]:
    from avenir_tpu_torch.cli import main as cli_main
    from avenir_tpu_torch.utils.dataset import part_file_paths
    cli_main._check_knn_keys(conf)
    if conf.get("neighbor.data.path"):
        return None             # the neighbor-record replay
    if conf.get("prediction.mode", "classification") == "regression":
        return None             # needs the raw token columns
    validation = conf.get_bool("validation.mode", False)
    delim_in = conf.get("field.delim.regex", ",")
    delim = conf.get("field.delim.out", ",")
    train_path = conf.get_required("train.data.path")
    feed_chunk_rows = conf.get_int("feed.chunk.rows", 0)
    shard_paths = part_file_paths(in_path)
    sharded = (len(shard_paths) > 1
               and conf.get_bool("shard.prefetch", True))

    plan = _new_plan(conf, "NearestNeighbor")
    fp_train = _add_staged_train(plan, conf, train_path, device,
                                 out_path=out_path)

    if sharded:
        # the prefetching shard pipeline: shard n+1 is featurized and
        # staged while shard n scores, each shard's fragment journaled,
        # all inside one node
        def _run_shards(values):
            fz, train = values["train.table"]
            cfg = _knn_config(conf, fz)
            cli_main._run_knn_sharded(conf, cfg, fz, train, shard_paths,
                                      out_path, validation, delim, device)

        plan.add(name="kernel:knn.shards", kind="kernel",
                 run=_run_shards, inputs=("train.table",), fused=True,
                 ann=_ann_provenance(conf),
                 journal={
                     "dir": out_path + ".shards",
                     "shards": len(shard_paths),
                     "resume": conf.get_bool("job.resume", False),
                     "enabled": conf.get_bool("shard.journal", True)},
                 detail="prefetch-staged shard loop: classify + "
                        "journaled fragment write + assemble")
        return plan

    fp_test = FP.staged_table_fingerprint(
        conf, in_path, with_labels=validation,
        feed_chunk_rows=feed_chunk_rows, fit_fingerprint=fp_train)
    # with the chunked feed the test table stays on the host and streams
    # to the device chunk by chunk
    test_device = torch.device("cpu") if feed_chunk_rows > 0 else device

    # the test table encodes through the train-fitted featurizer, so it
    # needs no schema-only fit to go parallel
    from avenir_tpu_torch.parallel import ingest as ING
    iplan_test = ING.plan_ingest(conf, in_path, with_labels=validation,
                                 require_schema_only_fit=False)

    if iplan_test.parallel:
        def _encode_test(values):
            return iplan_test

        def _stage_test(values):
            fz, _ = values["train.table"]
            return ING.run_ingest(
                fz, values["test.rows"], conf, with_labels=validation,
                table_fp=fp_test, journal_dir=out_path + ".ingest-test",
                tag="test", device=test_device)
    else:
        def _encode_test(values):
            from avenir_tpu_torch.utils.dataset import read_csv_lines
            return read_csv_lines(in_path, delim_in)

        def _stage_test(values):
            fz, _ = values["train.table"]
            return fz.transform(values["test.rows"], with_labels=validation,
                                device=test_device)

    def _classify(values):
        from avenir_tpu_torch.models import knn
        fz, train = values["train.table"]
        cfg = _knn_config(conf, fz)
        feature_post = cli_main._knn_feature_post(train, cfg)
        return knn.classify(train, values["test.table"], cfg,
                            feature_post=feature_post)

    def _write(values):
        _, train = values["train.table"]
        cli_main._write_knn_predictions(
            conf, out_path, train, values["test.table"], values["knn.pred"])

    def _validate(values):
        from avenir_tpu_torch.models import knn
        test = values["test.table"]
        if test.labels is None:
            return
        cm = knn.validate(values["knn.pred"], test,
                          positive_class=conf.get("positive.class.value"))
        print(cm.report().to_json())

    plan.add(name="encode:test", kind="encode", run=_encode_test,
             output="test.rows",
             edge_type="split-plan" if iplan_test.parallel
             else "row-batch",
             ingest=iplan_test.describe() if iplan_test.parallel
             else None,
             detail=(f"parallel split parse over {in_path} "
                     f"({len(iplan_test.splits)} splits x "
                     f"{iplan_test.workers} workers)")
             if iplan_test.parallel else f"parse {in_path}")
    plan.add(name="stage:test", kind="stage", run=_stage_test,
             inputs=("train.table", "test.rows"), output="test.table",
             edge_type="staged-table", fingerprint=fp_test,
             device=str(test_device),
             skips_on_hit=("encode:test",), fused=iplan_test.parallel,
             detail="re-sequenced encode pool through the train-fitted "
                    "featurizer" if iplan_test.parallel else
                    "test rows through the train-fitted featurizer")
    plan.add(name="kernel:knn.classify", kind="kernel", run=_classify,
             inputs=("train.table", "test.table"), output="knn.pred",
             edge_type="predictions", fused=feed_chunk_rows > 0,
             ann=_ann_provenance(conf),
             detail=("DeviceFeed chunks overlap H2D with distance+vote"
                     if feed_chunk_rows > 0 else
                     "distance + top-k + vote"))
    plan.add(name="write:predictions", kind="write", run=_write,
             inputs=("train.table", "test.table", "knn.pred"),
             detail=f"id,class lines -> {out_path}")
    if validation:
        plan.add(name="reduce:validate", kind="reduce", run=_validate,
                 inputs=("train.table", "test.table", "knn.pred"),
                 detail="confusion-matrix report -> stdout")
    return plan


# -- MutualInformation -------------------------------------------------------

def build_mi_plan(conf: JobConfig, in_path: str, out_path: str,
                  device: torch.device) -> Optional[Plan]:
    from avenir_tpu_torch.cli import main as cli_main
    from avenir_tpu_torch.utils.dataset import part_file_paths
    if len(part_file_paths(in_path)) > 1 and (
            conf.get_bool("shard.parts", False)
            or conf.get_bool("job.resume", False)):
        return None             # the journaled per-shard fold
    cli_main._check_mi_keys(conf)
    plan = _new_plan(conf, "MutualInformation")
    _add_staged_train(plan, conf, in_path, device, out_path=out_path)

    def _distributions(values):
        from avenir_tpu_torch.explore import mutual_information as mi
        _, table = values["train.table"]
        return mi.compute_distributions(table)

    def _scores(values):
        from avenir_tpu_torch.explore import mutual_information as mi
        return mi.compute_scores(values["mi.dists"], device=device)

    def _write(values):
        cli_main._emit_mi_scores(conf, out_path, values["mi.scores"])

    plan.add(name="kernel:mi.distributions", kind="kernel",
             run=_distributions, inputs=("train.table",),
             output="mi.dists", edge_type="distributions",
             detail="seven count families (+psum when sharded)")
    plan.add(name="reduce:mi.scores", kind="reduce", run=_scores,
             inputs=("mi.dists",), output="mi.scores",
             edge_type="scores", detail="MI scores from count families")
    plan.add(name="write:scores", kind="write", run=_write,
             inputs=("mi.scores",),
             detail=f"score + ranking lines -> {out_path}")
    return plan


# -- RandomForestBuilder -----------------------------------------------------

def build_forest_plan(conf: JobConfig, in_path: str, out_path: str,
                      device: torch.device) -> Optional[Plan]:
    plan = _new_plan(conf, "RandomForestBuilder")
    _add_staged_train(plan, conf, in_path, device, out_path=out_path)

    def _grow(values):
        from avenir_tpu_torch.cli import main as cli_main
        from avenir_tpu_torch.models import forest as F
        _, table = values["train.table"]
        return F.grow_forest(table, cli_main._forest_config(conf))

    def _write(values):
        from avenir_tpu_torch.cli import main as cli_main
        _, table = values["train.table"]
        cli_main._write_forest(out_path, values["forest.model"], table)

    plan.add(name="kernel:forest.grow", kind="kernel", run=_grow,
             inputs=("train.table",), output="forest.model",
             edge_type="model",
             detail="batched whole-forest growth (forest.growth)")
    plan.add(name="write:model", kind="write", run=_write,
             inputs=("train.table", "forest.model"),
             detail=f"stacked tree JSON -> {out_path}")
    return plan


# -- GradientBoostBuilder ----------------------------------------------------

def build_boost_plan(conf: JobConfig, in_path: str, out_path: str,
                     device: torch.device) -> Optional[Plan]:
    if conf.get_bool("streaming.train", False):
        return None             # the out-of-core cached-chunk fold
    plan = _new_plan(conf, "GradientBoostBuilder")
    fp_train = _add_staged_train(plan, conf, in_path, device,
                                 out_path=out_path)
    # the binned catalog depends on the staged table and the split-shaping
    # keys only: other rounds, rates or depths hit it again
    fp_catalog = FP.digest({
        "v": 1, "node": "boost-catalog", "table": fp_train,
        "max_cat_attr_split_groups": conf.get_int(
            "max.cat.attr.split.groups", 3)})

    def _catalog(values):
        from avenir_tpu_torch.cli import main as cli_main
        from avenir_tpu_torch.models import boost as B
        _, table = values["train.table"]
        return B.build_boost_catalog(table,
                                     cli_main._boost_config(conf).tree)

    def _rounds(values):
        from avenir_tpu_torch.cli import main as cli_main
        from avenir_tpu_torch.models import boost as B
        _, table = values["train.table"]
        return B.grow_boosted(table, cli_main._boost_config(conf),
                              catalog=values["boost.catalog"])

    def _write(values):
        from avenir_tpu_torch.cli import main as cli_main
        cli_main._write_boosted(out_path, values["boost.model"])

    plan.add(name="stage:catalog", kind="stage", run=_catalog,
             inputs=("train.table",), output="boost.catalog",
             edge_type="binned-catalog", fingerprint=fp_catalog,
             device=str(device),
             detail="attr plans + device candidate tensors (binned once)")
    plan.add(name="kernel:boost.rounds", kind="kernel", run=_rounds,
             inputs=("train.table", "boost.catalog"),
             output="boost.model", edge_type="model",
             detail="K Newton rounds over the catalog, one readback")
    plan.add(name="write:model", kind="write", run=_write,
             inputs=("boost.model",),
             detail=f"boosted artifact -> {out_path}")
    return plan


# -- dispatch ----------------------------------------------------------------

_BUILDERS = {
    "BayesianDistribution": build_nb_plan,
    "NearestNeighbor": build_knn_plan,
    "MutualInformation": build_mi_plan,
    "RandomForestBuilder": build_forest_plan,
    "GradientBoostBuilder": build_boost_plan,
}


def build_plan(verb: str, conf: JobConfig, in_path: str, out_path: str,
               device: torch.device) -> Optional[Plan]:
    """The plan of (verb, conf, paths), or None where the verb or mode
    runs no plan."""
    builder = _BUILDERS.get(verb)
    if builder is None:
        return None
    return builder(conf, in_path, out_path, device)


def run_plan(verb: str, conf: JobConfig, in_path: str, out_path: str,
             device: torch.device) -> bool:
    """Run the verb as a plan when ``plan.enable`` allows and the mode has
    one; False leaves the hand-wired body to run."""
    if not plan_enabled(conf):
        return False
    plan = build_plan(verb, conf, in_path, out_path, device)
    if plan is None:
        return False
    from avenir_tpu_torch.plan.scheduler import execute
    execute(plan)
    return True
