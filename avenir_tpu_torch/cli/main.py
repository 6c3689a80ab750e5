"""Driver entry points mirroring the reference's ``hadoop jar <Class>`` verbs:

    python -m avenir_tpu_torch BayesianDistribution IN OUT --conf P [-D k=v]
    python -m avenir_tpu_torch BayesianPredictor    IN OUT --conf P
    python -m avenir_tpu_torch NearestNeighbor      IN OUT --conf P
    python -m avenir_tpu_torch MutualInformation    IN OUT --conf P
    python -m avenir_tpu_torch CramerCorrelation    IN OUT --conf P
    python -m avenir_tpu_torch HeterogeneityReductionCorrelation IN OUT ...
    python -m avenir_tpu_torch TreeBuilder          IN MODEL --conf P
    python -m avenir_tpu_torch TreePredictor        IN OUT --conf P
    python -m avenir_tpu_torch ClassPartitionGenerator IN OUT --conf P
    python -m avenir_tpu_torch SplitGenerator       IN OUT --conf P
    python -m avenir_tpu_torch DataPartitioner      IN NODE_DIR --conf P
    python -m avenir_tpu_torch MarkovStateTransitionModel IN MODEL --conf P
    python -m avenir_tpu_torch MarkovModelClassifier IN OUT --conf P
    python -m avenir_tpu_torch HiddenMarkovModelBuilder IN MODEL --conf P
    python -m avenir_tpu_torch ViterbiStatePredictor IN OUT --conf P
    python -m avenir_tpu_torch RandomForestBuilder  IN MODEL --conf P
    python -m avenir_tpu_torch RandomForestPredictor IN OUT --conf P
    python -m avenir_tpu_torch GreedyRandomBandit   IN OUT --conf P
    python -m avenir_tpu_torch AuerDeterministic    IN OUT --conf P
    python -m avenir_tpu_torch SoftMaxBandit        IN OUT --conf P
    python -m avenir_tpu_torch RandomFirstGreedyBandit IN OUT --conf P
    python -m avenir_tpu_torch GradientBoostBuilder IN MODEL --conf P
    python -m avenir_tpu_torch GradientBoostPredictor IN OUT --conf P
    python -m avenir_tpu_torch SameTypeSimilarity   IN OUT --conf P
    python -m avenir_tpu_torch FeatureCondProbJoiner IN OUT --conf P
    python -m avenir_tpu_torch WordCounter          IN OUT --conf P
    python -m avenir_tpu_torch UnderSamplingBalancer IN OUT --conf P
    python -m avenir_tpu_torch BaggingSampler       IN OUT --conf P
    python -m avenir_tpu_torch LogisticRegressionJob IN OUT --conf P
    python -m avenir_tpu_torch FisherDiscriminant   IN OUT --conf P
    python -m avenir_tpu_torch Projection           IN OUT --conf P
    python -m avenir_tpu_torch ReinforcementLearnerTopology IN OUT --conf P

Counterpart of ``avenir_tpu/cli/main.py`` (``main``, ``_load_table``,
``_knn_feature_post``, ``_emit_mi_scores``, the hand-wired bodies of the
six verbs with the text branches of the two Naive Bayes verbs and
NearestNeighbor's regression and neighbor-record replay
(``_iter_rows_any``, ``_parse_neighbor_records``), the part-file KNN
path: ``_shard_resilience_kwargs``, ``_shard_journal``,
``_print_shard_report``, ``_run_knn_sharded``, and the
five tree verbs with ``_write_predictions``, ``_find_used_attributes``,
``_select_split_attributes``, ``_split_algorithm``, ``_read_raw_lines``,
``_run_data_partitioner_batched``, the four sequence verbs, the two
forest verbs, ``_run_batch_bandit``'s four bandit verbs, the two boosting
verbs, SameTypeSimilarity, FeatureCondProbJoiner, WordCounter, the
streamed and per-shard Naive Bayes and MI paths (``_sharded_featurizer``,
``_run_nb_sharded``, ``_run_mi_sharded``), UnderSamplingBalancer,
BaggingSampler, LogisticRegressionJob, FisherDiscriminant,
Projection, and the online loop of ReinforcementLearnerTopology), with
the same ``.properties`` keys, schemas and output
files. ``--device {cuda,cpu}`` (default cuda) picks where the job runs;
with no GPU and no ``--device cpu`` the job raises.

NearestNeighbor over a directory of more than one MR part file scores it
shard by shard, as the JAX CLI does unless ``shard.prefetch=false``: the
prefetching loader featurizes each part with the native encoder and
stages it to the device while the shard before is scored, under the
``on.bad.row``, ``max.bad.fraction``, ``quarantine.dir``, ``shard.*`` keys,
and each shard commits to a journal that ``--resume`` (``job.resume``)
picks up after a kill. BayesianDistribution and MutualInformation do the
same with ``shard.parts`` or ``--resume``, each shard's counts the
journal's payload.

BayesianDistribution, NearestNeighbor, MutualInformation,
RandomForestBuilder and GradientBoostBuilder run as plans by default
(``cli/plans.py``, ``plan/``), as the JAX CLI does: the staged train table
is cached by content across jobs of one process, and an input of several
``ingest.split.bytes`` splits encodes in parallel
(``parallel/ingest.py``). ``plan.enable=false`` runs the hand-wired bodies
below, with the same bytes. ``--explain`` prints the plan without running
it; ``--metrics-out PATH`` writes the job's telemetry report (``obs/``);
``--profile-dir PATH`` (or ``profile.trace.dir``) writes a
``torch.profiler`` trace of the job.

Keys that select something this port does not carry yet, and the JAX
CLI's other verbs, raise a ValueError naming the key or verb and the
ROADMAP item that ports it; nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from avenir_tpu_torch.utils.config import JobConfig
from avenir_tpu_torch.utils.dataset import (
    Featurizer, iter_csv_rows, part_file_paths, read_csv_lines)
from avenir_tpu_torch.utils.roadmap import roadmap_item
from avenir_tpu_torch.utils.schema import FeatureSchema


# keys that select work outside this port, per verb family: key -> the
# later work that ports it
_MULTI = f"the multi-device layer ({roadmap_item('Multi-device layer')})"
_LATER_NB = {"train.sharded": _MULTI}
_LATER_KNN = {"knn.sharded": _MULTI}
_LATER_MI = {"train.sharded": _MULTI}

# the JAX CLI's verbs this port does not carry yet -> the ROADMAP queue A
# item that ports them (none: every verb runs)
_LATER_VERBS: Dict[str, str] = {}


def _refuse(key: str, later: str) -> None:
    raise ValueError(f"{key} is not supported by avenir_tpu_torch yet: "
                     f"{later} ports it; run avenir_tpu for this job")


def _check_keys(conf: JobConfig, later: Dict[str, str]) -> None:
    for key, work in later.items():
        if conf.get_bool(key, False):
            flag = " (--resume)" if key == "job.resume" else ""
            _refuse(f"{key}={conf.get(key)}{flag}", work)


def _load_table(conf: JobConfig, in_path: str, device: torch.device,
                for_predict: bool = False):
    schema = FeatureSchema.from_file(
        conf.get_required("feature.schema.file.path"))
    delim = conf.get("field.delim.regex", ",")
    rows = read_csv_lines(in_path, delim)
    fz = Featurizer(schema, unseen=conf.get("unseen.value.handling", "error"),
                    device=device)
    fit_rows = rows
    if for_predict and fz.schema_data_dependent:
        fit_path = conf.get("featurizer.fit.data.path")
        if fit_path is None:
            raise ValueError(
                "schema has data-dependent vocabularies (categorical without "
                "cardinality or bucketed numeric without min/max); set "
                "featurizer.fit.data.path to the training data so predict-time "
                "encoding matches the saved model")
        fit_rows = read_csv_lines(fit_path, delim)
    fz.fit(fit_rows)
    return fz, rows


def run_bayesian_distribution(conf: JobConfig, in_path: str, out_path: str,
                              device: torch.device) -> None:
    """Train Naive Bayes distributions (reference BayesianDistribution).
    ``tabular.input=false`` switches to text mode
    (BayesianDistribution.java:115-131): rows are ``text<delim>classVal``
    and every token becomes a bin of the text feature at ordinal 1. Over a
    dir of more than one MR part file with ``shard.parts`` or ``job.resume``
    (``--resume``) the counts fold shard by shard into a journal
    (``_run_nb_sharded``); ``streaming.train`` folds the file window by
    window (``stream.window.bytes``) without holding the table. The
    tabular in-core mode runs as a plan (``cli/plans.py``) unless
    ``plan.enable=false``."""
    from avenir_tpu_torch.cli import plans as cli_plans
    from avenir_tpu_torch.models import naive_bayes as nb
    if cli_plans.run_plan("BayesianDistribution", conf, in_path, out_path,
                          device):
        return
    if not conf.get_bool("tabular.input", True):
        from avenir_tpu_torch.text import text_bayes
        rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
        model, metrics = text_bayes.train(rows, device=device)
        text_bayes.save_model(model, out_path,
                              delim=conf.get("field.delim", ","))
        print(metrics.to_json())
        return
    shard_paths = part_file_paths(in_path)
    if len(shard_paths) > 1 and (conf.get_bool("shard.parts", False)
                                 or conf.get_bool("job.resume", False)):
        _run_nb_sharded(conf, in_path, out_path, shard_paths, device)
        return
    if conf.get_bool("streaming.train", False):
        fz = _sharded_featurizer(
            conf, device,
            "streaming.train needs a fully-specified schema (cardinalities "
            "+ min/max) or featurizer.fit.data.path pointing at a bounded "
            "sample — fitting vocabularies from the stream would "
            "materialize it")
        model, meta, metrics = nb.train_streamed(
            fz, in_path, conf.get("field.delim.regex", ","),
            window_bytes=conf.get_int("stream.window.bytes", 32 << 20),
            device=device)
        nb.save_model(model, meta, out_path,
                      delim=conf.get("field.delim", ","))
        print(metrics.to_json())
        return
    _check_keys(conf, _LATER_NB)
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    model, meta, metrics = nb.train(table)
    nb.save_model(model, meta, out_path, delim=conf.get("field.delim", ","))
    print(metrics.to_json())


_SHARDED_FIT = ("sharded-parts training (shard.parts / --resume on a part "
                "dir) needs a fully-specified schema (cardinalities + "
                "min/max) or featurizer.fit.data.path pointing at a "
                "bounded clean sample — fitting vocabularies from the raw "
                "part dir would materialize it and die on poison rows")


def _sharded_featurizer(conf: JobConfig, device: torch.device,
                        message: str = _SHARDED_FIT) -> Featurizer:
    """A featurizer fit without reading the job's input: from the schema
    alone when it fixes every vocabulary and range, else from
    ``featurizer.fit.data.path`` (a bounded sample); neither raises
    ``message``. The streamed and per-shard paths fit so: a fit over
    their input would hold it whole, and die on the poison rows that
    ``on.bad.row`` exists to survive."""
    schema = FeatureSchema.from_file(
        conf.get_required("feature.schema.file.path"))
    fz = Featurizer(schema, unseen=conf.get("unseen.value.handling", "error"),
                    device=device)
    if fz.schema_data_dependent:
        fit_path = conf.get("featurizer.fit.data.path")
        if fit_path is None:
            raise ValueError(message)
        fz.fit(read_csv_lines(fit_path, conf.get("field.delim.regex", ",")))
    else:
        fz.fit([])
    return fz


def run_bayesian_predictor(conf: JobConfig, in_path: str, out_path: str,
                           device: torch.device) -> None:
    """Predict with a trained model (reference BayesianPredictor). Honors
    ``field.delim.out``, ``bp.predict.class``, ``bp.predict.class.cost``,
    ``class.prob.diff.threshold`` and ``output.feature.prob.only``; with
    ``tabular.input=false`` it classifies ``text[<delim>classVal]`` rows
    with a text model (``laplace.smoothing`` defaults to 1.0 there)."""
    from avenir_tpu_torch.models import naive_bayes as nb
    _check_keys(conf, _LATER_NB)
    if not conf.get_bool("tabular.input", True):
        _run_text_bayes_predictor(conf, in_path, out_path, device)
        return
    fz, rows = _load_table(conf, in_path, device, for_predict=True)
    table = fz.transform(rows)
    meta = nb.BayesModelMeta.from_table(table)
    model = nb.load_model(conf.get_required("bayesian.model.file.path"), meta,
                          delim=conf.get("field.delim", ","), device=device)
    delim = conf.get("field.delim.out", ",")
    predicting = conf.get_list("bp.predict.class", None, delim)
    costs = conf.get_int_list("bp.predict.class.cost", None, delim)
    diff_threshold = conf.get_int("class.prob.diff.threshold", -1)
    pred = nb.predict(
        model, meta, table,
        laplace=conf.get_float("laplace.smoothing", 0.0),
        predicting_classes=tuple(predicting) if predicting else None,
        class_cost=tuple(costs) if costs else None,
        class_prob_diff_threshold=diff_threshold)
    feature_prob_only = conf.get_bool("output.feature.prob.only", False)
    labels = table.labels.cpu().numpy() if table.labels is not None else None
    with open(out_path, "w") as fh:
        for i in range(table.n_rows):
            if feature_prob_only:
                # itemID, featurePriorProb, (classVal, postProb)*, classAttrVal
                parts = [table.ids[i], str(pred.feature_prior[i])]
                for ci, cls in enumerate(table.class_values):
                    parts += [cls, str(pred.feature_post[i, ci])]
                if labels is not None:
                    parts.append(table.class_values[int(labels[i])])
            else:
                parts = [delim.join(rows[i]),
                         table.class_values[int(pred.predicted[i])],
                         str(int(pred.prob[i]))]
                if diff_threshold > 0 and pred.ambiguous is not None:
                    parts.append(
                        "ambiguous" if pred.ambiguous[i] else "classified")
            fh.write(delim.join(parts) + "\n")
    if conf.get_bool("validation.mode", False) and table.labels is not None:
        cm = nb.validate(pred, table,
                         positive_class=conf.get("positive.class.value"))
        print(cm.report().to_json())


def _run_text_bayes_predictor(conf: JobConfig, in_path: str, out_path: str,
                              device: torch.device) -> None:
    """The text branch of BayesianPredictor: each row with its predicted
    class appended, and the report under ``validation.mode``."""
    from avenir_tpu_torch.text import text_bayes
    delim = conf.get("field.delim.out", ",")
    rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    model = text_bayes.load_model(
        conf.get_required("bayesian.model.file.path"),
        delim=conf.get("field.delim", ","), device=device)
    truth = None
    if conf.get_bool("validation.mode", False):
        short = [i for i, r in enumerate(rows) if len(r) < 2]
        if short:
            raise ValueError(
                f"validation.mode=true but rows {short[:5]} have no "
                "class column (expected text<delim>classVal)")
        truth = [r[1] for r in rows]
    labels, _, cm = text_bayes.predict(
        model, [r[0] for r in rows],
        laplace=conf.get_float("laplace.smoothing", 1.0), truth=truth)
    with open(out_path, "w") as fh:
        for row, label in zip(rows, labels):
            fh.write(delim.join([delim.join(row), label]) + "\n")
    if cm is not None:
        print(cm.report().to_json())


def run_same_type_similarity(conf: JobConfig, in_path: str, out_path: str,
                             device: torch.device) -> None:
    """The pairwise scaled-int distance matrix (the sifarish
    SameTypeSimilarity MR the reference shells out to, resource/knn.sh
    :44-47), ``ops/distance.pairwise_full`` on ``device``. Output lines
    ``id1,id2,distance``, without the self-pairs. ``inter.set.matching=true``
    (resource/knn.properties:13) matches the input rows against
    ``train.data.path``: lines ``testId,trainId,distance``, every pair,
    both sets encoded by a featurizer fitted on the train set (the fused
    NearestNeighbor path's convention). The lines are formatted a block of
    about a million pairs at a time."""
    from avenir_tpu_torch.models.knn import _split_features
    from avenir_tpu_torch.ops.distance import pairwise_full
    inter = conf.get_bool("inter.set.matching", False)
    if inter:
        fz, rows2 = _load_table(conf, conf.get_required("train.data.path"),
                                device)
        rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
        table = fz.transform(rows)
        num, cat, n_bins = _split_features(table)
        other = fz.transform(rows2)
        o_num, o_cat, _ = _split_features(other)
    else:
        fz, rows = _load_table(conf, in_path, device)
        table = fz.transform(rows)
        num, cat, n_bins = _split_features(table)
        other, o_num, o_cat = table, num, cat
    dist = pairwise_full(
        num, o_num, cat, o_cat,
        algorithm=fz.schema.dist_algorithm or "euclidean",
        n_cat_bins=n_bins,
        distance_scale=conf.get_int("distance.scale", 1000)).cpu().numpy()
    delim = conf.get("field.delim.out", ",")
    left_ids = np.asarray(table.ids)
    right_ids = np.asarray(other.ids)
    n_right = len(right_ids)
    block = max(1, (1 << 20) // max(n_right, 1))
    with open(out_path, "w") as fh:
        for i0 in range(0, table.n_rows, block):
            i1 = min(i0 + block, table.n_rows)
            b = i1 - i0
            left = np.repeat(left_ids[i0:i1], n_right)
            right = np.tile(right_ids, b)
            d = np.char.mod("%d", dist[i0:i1].reshape(-1))
            lines = np.char.add(
                np.char.add(np.char.add(np.char.add(left, delim), right),
                            delim), d)
            if not inter:
                # the reference emits i != j only
                keep = np.ones(b * n_right, bool)
                keep[np.arange(b) * n_right + np.arange(i0, i1)] = False
                lines = lines[keep]
            fh.write("\n".join(lines.tolist()))
            fh.write("\n")


def run_feature_cond_prob_joiner(conf: JobConfig, in_path: str,
                                 out_path: str,
                                 device: torch.device) -> None:
    """Join each training item's class-conditional probability onto its
    neighbor-distance records: the FeatureCondProbJoiner MR stage
    (FeatureCondProbJoiner.java:95-178) as a file. ``in_path``: distance
    records ``testId,trainId,distance`` (SameTypeSimilarity's output);
    ``feature.prob.path``: BayesianPredictor's
    ``output.feature.prob.only=true`` artifact
    (``itemID,featurePriorProb,(classVal,postProb)*,classAttrVal``);
    optional ``test.class.path``: the test CSV, for each test entity's
    class. Output: the class-conditional layout ``testId,testClass,
    trainId,rank,trainClass,postProb`` (NearestNeighbor.java:135-149;
    testClass empty when unknown). A host job: nothing runs on
    ``device``."""
    delim = conf.get("field.delim.regex", ",")
    out_delim = conf.get("field.delim.out", ",")
    prob_path = conf.get_required("feature.prob.path")
    train_class: dict = {}
    train_post: dict = {}
    for items in read_csv_lines(prob_path, delim):
        tid, cls = items[0], items[-1]
        pairs = items[2:-1]
        post = dict(zip(pairs[0::2], pairs[1::2]))
        train_class[tid] = cls
        train_post[tid] = post.get(cls, "0")
    test_class: dict = {}
    tc_path = conf.get("test.class.path")
    if tc_path:
        fz, rows = _load_table(conf, tc_path, device)
        id_f = fz.schema.find_id_field()
        cls_f = fz.schema.find_class_attr_field()
        for r in rows:
            test_class[r[id_f.ordinal]] = r[cls_f.ordinal]
    n = 0
    with open(out_path, "w") as fh:
        for items in _iter_rows_any(in_path, delim):
            test_id, train_id, rank = items[0], items[1], items[2]
            if train_id not in train_class:
                raise ValueError(
                    f"train entity {train_id!r} missing from the feature-"
                    f"prob artifact {prob_path}")
            fh.write(out_delim.join(
                [test_id, test_class.get(test_id, ""), train_id, rank,
                 train_class[train_id], train_post[train_id]]) + "\n")
            n += 1
    print(f'{{"Join.Records": {n}}}')


def _iter_rows_any(path: str, delim: str):
    """Tokenized rows one at a time, over a file or the files of an MR
    part-file dir (``part_file_paths``): neighbor and distance files hold
    |test| × |train| records, too many to hold as token lists."""
    for full in part_file_paths(path):
        yield from iter_csv_rows(full, delim)


def _parse_neighbor_records(conf: JobConfig, path: str, class_cond: bool,
                            validation: bool, device: torch.device):
    """The reference TopMatchesMapper's input layouts
    (NearestNeighbor.java:135-159) and the raw 3-field distance file, as
    ``classify_from_neighbors`` record dicts. Returns ``(make_records,
    width)``: ``make_records()`` streams the records one at a time (a
    caller that needs a second pass calls it again), ``width`` is the
    file's field count. The 3-field layout joins the train classes of
    ``train.data.path`` and, for validation, the test classes of
    ``test.class.path``, both loaded once, outside the stream."""
    delim = conf.get("field.delim.regex", ",")
    width = len(next(_iter_rows_any(path, delim), ()))
    if width == 0:
        return (lambda: iter(())), 0
    if width == 3:
        fz, train_rows = _load_table(
            conf, conf.get_required("train.data.path"), device)
        id_f = fz.schema.find_id_field()
        cls_f = fz.schema.find_class_attr_field()
        cls_of = {r[id_f.ordinal]: r[cls_f.ordinal] for r in train_rows}
        tcls_of = {}
        tcls_path = conf.get("test.class.path")
        if validation and tcls_path:
            _, test_rows = _load_table(conf, tcls_path, device)
            tcls_of = {r[id_f.ordinal]: r[cls_f.ordinal] for r in test_rows}

        def make_records():
            for rec in _iter_rows_any(path, delim):
                if rec[1] not in cls_of:
                    raise ValueError(
                        f"distance record references train entity "
                        f"{rec[1]!r} not present in train.data.path "
                        f"({conf.get('train.data.path')})")
                if tcls_of and rec[0] not in tcls_of:
                    raise ValueError(
                        f"distance record references test entity "
                        f"{rec[0]!r} not present in test.class.path "
                        f"({tcls_path})")
                yield {"test_id": rec[0], "rank": rec[2],
                       "train_class": cls_of[rec[1]],
                       "test_class": tcls_of.get(rec[0])}
    elif class_cond:
        # 6 fields: testId, testClass, trainId, rank, trainClass, postProb;
        # 5 fields (emitters without the class column): testId, trainId,
        # rank, trainClass, postProb
        off = 1 if width >= 6 else 0

        def make_records():
            for rec in _iter_rows_any(path, delim):
                yield {"test_id": rec[0],
                       "test_class": (rec[1] or None) if off else None,
                       "rank": rec[2 + off],
                       "train_class": rec[3 + off],
                       "post": rec[4 + off]}
    else:
        # trainId, testId, rank, trainClass [, testClass]
        def make_records():
            for rec in _iter_rows_any(path, delim):
                yield {"test_id": rec[1], "rank": rec[2],
                       "train_class": rec[3],
                       "test_class": (rec[4] if validation
                                      and len(rec) > 4 else None)}
    return make_records, width


def _knn_feature_post(train, cfg):
    """Optional [N_train, C] class-conditional probability table — the
    in-memory fusion of the knn.sh bayesianDistr/bayesianPredictor/join
    legs."""
    if not cfg.class_cond_weighted:
        return None
    from avenir_tpu_torch.models import naive_bayes as nb
    model, meta, _ = nb.train(train)
    bp = nb.predict(model, meta, train, laplace=1.0)
    return torch.from_numpy(bp.feature_post).to(train.device)


# -- the part-file KNN path ---------------------------------------------------

def _shard_resilience_kwargs(conf: JobConfig, parse_stats) -> Dict:
    """The PrefetchLoader's retry, speculation and bad-row knobs from the
    job's config."""
    return dict(
        retries=conf.get_int("shard.retries", 1),
        shard_timeout_s=conf.get_float("shard.timeout.s", 0.0) or None,
        speculate=conf.get_bool("shard.speculate", True),
        speculative_factor=conf.get_float("shard.speculative.factor", 4.0),
        speculative_min_wait_s=conf.get_float(
            "shard.speculative.min.wait.s", 2.0),
        on_bad_row=conf.get("on.bad.row", "raise"),
        max_bad_fraction=conf.get_float("max.bad.fraction", 0.1),
        quarantine_dir=conf.get("quarantine.dir"),
        parse_stats=parse_stats)


def _shard_journal(conf: JobConfig, verb: str, shard_paths, out_path: str):
    """(journal, completed records, nonce) of a sharded job, under
    ``shard.journal`` (default on: a killed job stays resumable) and
    ``job.resume`` (``--resume``). The fingerprint covers the verb, the
    shard list (name and size) and the config without the switches that
    change only what is printed, so ``--resume`` into a journal another
    job wrote refuses instead of mixing outputs."""
    from avenir_tpu_torch.utils.resume import (
        ShardJournal, job_fingerprint, run_nonce, shard_file_facts)
    resume = conf.get_bool("job.resume", False)
    use_journal = conf.get_bool("shard.journal", True)
    if resume and not use_journal:
        raise ValueError("--resume (job.resume) needs shard.journal=true")
    if not use_journal:
        return None, {}, run_nonce()
    # a resumed run differs from the killed one in exactly these keys
    conf_fp = {k: v for k, v in conf.as_dict().items()
               if k not in ("job.resume", "shard.journal.keep",
                            "shard.report")}
    journal = ShardJournal(
        out_path + ".shards",
        job_fingerprint({"verb": verb,
                         "shards": shard_file_facts(shard_paths),
                         "conf": conf_fp}),
        len(shard_paths))
    return journal, journal.open(resume=resume), run_nonce()


def _print_shard_report(conf: JobConfig, *, shards_total: int,
                        shards_resumed: int, shards_computed: int,
                        rows_quarantined: int, loader) -> None:
    """The exact-accounting JSON line, printed only when resilience is
    armed (a default run prints what the merged path prints)."""
    if not (conf.get_bool("job.resume", False)
            or conf.get("on.bad.row", "raise") != "raise"
            or conf.get_bool("shard.report", False)):
        return
    stats = loader.stats
    print(json.dumps({
        "shards_total": shards_total,
        "shards_resumed": shards_resumed,
        "shards_computed": shards_computed,
        "rows_quarantined": rows_quarantined,
        "shard_retries": stats.shard_retries,
        "speculative_launches": stats.speculative_launches,
        "speculative_wins": stats.speculative_wins,
        "duplicates_discarded": stats.duplicates_discarded,
    }, sort_keys=True))


def _run_count_shards(conf: JobConfig, verb: str, fz, shard_paths,
                      out_path: str, count, finish,
                      device: torch.device) -> None:
    """The per-shard count pass of NB and MI over an MR part-file dir:
    the PrefetchLoader featurizes each pending shard and stages it on
    ``device`` while the one before counts (``count(table)`` -> a dict of
    arrays); each shard's counts commit to the journal as a payload, and
    a ``--resume`` reads the committed ones instead of recounting. Then
    ``finish(the payloads' float64 sum or None, rows)`` writes the job's
    output, the shard report follows, and the journal goes unless
    ``shard.journal.keep``."""
    from avenir_tpu_torch.models.naive_bayes import model_sum
    from avenir_tpu_torch.native.loader import ParseStats
    from avenir_tpu_torch.native.prefetch import PrefetchLoader
    parse_stats = ParseStats()
    journal, completed, nonce = _shard_journal(conf, verb, shard_paths,
                                               out_path)
    if journal is None:
        raise ValueError("shard.parts needs shard.journal=true (the "
                         "partial-count payloads live in the journal)")
    parts = [journal.read_payload(i) for i in sorted(completed)]
    n_rows = sum(int(rec.get("rows", 0)) for rec in completed.values())
    quarantined = sum(int(rec.get("rows_quarantined", 0))
                      for rec in completed.values())
    pending = [(i, p) for i, p in enumerate(shard_paths)
               if i not in completed]
    loader = PrefetchLoader(
        fz, [p for _, p in pending], conf.get("field.delim.regex", ","),
        with_labels=True, depth=conf.get_int("shard.prefetch.depth", 2),
        to_device=True, device=device,
        **_shard_resilience_kwargs(conf, parse_stats))
    tables = iter(loader)
    for i, path in pending:
        table = next(tables)
        part = {k: np.asarray(v, np.float64)
                for k, v in count(table).items()}
        journal.write_payload(i, part)
        journal.mark_done(i, {
            "file": os.path.basename(path),
            "rows": int(table.n_rows),
            "rows_quarantined": int(parse_stats.per_file.get(path, 0)),
            "payload": True,
            "run": nonce})
        parts.append(part)
        n_rows += table.n_rows
    finish(model_sum(parts), n_rows)
    _print_shard_report(
        conf, shards_total=len(shard_paths), shards_resumed=len(completed),
        shards_computed=len(pending),
        rows_quarantined=quarantined + sum(parse_stats.per_file.values()),
        loader=loader)
    if not conf.get_bool("shard.journal.keep", False):
        journal.cleanup()


def _run_nb_sharded(conf: JobConfig, in_path: str, out_path: str,
                    shard_paths, device: torch.device) -> None:
    """Resumable Naive Bayes train over an MR part-file dir: each shard's
    counts (K1 once a shard) commit to the journal, ``--resume`` reuses
    every committed shard's, and the float64 sum makes the model file the
    merged-table train's, byte for byte."""
    from avenir_tpu_torch.models import naive_bayes as nb
    fz = _sharded_featurizer(conf, device)
    meta = nb.BayesModelMeta.from_table(
        fz.transform([], with_labels=True, device="cpu"))

    def finish(acc, n_rows):
        if acc is None or n_rows == 0:
            raise ValueError(f"no rows in {in_path}")
        nb.save_model(nb.model_from_numpy(acc, device), meta, out_path,
                      delim=conf.get("field.delim", ","))
        print(nb.train_metrics(n_rows, meta).to_json())

    _run_count_shards(conf, "BayesianDistribution", fz, shard_paths,
                      out_path, lambda t: nb.train(t)[0].as_numpy(), finish,
                      device)


_MI_FAMILIES = ("class_counts", "feature", "feature_class", "feature_pair",
                "feature_pair_class")


def _run_mi_sharded(conf: JobConfig, in_path: str, out_path: str,
                    shard_paths, device: torch.device) -> None:
    """Resumable MutualInformation over an MR part-file dir: the count
    families add over rows, so each shard's (K4 once a shard for the
    pairs) commit to the journal and sum; the float64 sum casts back to
    the merged pass's f32 exactly below 2^24, so the output is the merged
    job's, byte for byte."""
    from avenir_tpu_torch.explore import mutual_information as mi
    fz = _sharded_featurizer(conf, device)
    meta_table = fz.transform([], with_labels=True, device="cpu")
    # fail before any shard parses, as the merged pass would
    if any(meta_table.is_continuous):
        raise ValueError("mutual information needs all features binned "
                         "(categorical or bucketWidth numeric)")

    def count(table):
        d = mi.compute_distributions(table)
        return {k: getattr(d, k) for k in _MI_FAMILIES}

    def finish(acc, _n_rows):
        if acc is None:
            raise ValueError(f"no rows in {in_path}")
        dists = mi.MiDistributions(
            **{k: np.asarray(acc[k], np.float32) for k in _MI_FAMILIES},
            feature_ordinals=tuple(f.ordinal
                                   for f in meta_table.feature_fields),
            class_values=tuple(meta_table.class_values))
        _emit_mi_scores(conf, out_path,
                        mi.compute_scores(dists, device=device))

    _run_count_shards(conf, "MutualInformation", fz, shard_paths, out_path,
                      count, finish, device)


def _run_knn_sharded(conf: JobConfig, cfg, fz, train, shard_paths, out_path,
                     validation: bool, delim: str,
                     device: torch.device) -> None:
    """Classification over an MR part-file dir, one shard at a time: a
    PrefetchLoader worker featurizes shard n+1 and stages it on the device
    while shard n scores (K2, one launch a shard). The output rows come in
    the merged path's order (the same sorted walk; each row is scored on
    its own).

    Attempts retry and speculate under the ``shard.*`` keys, bad rows
    follow ``on.bad.row``, and with ``shard.journal`` (default on) each
    shard's output fragment and completion record commit rename-atomically
    to ``<out>.shards/``, so a killed job run again with ``--resume``
    skips every completed shard; the output is put together from the
    fragments in shard order, the bytes of an uninterrupted run."""
    from avenir_tpu_torch.models import knn
    from avenir_tpu_torch.native.loader import ParseStats
    from avenir_tpu_torch.native.prefetch import PrefetchLoader
    from avenir_tpu_torch.utils.metrics import ConfusionMatrix
    feature_post = _knn_feature_post(train, cfg)
    # shard tables arrive on the device: the chunked feed (which streams a
    # host table) stays off
    cfg = dataclasses.replace(cfg, feed_chunk_rows=0)
    parse_stats = ParseStats()
    journal, completed, nonce = _shard_journal(
        conf, "NearestNeighbor", shard_paths, out_path)
    output_distr = conf.get_bool("output.class.distr", False)
    positive_class = conf.get("positive.class.value")
    cm = (ConfusionMatrix(train.class_values, positive_class=positive_class)
          if validation else None)
    cm_updated = False
    quarantined_resumed = 0
    for i in sorted(completed):
        rec = completed[i]
        quarantined_resumed += int(rec.get("rows_quarantined", 0))
        if cm is not None and rec.get("cm") is not None:
            cm.matrix += np.asarray(rec["cm"], dtype=np.int64)
            cm.invalid += int(rec.get("cm_invalid", 0))
            cm_updated = True

    pending = [(i, p) for i, p in enumerate(shard_paths)
               if i not in completed]
    loader = PrefetchLoader(
        fz, [p for _, p in pending], conf.get("field.delim.regex", ","),
        with_labels=validation,
        depth=conf.get_int("shard.prefetch.depth", 2),
        to_device=True, bucket=True, device=device,
        **_shard_resilience_kwargs(conf, parse_stats))
    direct = open(out_path, "w") if journal is None else None
    try:
        tables = iter(loader)
        for i, path in pending:
            test = next(tables)
            pred = knn.classify(train, test, cfg, feature_post=feature_post)
            lines = []
            for r in range(test.n_rows):
                parts = [test.ids[r],
                         train.class_values[int(pred.predicted[r])]]
                if output_distr and pred.class_prob is not None:
                    for ci, cls in enumerate(train.class_values):
                        parts += [cls, str(int(pred.class_prob[r, ci]))]
                lines.append(delim.join(parts))
            shard_cm = None
            if cm is not None and test.labels is not None:
                shard_cm = ConfusionMatrix(train.class_values,
                                           positive_class=positive_class)
                shard_cm.update(pred.predicted, test.labels)
                cm.matrix += shard_cm.matrix
                cm.invalid += shard_cm.invalid
                cm_updated = True
            text = "\n".join(lines) + ("\n" if lines else "")
            if journal is not None:
                # the fragment first, the record after: a kill between the
                # two leaves a shard to recompute
                journal.write_fragment(i, text)
                journal.mark_done(i, {
                    "file": os.path.basename(path),
                    "rows": int(test.n_rows),
                    "rows_quarantined":
                        int(parse_stats.per_file.get(path, 0)),
                    "cm": (None if shard_cm is None
                           else shard_cm.matrix.tolist()),
                    "cm_invalid": (0 if shard_cm is None
                                   else int(shard_cm.invalid)),
                    "fragment": True,
                    "run": nonce})
            else:
                direct.write(text)
    finally:
        if direct is not None:
            direct.close()
    if journal is not None:
        journal.assemble(out_path)
    # as the merged path: shards without labels print no report
    if cm is not None and cm_updated:
        print(cm.report().to_json())
    _print_shard_report(
        conf, shards_total=len(shard_paths), shards_resumed=len(completed),
        shards_computed=len(pending),
        rows_quarantined=(quarantined_resumed
                          + sum(parse_stats.per_file.values())),
        loader=loader)
    if journal is not None and not conf.get_bool("shard.journal.keep",
                                                 False):
        journal.cleanup()


def _run_knn_replay(conf: JobConfig, neighbor_path: str, out_path: str,
                    validation: bool, device: torch.device) -> None:
    """NearestNeighbor over precomputed neighbor records
    (``neighbor.data.path``): a sifarish-format pipeline replays as it is.
    The records stream twice, once for the class vocabulary and once
    through ``classify_from_neighbors``' bounded heaps; the record file is
    never held whole."""
    from avenir_tpu_torch.models import knn
    from avenir_tpu_torch.utils.metrics import ConfusionMatrix
    class_cond = (conf.get_bool("class.condition.weighted", False)
                  or conf.get_bool("class.condtion.weighted", False))
    if conf.get("prediction.mode", "classification") != "classification":
        raise ValueError("neighbor.data.path supports classification "
                         "(regression needs the fused path)")
    make_records, rec_width = _parse_neighbor_records(
        conf, neighbor_path, class_cond, validation, device)
    cls_set: set = set()
    for r in make_records():
        cls_set.add(r["train_class"])
        if r.get("test_class") is not None:
            cls_set.add(r["test_class"])
    class_values = sorted(cls_set)
    cfg = knn.KnnConfig(
        top_match_count=conf.get_int("top.match.count", 5),
        kernel_function=conf.get("kernel.function", "none"),
        kernel_param=conf.get_int("kernel.param", 100),
        class_cond_weighted=class_cond,
        inverse_distance_weighted=conf.get_bool(
            "inverse.distance.weighted", False),
        decision_threshold=conf.get_float("decision.threshold", -1.0),
        positive_class=conf.get("positive.class.value"))
    pred, test_ids, test_classes = knn.classify_from_neighbors(
        make_records(), cfg, class_values, device=device)
    delim = conf.get("field.delim.out", ",")
    with open(out_path, "w") as fh:
        for i, tid in enumerate(test_ids):
            fh.write(delim.join(
                [tid, class_values[int(pred.predicted[i])]]) + "\n")
    if not validation:
        return
    if not test_classes or any(c is None for c in test_classes):
        if rec_width == 3 and not conf.get("test.class.path"):
            # a raw 3-field distance file never carries test classes, and
            # shared pipeline properties often leave validation.mode on
            print("validation.mode=true skipped: 3-field distance records "
                  "carry no test class (set test.class.path to join them)")
            return
        raise ValueError(
            "validation.mode=true but the neighbor records carry no "
            "test-class column; use the 5/6-field layouts with testClass "
            "or drop validation.mode")
    cm = ConfusionMatrix(class_values,
                         positive_class=conf.get("positive.class.value"))
    cm.update(np.asarray(pred.predicted),
              np.asarray([class_values.index(c) for c in test_classes]))
    print(cm.report().to_json())


def _run_knn_regression(conf: JobConfig, cfg, fz, train_rows, in_path: str,
                        out_path: str, validation: bool,
                        device: torch.device) -> None:
    """``prediction.mode=regression``: the class-attribute column holds the
    numeric target; ``regression.method`` average, median,
    linearRegression (its input variable at ``regr.input.field.ordinal``)
    or multiLinearRegression (``regr.input.field.ordinals``, default every
    numeric feature). A part-file dir is read merged. Output ``id,value``
    lines; ``validation.mode`` prints the mean absolute error."""
    from avenir_tpu_torch.models import knn
    test_rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    train = fz.transform(train_rows, with_labels=False)
    test = fz.transform(test_rows, with_labels=False,
                        device="cpu" if cfg.feed_chunk_rows > 0 else device)
    target_ord = fz.schema.find_class_attr_field().ordinal

    def column(rows, ords):
        return torch.tensor([[float(r[o]) for o in ords] for r in rows],
                            dtype=torch.float32, device=device)

    targets = column(train_rows, [target_ord])[:, 0]
    regr_input = None
    if cfg.regression_method == "linearRegression":
        x_ord = conf.get_int("regr.input.field.ordinal")
        if x_ord is None:
            raise ValueError("linearRegression needs "
                             "regr.input.field.ordinal")
        regr_input = (column(train_rows, [x_ord])[:, 0],
                      column(test_rows, [x_ord])[:, 0])
    elif cfg.regression_method == "multiLinearRegression":
        ords = conf.get_int_list("regr.input.field.ordinals")
        if ords is None:
            ords = [f.ordinal for f in fz.schema.get_feature_fields()
                    if not f.is_categorical]
        regr_input = (column(train_rows, ords), column(test_rows, ords))
    pred = knn.regress(train, test, cfg, targets, regr_input=regr_input)
    delim = conf.get("field.delim.out", ",")
    with open(out_path, "w") as fh:
        for i in range(test.n_rows):
            fh.write(delim.join(
                [test.ids[i], str(int(pred.predicted[i]))]) + "\n")
    if validation:
        truth = np.asarray([float(r[target_ord]) for r in test_rows])
        mae = float(np.abs(pred.predicted - truth).mean())
        print(f'{{"Validation.MeanAbsoluteError": {mae}}}')


def _check_knn_keys(conf: JobConfig) -> None:
    """NearestNeighbor's refusals (mesh.shape is read only with
    knn.sharded, which is refused)."""
    _check_keys(conf, _LATER_KNN)


def _write_knn_predictions(conf: JobConfig, out_path: str, train, test,
                           pred) -> None:
    """The ``id,class`` lines (with ``output.class.distr`` each class's
    score after)."""
    delim = conf.get("field.delim.out", ",")
    output_distr = conf.get_bool("output.class.distr", False)
    with open(out_path, "w") as fh:
        for i in range(test.n_rows):
            parts = [test.ids[i], train.class_values[int(pred.predicted[i])]]
            if output_distr and pred.class_prob is not None:
                for ci, cls in enumerate(train.class_values):
                    parts += [cls, str(int(pred.class_prob[i, ci]))]
            fh.write(delim.join(parts) + "\n")


def run_nearest_neighbor(conf: JobConfig, in_path: str, out_path: str,
                         device: torch.device) -> None:
    """KNN classification or regression (reference NearestNeighbor job,
    fused with the distance computation). ``in_path`` is the test data;
    ``train.data.path`` points at the training data. Both spellings of the
    class-weighting key are honored (``class.condition.weighted`` and the
    ``class.condtion.weighted`` typo of resource/knn.properties:34).
    ``prediction.mode=regression`` regresses (``regression.method``);
    ``neighbor.data.path`` classifies from precomputed neighbor records
    instead, and ``in_path`` is then ignored. Classification (one file or
    a part-file dir) runs as a plan (``cli/plans.py``) unless
    ``plan.enable=false``."""
    from avenir_tpu_torch.cli import plans as cli_plans
    from avenir_tpu_torch.models import knn
    _check_knn_keys(conf)
    if cli_plans.run_plan("NearestNeighbor", conf, in_path, out_path,
                          device):
        return
    validation = conf.get_bool("validation.mode", False)
    neighbor_path = conf.get("neighbor.data.path")
    if neighbor_path:
        _run_knn_replay(conf, neighbor_path, out_path, validation, device)
        return
    fz, train_rows = _load_table(conf, conf.get_required("train.data.path"),
                                 device)
    regression = conf.get("prediction.mode",
                          "classification") == "regression"
    cfg = cli_plans._knn_config(conf, fz)
    if regression:
        _run_knn_regression(conf, cfg, fz, train_rows, in_path, out_path,
                            validation, device)
        return
    train = fz.transform(train_rows)
    delim = conf.get("field.delim.out", ",")
    shard_paths = part_file_paths(in_path)
    if len(shard_paths) > 1 and conf.get_bool("shard.prefetch", True):
        _run_knn_sharded(conf, cfg, fz, train, shard_paths, out_path,
                         validation, delim, device)
        return
    test_rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    # with the chunked feed the test table stays on the host and streams
    # to the device chunk by chunk
    test_device = "cpu" if cfg.feed_chunk_rows > 0 else device
    test = fz.transform(test_rows, with_labels=validation,
                        device=test_device)

    feature_post = _knn_feature_post(train, cfg)
    pred = knn.classify(train, test, cfg, feature_post=feature_post)
    _write_knn_predictions(conf, out_path, train, test, pred)
    if validation and test.labels is not None:
        cm = knn.validate(pred, test,
                          positive_class=conf.get("positive.class.value"))
        print(cm.report().to_json())


def _check_mi_keys(conf: JobConfig) -> None:
    """MutualInformation's refusals outside the per-shard path."""
    _check_keys(conf, _LATER_MI)
    if "mesh.shape" in conf:
        _refuse("mesh.shape", _MULTI)


def run_mutual_information(conf: JobConfig, in_path: str, out_path: str,
                           device: torch.device) -> None:
    """All MI distribution families + feature-selection scores (reference
    MutualInformation job). Output: per-feature class MI lines, pair MI
    lines, then each selection algorithm's ranking (``mi.score.algorithms``
    names match the reference registry). Over a dir of more than one MR
    part file with ``shard.parts`` or ``job.resume`` (``--resume``) the
    counts fold shard by shard into a journal (``_run_mi_sharded``); else
    the job runs as a plan (``cli/plans.py``) unless
    ``plan.enable=false``."""
    from avenir_tpu_torch.cli import plans as cli_plans
    from avenir_tpu_torch.explore import mutual_information as mi
    if cli_plans.run_plan("MutualInformation", conf, in_path, out_path,
                          device):
        return
    shard_paths = part_file_paths(in_path)
    if len(shard_paths) > 1 and (conf.get_bool("shard.parts", False)
                                 or conf.get_bool("job.resume", False)):
        _run_mi_sharded(conf, in_path, out_path, shard_paths, device)
        return
    _check_mi_keys(conf)
    fz, rows = _load_table(conf, in_path, device)
    dists = mi.compute_distributions(fz.transform(rows))
    _emit_mi_scores(conf, out_path, mi.compute_scores(dists, device=device))


def _emit_mi_scores(conf: JobConfig, out_path: str, scores) -> None:
    """The MI output file: the score lines, then each selection
    algorithm's ranking."""
    from avenir_tpu_torch.explore import mutual_information as mi
    delim = conf.get("field.delim.out", ",")
    # the reference's key/value names (MutualInformation.java:452-455,
    # resource/hosp.properties) with this build's camelCase names as aliases
    # explicit None checks: an explicitly-empty value suppresses rankings,
    # only a truly absent key falls back
    algos = conf.get_list("mutual.info.score.algorithms")
    if algos is None:
        algos = conf.get_list("mi.score.algorithms")
    if algos is None:
        algos = ["mutual.info.maximization"]
    rf = conf.get_float("mutual.info.redundancy.factor",
                        conf.get_float("mi.redundancy.factor", 1.0))
    output_mi = conf.get_bool("output.mutual.info", True)
    with open(out_path, "w") as fh:
        if output_mi:
            for ordinal, value in sorted(scores.feature_class_mi.items()):
                fh.write(delim.join(["featureClass", str(ordinal),
                                     repr(value)]) + "\n")
            for (a, b), value in sorted(scores.feature_pair_mi.items()):
                fh.write(delim.join(["featurePair", str(a), str(b),
                                     repr(value)]) + "\n")
            for (a, b), value in sorted(
                    scores.feature_pair_class_mi.items()):
                fh.write(delim.join(["featurePairClass", str(a), str(b),
                                     repr(value)]) + "\n")
            for (a, b), value in sorted(scores.class_cond_pair_mi.items()):
                fh.write(delim.join(["classCondPair", str(a), str(b),
                                     repr(value)]) + "\n")
        for algo in algos:
            ranked = mi.SCORE_ALGORITHMS[algo](scores, redundancy_factor=rf)
            for rank, (ordinal, value) in enumerate(ranked):
                fh.write(delim.join([algo, str(rank), str(ordinal),
                                     repr(value)]) + "\n")


def run_correlation(conf: JobConfig, in_path: str, out_path: str,
                    device: torch.device,
                    default_stat: str = "cramerIndex") -> None:
    """Categorical correlation (reference CramerCorrelation /
    HeterogeneityReductionCorrelation). ``correlation.attr.pairs`` lists
    srcOrd:dstOrd pairs (default: every pair of categorical features);
    output ``src,dst,stat``."""
    from avenir_tpu_torch.explore import correlation as C
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    pair_spec = conf.get_list("correlation.attr.pairs")
    if pair_spec:
        pairs = [tuple(int(v) for v in p.split(":")) for p in pair_spec]
    else:
        ords = [f.ordinal for f in table.feature_fields if f.is_categorical]
        pairs = [(a, b) for i, a in enumerate(ords) for b in ords[i + 1:]]
    algo = conf.get("correlation.algorithm", default_stat)
    try:
        class_ordinal = fz.schema.find_class_attr_field().ordinal
    except ValueError:
        class_ordinal = None
    out = C.correlate_pairs(table, pairs, algo, class_ordinal=class_ordinal)
    delim = conf.get("field.delim.out", ",")
    with open(out_path, "w") as fh:
        for (a, b), value in out.items():
            fh.write(delim.join([str(a), str(b), repr(value)]) + "\n")


# -- the decision-tree verbs --------------------------------------------------

# TreePredictor routes on the device from this many rows on (below it, the
# host walk); device.predict overrides. Both give the same output.
_DEVICE_PREDICT_ROWS = 100_000
USED_ATTRS_SIDECAR = "_used.attributes"


def _tree_depth(node) -> int:
    return 0 if not node.children else 1 + max(
        _tree_depth(c) for c in node.children.values())


def run_tree_builder(conf: JobConfig, in_path: str, out_path: str,
                     device: torch.device) -> None:
    """Grow a complete decision tree in one job, written as the JSON model
    ``{"classValues": [...], "root": {classCounts, attr, splitKey,
    children}}`` that TreePredictor reads. ``best`` selection grows on the
    device (one readback a tree); past the device node budget it falls
    back to the per-level host loop, as the JAX CLI does; randomFromTop
    grows on the host loop (it draws from ``random.seed``)."""
    from avenir_tpu_torch.models import tree as T
    from avenir_tpu_torch.utils.atomicio import atomic_json_dump
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    strategy = conf.get("split.selection.strategy", "best")
    cfg = T.TreeConfig(
        split_attributes=tuple(conf.get_int_list("split.attributes") or ()),
        algorithm=_split_algorithm(conf),
        max_depth=conf.get_int("max.depth", 3),
        min_node_size=conf.get_int("min.node.size", 10),
        max_cat_attr_split_groups=conf.get_int(
            "max.cat.attr.split.groups", 3),
        split_selection_strategy=strategy,
        num_top_splits=conf.get_int("num.top.splits", 5),
        min_gain=conf.get_float("min.gain", 1e-6),
        device_node_budget=conf.get_int("device.node.budget", 2048))
    if strategy == "best":
        try:
            tree = T.grow_tree_device(table, cfg)
        except ValueError as exc:
            # only the frontier budget's error names the alternative
            if "use grow_tree" not in str(exc):
                raise
            print(f"TreeBuilder: device growth unavailable ({exc}); "
                  "using the per-level host loop", file=sys.stderr)
            tree = T.grow_tree(table, cfg)
    else:
        rng = np.random.default_rng(conf.get_int("random.seed", 0))
        tree = T.grow_tree(table, cfg, rng=rng)
    atomic_json_dump({"classValues": table.class_values,
                      "root": tree.to_dict()}, out_path)
    print(json.dumps({"Tree.Depth": _tree_depth(tree),
                      "Tree.Rows": table.n_rows}))


def _write_predictions(conf: JobConfig, out_path: str, table, pred,
                       class_values: List[str]) -> None:
    """``id,class`` lines, and the confusion-matrix report under
    ``validation.mode``."""
    from avenir_tpu_torch.utils.metrics import ConfusionMatrix
    delim = conf.get("field.delim.out", ",")
    with open(out_path, "w") as fh:
        for i in range(table.n_rows):
            fh.write(delim.join(
                [table.ids[i] if table.ids else str(i),
                 class_values[int(pred[i])]]) + "\n")
    if conf.get_bool("validation.mode", False) and table.labels is not None:
        cm = ConfusionMatrix(class_values,
                             positive_class=conf.get("positive.class.value"))
        cm.update(pred, table.labels)
        print(cm.report().to_json())


def run_tree_predictor(conf: JobConfig, in_path: str, out_path: str,
                       device: torch.device) -> None:
    """Classify rows down a TreeBuilder model (``tree.model.file.path``);
    ``validation.mode=true`` prints the confusion-matrix report."""
    from avenir_tpu_torch.models import tree as T
    validation = conf.get_bool("validation.mode", False)
    fz, rows = _load_table(conf, in_path, device, for_predict=True)
    table = fz.transform(rows, with_labels=validation)
    with open(conf.get_required("tree.model.file.path")) as fh:
        model = json.load(fh)
    tree = T.TreeNode.from_dict(model["root"], model["classValues"])
    on_device = conf.get_bool("device.predict",
                              table.n_rows >= _DEVICE_PREDICT_ROWS)
    pred = (T.predict_device if on_device else T.predict)(tree, table)
    _write_predictions(conf, out_path, table, pred, model["classValues"])


def _find_used_attributes(in_path: str) -> List[int]:
    """The attributes split on along the path into a node: the
    ``_used.attributes`` sidecar DataPartitioner leaves in each
    ``split=<i>`` directory, found by walking up ``data`` /
    ``segment=<j>`` / ``split=<i>`` components; the walk stops at the
    first other directory."""
    d = in_path if os.path.isdir(in_path) else os.path.dirname(in_path)
    d = os.path.abspath(d)
    while True:
        base = os.path.basename(d)
        if base.startswith("split="):
            cand = os.path.join(d, USED_ATTRS_SIDECAR)
            if os.path.isfile(cand):
                with open(cand) as fh:
                    text = fh.read().strip()
                return [int(t) for t in text.split(",")] if text else []
            return []
        if base != "data" and not base.startswith("segment="):
            return []
        parent = os.path.dirname(d)
        if parent == d:
            return []
        d = parent


def _select_split_attributes(conf: JobConfig, table,
                             in_path: str = "") -> List[int]:
    """``split.attribute.selection.strategy`` (ClassPartitionGenerator.java
    :141, :160-196): userSpecified (``split.attributes``, else every
    splittable one), all, random (``random.split.set.size`` distinct
    attributes drawn with ``np.random.default_rng(random.seed)``), and
    notUsedYet (those not in ``used.split.attributes``, else not on the
    path's ``_used.attributes`` sidecars)."""
    from avenir_tpu_torch.models.tree import splittable_ordinals
    splittable = splittable_ordinals(table)
    strategy = conf.get("split.attribute.selection.strategy", "userSpecified")
    if strategy == "userSpecified":
        attrs = conf.get_int_list("split.attributes")
        return attrs if attrs is not None else splittable
    if strategy == "all":
        return splittable
    if strategy == "random":
        size = min(conf.get_int("random.split.set.size", 3), len(splittable))
        rng = np.random.default_rng(conf.get_int("random.seed"))
        return sorted(int(o) for o in
                      rng.choice(splittable, size=size, replace=False))
    if strategy == "notUsedYet":
        used = conf.get_int_list("used.split.attributes")
        if used is None:
            used = _find_used_attributes(in_path) if in_path else []
        remaining = [a for a in splittable if a not in set(used)]
        if not remaining:
            raise ValueError(
                f"notUsedYet: every splittable attribute {splittable} is "
                f"already used on this path ({sorted(set(used))}); this "
                "node cannot split further")
        return remaining
    raise ValueError(
        f"invalid splitting attribute selection strategy {strategy!r}")


def _split_algorithm(conf: JobConfig) -> str:
    """``split.algorithm``, with ``hellinger.absent.class.value=reference``
    as the ``hellingerDistance:reference`` variant."""
    algorithm = conf.get("split.algorithm", "giniIndex")
    if (algorithm == "hellingerDistance" and
            conf.get("hellinger.absent.class.value") == "reference"):
        algorithm = "hellingerDistance:reference"
    return algorithm


def run_class_partition_generator(conf: JobConfig, in_path: str,
                                  out_path: str,
                                  device: torch.device) -> None:
    """Candidate-split gains (ClassPartitionGenerator): one
    ``attr;splitKey;gainRatio`` line per candidate split, or with
    ``at.root=true`` only the node's information."""
    from avenir_tpu_torch.models import tree as T
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    algorithm = _split_algorithm(conf)
    delim = conf.get("field.delim.out", ";")
    if conf.get_bool("at.root", False):
        with open(out_path, "w") as fh:
            fh.write(repr(T.root_info(table, algorithm)) + "\n")
        return
    attrs = _select_split_attributes(conf, table, in_path=in_path)
    parent = conf.get_float("parent.info")
    max_groups = conf.get_int("max.cat.attr.split.groups", 3)
    class_probs = None
    # the class-prob suffix only for entropy/giniIndex
    # (ClassPartitionGenerator.java:531-545)
    if (conf.get_bool("output.split.prob", False)
            and algorithm in ("entropy", "giniIndex")):
        splits, class_probs = T.split_gains_with_class_probs(
            table, attrs, algorithm, parent, max_groups)
    else:
        splits = T.split_gains(table, attrs, algorithm, parent, max_groups)
    T.write_candidate_splits(splits, out_path, delim,
                             class_probs=class_probs)


def _read_raw_lines(path: str) -> List[str]:
    """The raw non-empty lines of a file or part-file dir: exactly the rows
    ``read_csv_lines`` parses, in its order."""
    lines: List[str] = []
    for full in part_file_paths(path):
        with open(full) as fh:
            lines.extend(line.rstrip("\n") for line in fh
                         if line.rstrip("\n"))
    return lines


def run_split_generator(conf: JobConfig, in_path: str, out_path: str,
                        device: torch.device) -> None:
    """ClassPartitionGenerator with SplitGenerator's paths
    (SplitGenerator.java:39-54): with ``project.base.path`` the input is
    ``<base>/split=root/data[/<split.path>]`` and the output its sibling
    ``splits/part-r-00000``."""
    base = conf.get("project.base.path")
    if base:
        split_path = conf.get("split.path")
        in_path = os.path.join(base, "split=root", "data")
        if split_path:
            in_path = os.path.join(in_path, split_path)
        out_dir = os.path.join(os.path.dirname(in_path), "splits")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "part-r-00000")
    run_class_partition_generator(conf, in_path, out_path, device)


def _write_partition(seg_dir: str, raw_lines: List[str], rows) -> None:
    os.makedirs(seg_dir, exist_ok=True)
    with open(os.path.join(seg_dir, "partition.txt"), "w") as fh:
        for i in rows:
            fh.write(raw_lines[i] + "\n")


def _write_used(split_dir: str, used: List[int]) -> None:
    with open(os.path.join(split_dir, USED_ATTRS_SIDECAR), "w") as fh:
        fh.write(",".join(str(a) for a in used) + "\n")


def _run_data_partitioner_batched(conf: JobConfig, in_path: str,
                                  out_path: str, table, raw_lines,
                                  levels: int) -> None:
    """``levels`` SplitGenerator→DataPartitioner rounds in one invocation
    and one device pass (``grow_levels_batched``), writing every node's
    ``splits/part-r-00000`` (unless one exists), its
    ``split=<i>/segment=<j>/data/partition.txt`` and the
    ``_used.attributes`` sidecars, as the sequential rounds would. Needs a
    path-independent attribute selection (all, userSpecified) and ``best``
    selection; descent stops at pure or singleton children."""
    from avenir_tpu_torch.models import tree as T
    strategy = conf.get("split.attribute.selection.strategy", "all")
    if strategy not in ("all", "userSpecified"):
        raise ValueError(
            f"tree.levels.per.invocation={levels} requires a "
            "path-independent attribute selection strategy ('all' or "
            f"'userSpecified'), got {strategy!r} — run per-level instead")
    if conf.get("split.selection.strategy", "best") != "best":
        raise ValueError(
            "tree.levels.per.invocation requires "
            "split.selection.strategy=best (device selection is argmax)")
    algorithm = _split_algorithm(conf)
    delim = conf.get("field.delim.out", ";")
    attrs = _select_split_attributes(conf, table, in_path=in_path)
    records, keys = T.grow_levels_batched(
        table, attrs, algorithm, levels,
        max_cat_attr_split_groups=conf.get_int(
            "max.cat.attr.split.groups", 3),
        min_node_size=conf.get_int("tree.batch.min.node.rows", 2),
        node_budget=conf.get_int("tree.device.node.budget", 2048))

    data_dir = (in_path if os.path.isdir(in_path)
                else os.path.dirname(in_path))
    root_splits = conf.get("candidate.splits.path") or os.path.join(
        os.path.dirname(data_dir), "splits", "part-r-00000")
    seg_cache: dict = {}
    # slot -> (node dir, its rows, attributes used above it, splits file)
    nodes = {0: (out_path, np.arange(table.n_rows),
                 _find_used_attributes(in_path), root_splits)}
    n_nodes_written = 0
    for level, rec in enumerate(records):
        ratio = rec["ratio"]
        next_nodes: dict = {}
        for slot, (node_dir, row_idx, used, splits_path) in nodes.items():
            cands = [T.CandidateSplit(a, k, float(ratio[t, slot]),
                                      float(ratio[t, slot]),
                                      float(ratio[t, slot]))
                     for t, (a, k, _s) in enumerate(keys)]
            splits_dir = os.path.dirname(splits_path)
            if splits_dir:
                os.makedirs(splits_dir, exist_ok=True)
            if not os.path.exists(splits_path):
                T.write_candidate_splits(cands, splits_path, delim)
            n_nodes_written += 1
            # the root is partitioned whatever its gain, as a sequential
            # DataPartitioner would; children stop at pure or singleton
            if not bool(rec["split"][slot]) and level > 0:
                continue
            t_best = int(rec["best_t"][slot])
            attr, key, _n_seg = keys[t_best]
            if t_best not in seg_cache:
                seg_cache[t_best] = T.segment_of_rows(table, attr, key)
            segs = seg_cache[t_best][row_idx]
            split_dir = os.path.join(node_dir, f"split={t_best}")
            for seg in sorted(set(int(s) for s in segs)):
                _write_partition(
                    os.path.join(split_dir, f"segment={seg}", "data"),
                    raw_lines, row_idx[segs == seg])
            new_used = used if attr in used else used + [attr]
            _write_used(split_dir, new_used)
            if level + 1 < len(records):
                for seg in range(rec["child_slot"].shape[1]):
                    child = int(rec["child_slot"][slot, seg])
                    if child < 0:
                        continue
                    child_dir = os.path.join(split_dir, f"segment={seg}")
                    next_nodes[child] = (
                        child_dir, row_idx[segs == seg], new_used,
                        os.path.join(child_dir, "splits", "part-r-00000"))
        nodes = next_nodes
        if not nodes:
            break
    print(f'{{"tree.levels": {len(records)}, '
          f'"tree.nodes.visited": {n_nodes_written}}}')


def run_data_partitioner(conf: JobConfig, in_path: str, out_path: str,
                         device: torch.device) -> None:
    """Partition a node's data by its best candidate split
    (tree.DataPartitioner): reads the sibling ``splits/part-r-00000`` (or
    ``candidate.splits.path``), sorts by stat descending, and writes each
    segment's rows, verbatim, to
    ``<out>/split=<rank>/segment=<j>/data/partition.txt``
    (DataPartitioner.java:59-129), with the ``_used.attributes`` sidecar
    in ``split=<rank>``. ``tree.levels.per.invocation=L`` (> 1) runs L
    rounds at once (:func:`_run_data_partitioner_batched`)."""
    from avenir_tpu_torch.models import tree as T
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    levels = conf.get_int("tree.levels.per.invocation", 1)
    if levels > 1:
        _run_data_partitioner_batched(conf, in_path, out_path, table,
                                      _read_raw_lines(in_path), levels)
        return
    delim = conf.get("field.delim.out", ";")
    data_dir = in_path if os.path.isdir(in_path) else os.path.dirname(in_path)
    splits_path = conf.get("candidate.splits.path") or os.path.join(
        os.path.dirname(data_dir), "splits", "part-r-00000")
    candidates = T.read_candidate_splits(splits_path, delim)
    split_index, (attr, key, _stat) = T.select_split(
        candidates, conf.get("split.selection.strategy", "best"),
        conf.get_int("num.top.splits", 5))
    segs = T.segment_of_rows(table, attr, key)
    raw_lines = _read_raw_lines(in_path)
    split_dir = os.path.join(out_path, f"split={split_index}")
    for seg in sorted(set(int(s) for s in segs)):
        _write_partition(os.path.join(split_dir, f"segment={seg}", "data"),
                         raw_lines, np.nonzero(segs == seg)[0])
    used = _find_used_attributes(in_path)
    _write_used(split_dir, used if attr in used else used + [attr])
    print(f'{{"split.attribute": {attr}, "split.key": "{key}", '
          f'"split.index": {split_index}}}')



# -- the forest verbs ---------------------------------------------------------

def _forest_config(conf: JobConfig):
    """The ForestConfig of ``num.trees``, ``random.split.set.size``,
    ``bagging``, ``random.seed``, ``forest.growth`` and the TreeBuilder
    keys."""
    from avenir_tpu_torch.models import forest as F
    from avenir_tpu_torch.models.tree import TreeConfig
    return F.ForestConfig(
        n_trees=conf.get_int("num.trees", 10),
        attrs_per_tree=conf.get_int("random.split.set.size", 3),
        bagging=conf.get_bool("bagging", True),
        seed=conf.get_int("random.seed", 0),
        growth=conf.get("forest.growth", "auto"),
        tree=TreeConfig(
            algorithm=_split_algorithm(conf),
            max_depth=conf.get_int("max.depth", 3),
            min_node_size=conf.get_int("min.node.size", 10),
            max_cat_attr_split_groups=conf.get_int(
                "max.cat.attr.split.groups", 3),
            split_selection_strategy=conf.get(
                "split.selection.strategy", "best"),
            num_top_splits=conf.get_int("num.top.splits", 5),
            min_gain=conf.get_float("min.gain", 1e-6),
            device_node_budget=conf.get_int("device.node.budget", 2048)))


def _write_forest(out_path: str, trees, table) -> None:
    """The stacked tree JSON and the job's stdout line."""
    from avenir_tpu_torch.models import forest as F
    F.save_forest(trees, out_path)
    print(json.dumps({"Forest.Trees": len(trees),
                      "Forest.Rows": table.n_rows}))


def run_forest_builder(conf: JobConfig, in_path: str, out_path: str,
                       device: torch.device) -> None:
    """Grow a random forest: ``num.trees`` trees, each on
    ``random.split.set.size`` random attributes and (with ``bagging``) a
    bootstrap of the rows, under ``random.seed``, ``forest.growth``
    (auto|batched|serial) and the TreeBuilder keys. The artifact stacks
    TreeBuilder's JSON tree format, written rename-atomically. Runs as a
    plan (``cli/plans.py``) unless ``plan.enable=false``."""
    from avenir_tpu_torch.cli import plans as cli_plans
    from avenir_tpu_torch.models import forest as F
    if cli_plans.run_plan("RandomForestBuilder", conf, in_path, out_path,
                          device):
        return
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    _write_forest(out_path, F.grow_forest(table, _forest_config(conf)),
                  table)


def run_forest_predictor(conf: JobConfig, in_path: str, out_path: str,
                         device: torch.device) -> None:
    """Majority-vote classification down a RandomForestBuilder model
    (``forest.model.file.path``): the host walk, or from
    ``_DEVICE_PREDICT_ROWS`` rows on (``device.predict`` overrides) every
    tree routed and voted on the device; both give the same output."""
    from avenir_tpu_torch.models import forest as F
    validation = conf.get_bool("validation.mode", False)
    fz, rows = _load_table(conf, in_path, device, for_predict=True)
    table = fz.transform(rows, with_labels=validation)
    trees = F.load_forest(conf.get_required("forest.model.file.path"))
    on_device = conf.get_bool("device.predict",
                              table.n_rows >= _DEVICE_PREDICT_ROWS)
    pred = F.predict_forest(trees, table, device=on_device)
    _write_predictions(conf, out_path, table, pred, trees[0].class_values)


# -- the boosting verbs ------------------------------------------------------

def _boost_config(conf: JobConfig):
    """The ``forest.boost.*`` keys on top of the TreeBuilder split keys;
    every invalid value raises from ``BoostConfig``'s validation, naming
    the key."""
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.models.tree import TreeConfig
    return B.BoostConfig(
        n_rounds=conf.get_int("forest.boost.num.rounds", 10),
        learning_rate=conf.get_float("forest.boost.learning.rate", 0.3),
        base_score=conf.get_float("forest.boost.base.score", 0.0),
        reg_lambda=conf.get_float("forest.boost.reg.lambda", 1.0),
        early_stop_rounds=conf.get_int("forest.boost.early.stop.rounds", 0),
        holdout_fraction=conf.get_float(
            "forest.boost.early.stop.holdout", 0.2),
        tree=TreeConfig(
            algorithm=_split_algorithm(conf),
            max_depth=conf.get_int("max.depth", 3),
            min_node_size=conf.get_int("min.node.size", 10),
            max_cat_attr_split_groups=conf.get_int(
                "max.cat.attr.split.groups", 3),
            min_gain=conf.get_float("min.gain", 1e-6),
            device_node_budget=conf.get_int("device.node.budget", 2048)))


def run_boost_builder(conf: JobConfig, in_path: str, out_path: str,
                      device: torch.device) -> None:
    """Train a gradient-boosted forest: ``forest.boost.num.rounds`` Newton
    rounds over one binned catalog (``forest.boost.learning.rate``,
    ``.base.score``, ``.reg.lambda``, ``.early.stop.rounds``,
    ``.early.stop.holdout`` and the TreeBuilder split keys), written as
    the ``kind: "boosted"`` artifact. ``streaming.train=true`` boosts out
    of core over a part-file dir (the same model; the schema fully
    specified or ``featurizer.fit.data.path`` set). The in-core mode runs
    as a plan (``cli/plans.py``) unless ``plan.enable=false``."""
    from avenir_tpu_torch.cli import plans as cli_plans
    from avenir_tpu_torch.models import boost as B
    if cli_plans.run_plan("GradientBoostBuilder", conf, in_path, out_path,
                          device):
        return
    cfg = _boost_config(conf)
    if conf.get_bool("streaming.train", False):
        schema = FeatureSchema.from_file(
            conf.get_required("feature.schema.file.path"))
        fz = Featurizer(schema,
                        unseen=conf.get("unseen.value.handling", "error"),
                        device=device)
        if fz.schema_data_dependent:
            fit_path = conf.get("featurizer.fit.data.path")
            if fit_path is None:
                raise ValueError(
                    "streaming.train needs a fully-specified schema "
                    "(cardinalities + min/max) or featurizer.fit.data.path "
                    "pointing at a bounded sample — fitting vocabularies "
                    "from the stream would materialize it")
            fz.fit(read_csv_lines(fit_path,
                                  conf.get("field.delim.regex", ",")))
        else:
            fz.fit([])
        model = B.grow_boosted_streaming(
            fz, part_file_paths(in_path), cfg,
            delim_regex=conf.get("field.delim.regex", ","))
    else:
        fz, rows = _load_table(conf, in_path, device)
        model = B.grow_boosted(fz.transform(rows), cfg)
    _write_boosted(out_path, model)


def _write_boosted(out_path: str, model) -> None:
    """The boosted artifact and the job's stdout line."""
    from avenir_tpu_torch.models import boost as B
    B.save_boosted(model, out_path)
    print(json.dumps({"Boost.Rounds": len(model.trees),
                      "Boost.LearningRate": model.learning_rate}))


def run_boost_predictor(conf: JobConfig, in_path: str, out_path: str,
                        device: torch.device) -> None:
    """Classify rows down a GradientBoostBuilder model
    (``forest.boost.model.file.path``): base score plus the summed leaf
    values, class 1 on a positive margin. The host walk, or from
    ``_DEVICE_PREDICT_ROWS`` rows on (``device.predict`` overrides) every
    tree routed on the device; a bagged artifact is refused by kind."""
    from avenir_tpu_torch.models import boost as B
    validation = conf.get_bool("validation.mode", False)
    fz, rows = _load_table(conf, in_path, device, for_predict=True)
    table = fz.transform(rows, with_labels=validation)
    model = B.load_boosted(
        conf.get_required("forest.boost.model.file.path"))
    on_device = conf.get_bool("device.predict",
                              table.n_rows >= _DEVICE_PREDICT_ROWS)
    pred = model.predict(table, device=on_device)
    _write_predictions(conf, out_path, table, pred, model.class_values)


# -- the batch bandit verbs ---------------------------------------------------

def _run_batch_bandit(algorithm: str, conf: JobConfig, in_path: str,
                      out_path: str, device: torch.device) -> None:
    """The four MR batch bandits: sorted ``group,item,count,reward`` rows
    in, ``group,item`` selections of the next round out
    (``models/bandits/batch.py``, numpy on the host: the job launches
    nothing on ``device``, as the JAX CLI launches nothing).
    ``group.item.count.path`` gives per-group batch sizes."""
    from avenir_tpu_torch.models import bandits as B
    delim = conf.get("field.delim.regex", ",")
    rows = read_csv_lines(in_path, delim)
    count_ord = conf.get_int("count.ordinal", 2)
    reward_ord = conf.get_int("reward.ordinal", 3)
    groups: Dict[str, list] = {}
    for r in rows:
        groups.setdefault(r[0], []).append(r)
    group_items = {g: B.GroupItems.from_rows(rs, count_ord, reward_ord)
                   for g, rs in groups.items()}
    batch_sizes = None
    bc_path = conf.get("group.item.count.path")
    if bc_path:
        batch_sizes = {r[0]: int(r[1]) for r in read_csv_lines(bc_path, ",")}
    cfg = B.BanditConfig(
        round_num=conf.get_int("current.round.num", 1),
        batch_size=conf.get_int("batch.size", 1),
        random_selection_prob=conf.get_float("random.selection.prob", 0.5),
        prob_reduction_constant=conf.get_float("prob.reduction.constant",
                                               1.0),
        prob_reduction_algorithm=conf.get("prob.reduction.algorithm",
                                          "linear"),
        auer_greedy_constant=conf.get_int("auer.greedy.constant", 5),
        temp_constant=conf.get_float("temp.constant", 0.1),
        exploration_count_factor=conf.get_int("exploration.count.factor", 2),
        exploration_count_strategy=conf.get("exploration.count.strategy",
                                            "simple"),
        reward_diff=conf.get_float("reward.diff", 0.1),
        prob_diff=conf.get_float("prob.diff", 0.1))
    selections = B.select_all_groups(algorithm, group_items, cfg,
                                     batch_sizes,
                                     seed=conf.get_int("random.seed", 0))
    delim_out = conf.get("field.delim", ",")
    with open(out_path, "w") as fh:
        for gid, item in selections:
            fh.write(delim_out.join([gid, item]) + "\n")


def run_markov_state_transition_model(conf: JobConfig, in_path: str,
                                      out_path: str,
                                      device: torch.device) -> None:
    """Train a (optionally class-conditional) Markov transition model
    (reference MarkovStateTransitionModel), its counts through K4. Input
    rows: ``id[,classLabel],state,state,...`` — controlled by
    ``skip.field.count`` and ``class.label.field.ord`` like the reference
    mapper (:99-133); ``streaming.train=true`` streams the file in chunks
    of ``stream.chunk.rows`` rows (the same model)."""
    from avenir_tpu_torch.models import markov as M
    delim = conf.get("field.delim.regex", ",")
    skip = conf.get_int("skip.field.count", 0)
    class_ord = conf.get_int("class.label.field.ord", -1)
    states = conf.get_list("model.states")
    if states is None:
        raise ValueError("model.states must list the state symbols")
    if conf.get_bool("streaming.train", False):
        model = M.train_streamed(
            in_path, states, delim, skip_fields=skip,
            class_label_ord=class_ord,
            label_values=conf.get_list("class.labels"),
            scale=conf.get_int("trans.prob.scale", 1000),
            chunk_rows=conf.get_int("stream.chunk.rows", 65536),
            device=device)
    else:
        rows = read_csv_lines(in_path, delim)
        eff_skip = skip + (1 if class_ord >= 0 else 0)
        seqs = [r[eff_skip:] for r in rows]
        labels = [r[class_ord] for r in rows] if class_ord >= 0 else None
        model = M.train(seqs, states, class_labels=labels,
                        scale=conf.get_int("trans.prob.scale", 1000),
                        device=device)
    M.save_model(model, out_path,
                 output_states=conf.get_bool("output.states", True),
                 delim=conf.get("field.delim.out", ","))


def run_markov_model_classifier(conf: JobConfig, in_path: str,
                                out_path: str, device: torch.device) -> None:
    """Classify sequences by class-conditional log odds
    (reference MarkovModelClassifier.java:121-144)."""
    from avenir_tpu_torch.models import markov as M
    delim = conf.get("field.delim.regex", ",")
    delim_out = conf.get("field.delim.out", ",")
    skip = conf.get_int("skip.field.count", 1)
    id_ord = conf.get_int("id.field.ord", 0)
    validation = conf.get_bool("validation.mode", False)
    class_ord = conf.get_int("class.label.field.ord", -1)
    if validation and class_ord < 0:
        raise ValueError("in validation mode actual class labels must be "
                         "provided (class.label.field.ord)")
    labels = conf.get_list("class.labels")
    model = M.load_model(conf.get_required("mm.model.path"),
                         class_label_based=True,
                         scale=conf.get_int("trans.prob.scale", 1000))
    rows = read_csv_lines(in_path, delim)
    eff_skip = skip + (1 if validation else 0)
    seqs = [r[eff_skip:] for r in rows]
    pred, odds = M.classify(model, seqs, (labels[0], labels[1]),
                            device=device)
    with open(out_path, "w") as fh:
        for i, row in enumerate(rows):
            parts = [row[id_ord]]
            if validation:
                parts.append(row[class_ord])
            parts += [str(pred[i]), str(float(odds[i]))]
            fh.write(delim_out.join(parts) + "\n")
    if validation:
        truth = [r[class_ord] for r in rows]
        cm = M.validate(pred, truth, labels, positive_class=labels[0])
        print(cm.report().to_json())


def run_hmm_builder(conf: JobConfig, in_path: str, out_path: str,
                    device: torch.device) -> None:
    """Build an HMM from tagged data (reference HiddenMarkovModelBuilder),
    on the host — or, with ``training.mode=untagged``, from raw observation
    sequences by Baum-Welch EM on the device (``num.states`` hidden
    states, ``num.iterations`` EM steps, ``convergence.threshold``,
    ``prob.smoothing``, ``random.seed``; ``checkpoint.file.path`` with
    ``iteration.chunk.size`` makes it resumable), printing the
    ``BaumWelch.*`` JSON line."""
    from avenir_tpu_torch.models import hmm as H
    delim = conf.get("field.delim.regex", ",")
    rows = read_csv_lines(in_path, delim)
    # the reference builder scales with trans.prob.scale, default 1000
    # (HiddenMarkovModelBuilder.java:293)
    scale = conf.get_int("trans.prob.scale", 1000)
    if conf.get("training.mode", "tagged") == "untagged":
        # empty tokens of trailing delimiters are not observations, and a
        # row the filter empties is not a trainable sequence
        rows = [row for row in ([t for t in r if t] for r in rows) if row]
        if not rows:
            raise ValueError(f"no non-empty observation rows in {in_path}")
        observations = conf.get_list("model.observations")
        if observations is None:
            observations = sorted({t for r in rows for t in r})
        n_states = conf.get_int("num.states")
        if n_states is None:
            raise ValueError("training.mode=untagged needs num.states")
        tol = conf.get_float("convergence.threshold", 1e-6)
        model, ll = H.train_baum_welch(
            rows, observations, n_states,
            n_iters=conf.get_int("num.iterations", 50),
            seed=conf.get_int("random.seed", 0), scale=scale,
            state_names=conf.get_list("model.states"),
            smoothing=conf.get_float("prob.smoothing", 1e-4),
            ll_rel_tol=tol,
            chunk_size=conf.get_int("iteration.chunk.size", 10),
            checkpoint_path=conf.get("checkpoint.file.path"),
            device=device)
        H.save_model(model, out_path, delim=conf.get("field.delim.out", ","))
        converged = H.ll_converged(ll.tolist(), tol)
        print(f'{{"BaumWelch.LogLikelihood": {float(ll[-1])}, '
              f'"BaumWelch.Iterations": {len(ll)}, '
              f'"BaumWelch.Converged": {str(converged).lower()}}}')
        return
    states = conf.get_list("model.states")
    observations = conf.get_list("model.observations")
    if states is None or observations is None:
        raise ValueError("model.states and model.observations are required")
    if conf.get_bool("partially.tagged", False):
        wf = conf.get_int_list("window.function", [1])
        model = H.train_partially_tagged(rows, states, observations, wf,
                                         scale=scale)
    else:
        model = H.train_fully_tagged(
            rows, states, observations,
            sub_field_delim=conf.get("sub.field.delim", ":"),
            scale=scale,
            skip_field_count=conf.get_int("skip.field.count", 0))
    H.save_model(model, out_path, delim=conf.get("field.delim.out", ","))


def run_viterbi_state_predictor(conf: JobConfig, in_path: str,
                                out_path: str, device: torch.device) -> None:
    """Most-likely state path per row (reference ViterbiStatePredictor);
    emits the reversed path like the reference (:136-140). The model file's
    scale is irrelevant to the arg-max, so both float and scaled-int model
    files decode alike."""
    from avenir_tpu_torch.models import hmm as H
    delim = conf.get("field.delim.regex", ",")
    delim_out = conf.get("field.delim.out", ",")
    skip = conf.get_int("skip.field.count", 1)
    id_ord = conf.get_int("id.field.ordinal", 0)
    model = H.load_model(conf.get_required("hmm.model.path"), scale=1)
    rows = read_csv_lines(in_path, delim)
    obs_rows = [r[skip:] for r in rows]
    paths = H.predict_states(model, obs_rows, reversed_output=True,
                             device=device)
    with open(out_path, "w") as fh:
        for row, path in zip(rows, paths):
            fh.write(delim_out.join([row[id_ord]] + path) + "\n")

def run_word_counter(conf: JobConfig, in_path: str, out_path: str,
                     device: torch.device) -> None:
    """Lucene-style word count (reference text.WordCounter MR): honors
    ``text.field.ordinal`` (< 0 means the whole line) and
    ``field.delim.out`` for the sorted ``token,count`` lines."""
    from avenir_tpu_torch.text.word_count import word_count_lines
    rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    lines = word_count_lines(
        rows, text_field_ordinal=conf.get_int("text.field.ordinal", -1),
        delim_out=conf.get("field.delim.out", ","), device=device)
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))


def run_under_sampling(conf: JobConfig, in_path: str, out_path: str,
                       device: torch.device) -> None:
    """Majority-class undersampling (reference UnderSamplingBalancer):
    exact class counts, or with ``streaming.bootstrap=true`` the
    reference's running counts (``distr.batch.size``); the keep draw is
    JAX's threefry stream from ``random.seed``, so the JAX CLI keeps the
    same lines."""
    import re
    from avenir_tpu_torch.explore.sampling import (under_sample,
                                                   under_sample_streaming)
    from avenir_tpu_torch.utils.jrandom import prng_key
    class_ord = conf.get_int("class.attr.ord")
    if class_ord is None:
        raise ValueError("class.attr.ord is required")
    # one read: the raw lines and the labels stay index-aligned
    splitter = re.compile(conf.get("field.delim.regex", ","))
    with open(in_path) as fh:
        raw = [l.rstrip("\n") for l in fh if l.rstrip("\n")]
    tokens = [splitter.split(l)[class_ord].strip() for l in raw]
    values = sorted(set(tokens))
    index = {v: i for i, v in enumerate(values)}
    labels = torch.tensor([index[t] for t in tokens], dtype=torch.int32,
                          device=device)
    key = prng_key(conf.get_int("random.seed", 0), device)
    if conf.get_bool("streaming.bootstrap", False):
        keep = under_sample_streaming(
            labels, key, len(values), conf.get_int("distr.batch.size", 10000))
    else:
        keep = under_sample(labels, key, len(values))
    keep = keep.cpu().numpy()
    with open(out_path, "w") as fh:
        for line, k in zip(raw, keep):
            if k:
                fh.write(line + "\n")


def run_bagging(conf: JobConfig, in_path: str, out_path: str,
                device: torch.device) -> None:
    """Per-window bootstrap sampling (reference BaggingSampler): the
    indices are JAX's threefry draws from ``random.seed``."""
    from avenir_tpu_torch.explore.sampling import bagging_sample
    from avenir_tpu_torch.utils.jrandom import prng_key
    with open(in_path) as fh:
        raw = [l.rstrip("\n") for l in fh if l.strip()]
    idx = bagging_sample(len(raw), prng_key(conf.get_int("random.seed", 0),
                                            device),
                         batch_size=conf.get_int("batch.size", 10000))
    with open(out_path, "w") as fh:
        for i in idx.cpu().numpy():
            fh.write(raw[i] + "\n")


def run_logistic_regression(conf: JobConfig, in_path: str, out_path: str,
                            device: torch.device) -> None:
    """Iterative logistic regression with the append-only coefficient
    history file ``coeff.file.path`` (reference LogisticRegressionJob;
    the gradient step corrected per SURVEY.md §2.7)."""
    from avenir_tpu_torch.models import logistic
    rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    feat_ords = conf.get_int_list("feature.field.ordinals")
    class_ord = conf.get_int("class.attr.ord")
    pos_class = conf.get_required("positive.class.value")
    if feat_ords is None or class_ord is None:
        raise ValueError("feature.field.ordinals and class.attr.ord required")
    x = np.asarray([[float(r[o]) for o in feat_ords] for r in rows],
                   np.float32)
    y = np.asarray([1.0 if r[class_ord] == pos_class else 0.0 for r in rows],
                   np.float32)
    cfg = logistic.LogisticConfig(
        learning_rate=conf.get_float("learning.rate", 0.5),
        max_iterations=conf.get_int("iteration.limit", 100),
        convergence_threshold=conf.get_float("convergence.threshold", 1.0),
        convergence_criteria=conf.get("convergence.criteria", "average"))
    w, iters, conv = logistic.train(
        torch.from_numpy(x).to(device), torch.from_numpy(y).to(device), cfg,
        coeff_file_path=conf.get("coeff.file.path"))
    with open(out_path, "w") as fh:
        fh.write(",".join(repr(float(v)) for v in w) + "\n")
    print(f'{{"iterations": {iters}, "converged": {str(conv).lower()}}}')


def run_fisher_discriminant(conf: JobConfig, in_path: str, out_path: str,
                            device: torch.device) -> None:
    """Univariate Fisher LDA per attribute (reference FisherDiscriminant)."""
    from avenir_tpu_torch.models import fisher
    fz, rows = _load_table(conf, in_path, device)
    model = fisher.train(fz.transform(rows))
    with open(out_path, "w") as fh:
        fh.write("\n".join(fisher.serialize(
            model, conf.get("field.delim.out", ","))) + "\n")


def run_projection(conf: JobConfig, in_path: str, out_path: str,
                   device: torch.device) -> None:
    """Grouping/ordering projection (chombo ``org.chombo.mr.Projection``,
    the email-marketing tutorial's stage that orders each customer's
    transactions by time): ``projection.operation`` (groupingOrdering),
    ``key.field``, ``orderBy.field``, ``projection.field``,
    ``format.compact``, ``orderBy.numeric``. A host pass (native C++ for
    one file); ``device`` is not used."""
    from avenir_tpu_torch.utils.projection import project_file
    op = conf.get("projection.operation", "groupingOrdering")
    if op != "groupingOrdering":
        raise ValueError(f"unsupported projection.operation: {op}")
    project_file(
        in_path, out_path,
        key_field=conf.get_int("key.field", 0),
        order_by_field=conf.get_int("orderBy.field", 1),
        projection_fields=conf.get_int_list("projection.field", [1]),
        compact=conf.get_bool("format.compact", True),
        numeric_order=(conf.get_bool("orderBy.numeric")
                       if conf.get("orderBy.numeric") is not None else None),
        delim_regex=conf.get("field.delim.regex", ","),
        delim_out=conf.get("field.delim.out", ","))


def run_reinforcement_learner(conf: JobConfig, in_path: str, out_path: str,
                              device: torch.device) -> None:
    """Online RL loop (reference ReinforcementLearnerTopology): events in
    from ``in_path`` (one event id per line, ``id|enqueue_ts`` with
    ``event.timestamps``), actions out to ``out_path`` as
    ``eventID,action[,action...]``; rewards drained from
    ``reward.data.path`` lines ``action,reward`` before each batch, like
    the bolt (ReinforcementLearnerBolt.java:93-125). The learner's state
    lives on ``device``. ``checkpoint.dir`` / ``checkpoint.interval``
    checkpoint it, and a rerun over the same directory resumes: the event
    lines already served are skipped, and the rewards already folded.

    ``serving.engine=true`` runs the pipelined ``ServingEngine``
    (``stream/engine.py``): the loop's actions file, byte for byte, on
    these queues filled before the run, at the default
    ``engine.max.batch`` (a smaller cap chunks the draws otherwise:
    another stream of the same distribution). Its keys:
    ``engine.min.batch`` / ``engine.max.batch`` (the adaptive batch's
    bounds), ``engine.reward.drain.max`` (the reward sweep's bound), and
    the admission gate, ``engine.admission.high`` / ``.low``,
    ``engine.shed.policy`` (``reject-new`` | ``drop-oldest``),
    ``engine.shed.chunk``: past the high mark events are retired
    unserved, counted in the JSON line's ``shed_total`` (admitted + shed
    = produced), until the depth falls to the low mark. The engine keeps
    no checkpoints; ``lifecycle.dir`` names a snapshot registry
    (``lifecycle/registry.py``) whose head it restores before serving and
    to which it publishes the state after (``lifecycle.max.keep``
    prunes).

    ``broker.shards=host:port,...`` serves the job over a broker fleet
    (``stream/fleet.py``; the engine only): the job's group
    (``broker.group``, default ``g0``) hashes to one shard, whose queues
    carry the events, actions and rewards with the pending ledger
    armed; the JSON line gains ``broker_shard``. The config errors are
    the JAX CLI's, with its messages."""
    from avenir_tpu_torch.stream.loop import InProcQueues, OnlineLearnerLoop
    learner_type = conf.get_required("learner.type")
    actions = conf.get_list("action.list")
    if not actions:
        raise ValueError("action.list must name the candidate actions")
    use_engine = conf.get_bool("serving.engine", False)
    if use_engine and conf.get("checkpoint.dir"):
        raise ValueError(
            "serving.engine=true does not use checkpoint.dir (in-run "
            "durability is the broker ledger's job); point the engine at "
            "the snapshot registry instead — set lifecycle.dir to restore "
            "the registry head on start and publish the post-run learner "
            "state as a new version (lifecycle/registry.py)")
    lifecycle_dir = conf.get("lifecycle.dir")
    if lifecycle_dir and not use_engine:
        raise ValueError(
            "lifecycle.dir is the engine's durability anchor; the loop "
            "path keeps checkpoint.dir (set serving.engine=true)")
    event_ts = conf.get_bool("event.timestamps", False)
    broker_spec = conf.get("broker.shards")
    fleet = None
    broker_shard = None
    if broker_spec:
        if not use_engine:
            raise ValueError(
                "broker.shards needs serving.engine=true — the fleet "
                "transport is the engine's bulk protocol")
        from avenir_tpu_torch.stream.fleet import (
            BrokerFleet, consistent_route)
        from avenir_tpu_torch.stream.loop import RedisQueues
        group = conf.get("broker.group", "g0")
        fleet = BrokerFleet(broker_spec)
        broker_shard = consistent_route([group],
                                        range(fleet.n_shards))[group]
        bclient = fleet.client(broker_shard)
        # the job owns its group's key family for the run: a residue an
        # earlier (or crashed) job left on a persistent broker would
        # re-fold its rewards under a fresh cursor and leak its actions
        # into this job's file
        bclient.delete(f"eventQueue:{group}", f"actionQueue:{group}",
                       f"rewardQueue:{group}", f"pendingQueue:{group}")
        queues = RedisQueues(event_queue=f"eventQueue:{group}",
                             action_queue=f"actionQueue:{group}",
                             reward_queue=f"rewardQueue:{group}",
                             pending_queue=f"pendingQueue:{group}",
                             field_delim=conf.get("field.delim", ","),
                             client=bclient)
    else:
        queues = InProcQueues()
    delim_regex = conf.get("field.delim.regex", ",")

    def fill(resumed_events: int = 0) -> None:
        event_rows = read_csv_lines(in_path, delim_regex)
        reward_path = conf.get("reward.data.path")
        reward_rows = (read_csv_lines(reward_path, delim_regex)
                       if reward_path else [])
        if fleet is not None:
            # multi-value LPUSHes of 512 (one broker round trip a chunk;
            # LPUSH appends left to right, as pushes one by one)
            def bulk(queue, payloads, chunk=512):
                for i in range(0, len(payloads), chunk):
                    bclient.lpush(queue, *payloads[i:i + chunk])
            bulk(queues.event_queue,
                 [row[0] for row in event_rows[resumed_events:]])
            bulk(queues.reward_queue,
                 [queues.delim.join([row[0], str(float(row[1]))])
                  for row in reward_rows])
            return
        for row in event_rows[resumed_events:]:
            queues.push_event(row[0])
        for row in reward_rows:
            queues.push_reward(row[0], float(row[1]))

    extra = ""
    if use_engine:
        stats, extra = _run_engine(conf, learner_type, actions, queues,
                                   fill, event_ts, lifecycle_dir, device)
    else:
        with OnlineLearnerLoop(
                learner_type, actions, conf.as_dict(), queues,
                seed=conf.get_int("random.seed", 0),
                checkpoint_dir=conf.get("checkpoint.dir"),
                checkpoint_interval=conf.get_int("checkpoint.interval", 100),
                event_timestamps=event_ts, device=device) as loop:
            # the event file is read again in full on a resume: skip the
            # lines the restored checkpoint served (the loop skips the
            # rewards)
            fill(loop.resumed_events)
            stats = loop.run()
    delim_out = conf.get("field.delim", ",")
    with open(out_path, "w") as fh:
        if fleet is not None:
            # the answers came back through the job's shard: count-form
            # RPOPs drain them oldest first, 512 a round trip
            while True:
                raws = bclient.rpop(queues.action_queue, 512)
                if not raws:
                    break
                for raw in raws:
                    fh.write(raw.decode() + "\n")
        else:
            while True:
                entry = queues.pop_action()
                if entry is None:
                    break
                event_id, selections = entry
                fh.write(delim_out.join([event_id] + selections) + "\n")
    if fleet is not None:
        extra += f', "broker_shard": {broker_shard}'
        fleet.close()
    print(f'{{"events": {stats.events}, "rewards": {stats.rewards}, '
          f'"actions": {stats.actions_written}{extra}}}')


def _run_engine(conf: JobConfig, learner_type: str, actions: List[str],
                queues, fill: Callable[[], None], event_ts: bool,
                lifecycle_dir, device: torch.device):
    """``serving.engine=true``: the engine over the filled queues, the
    registry's head restored first and the state published after where
    ``lifecycle.dir`` is set. Returns (the engine's stats, the JSON
    line's extra keys)."""
    from avenir_tpu_torch.stream.engine import AdmissionControl, ServingEngine
    fill()
    admission = None
    high_water = conf.get_int("engine.admission.high", 0)
    if high_water:
        admission = AdmissionControl(
            high_water=high_water,
            low_water=conf.get_int("engine.admission.low", 0) or None,
            policy=conf.get("engine.shed.policy", "reject-new"),
            shed_chunk=conf.get_int("engine.shed.chunk", 256))
    engine = ServingEngine(
        learner_type, actions, conf.as_dict(), queues,
        seed=conf.get_int("random.seed", 0),
        min_batch=conf.get_int("engine.min.batch", 8),
        max_batch=conf.get_int("engine.max.batch", 0) or None,
        drain_max=conf.get_int("engine.reward.drain.max", 0) or None,
        event_timestamps=event_ts, admission=admission, device=device)
    registry = None
    if lifecycle_dir:
        from avenir_tpu_torch.lifecycle.registry import (
            SnapshotRegistry, state_schema_hash)
        registry = SnapshotRegistry(
            lifecycle_dir,
            max_to_keep=conf.get_int("lifecycle.max.keep", 0) or None)
        head = registry.latest()
        if head is not None:
            if not head.has_payload:
                raise ValueError(
                    f"registry head v{head.version} at {lifecycle_dir} "
                    f"is a file artifact "
                    f"(kind={head.manifest.get('kind')!r}), not a "
                    f"learner-state pytree; the engine restores only "
                    f"learner-state snapshots — point lifecycle.dir "
                    f"at a learner-state registry or publish batch "
                    f"model files to a separate one")
            if (head.schema_hash is not None and head.schema_hash
                    != state_schema_hash(engine.learner.state)):
                raise ValueError(
                    f"registry head v{head.version} at {lifecycle_dir} "
                    f"was published for a different learner shape "
                    f"(schema {head.schema_hash}); clear the registry "
                    f"or match learner.type/action.list/config")
            engine.swap_state(head.restore(like=engine.learner.state),
                              version=head.version)
    stats = engine.run()
    extra = ""
    if registry is not None:
        snap = registry.publish(
            engine.learner.state, kind="learner-state",
            train_rows=stats.rewards,
            extra={"learner_type": learner_type, "events": stats.events})
        extra += f', "lifecycle_version": {snap.version}'
    extra += (f', "overlap_fraction": {round(stats.overlap_fraction, 3)}'
              f', "batches": {stats.batches}')
    if admission is not None:
        extra += f', "shed_total": {stats.shed_total}'
    return stats, extra


# a retried attempt would resume from checkpoint.dir and write only the
# tail of the action file, not the whole: the loop owns its durability
# (checkpoint and event replay), so the job-level retry budget skips it
run_reinforcement_learner.retry_safe = False


def run_lifecycle(conf: JobConfig, in_path: str, out_path: str,
                  device: torch.device) -> None:
    """Snapshot-registry operations, the ``Lifecycle`` verb.
    ``lifecycle.dir`` names the registry; ``lifecycle.command``:

    - ``list``: every committed version's manifest, a JSON line each, to
      ``out_path`` (``in_path`` unread);
    - ``show``: the head's manifest to ``out_path``;
    - ``publish``: ``in_path`` committed verbatim as a file artifact (a
      batch verb's model file, versioned);
    - ``retrain``: one bandit refit wave: a fresh learner
      (``learner.type``, ``action.list``, the learner's keys) on
      ``device``, refit from the reward ledger at ``in_path`` (lines
      ``action,reward``), its state published; the manifest to
      ``out_path``;
    - ``prune``: all but the ``lifecycle.max.keep`` newest versions
      removed.

    Each prints a one-line JSON summary, as the JAX CLI's does."""
    import json as _json
    from avenir_tpu_torch.lifecycle.registry import SnapshotRegistry
    lifecycle_dir = conf.get_required("lifecycle.dir")
    registry = SnapshotRegistry(
        lifecycle_dir,
        max_to_keep=conf.get_int("lifecycle.max.keep", 0) or None)
    command = conf.get("lifecycle.command", "list")
    if command == "list":
        versions = registry.versions()
        with open(out_path, "w") as fh:
            for v in versions:
                fh.write(_json.dumps(registry.get(v).manifest,
                                     sort_keys=True) + "\n")
        print(_json.dumps({"lifecycle.versions": len(versions),
                           "lifecycle.head": registry.latest_version()}))
    elif command == "show":
        head = registry.latest()
        if head is None:
            raise ValueError(f"registry at {lifecycle_dir} is empty")
        with open(out_path, "w") as fh:
            _json.dump(head.manifest, fh, sort_keys=True)
        print(_json.dumps({"lifecycle.head": head.version}))
    elif command == "publish":
        snap = registry.publish(
            file_path=in_path, kind=conf.get("lifecycle.kind", "model"),
            extra={"published_by": "cli"})
        print(_json.dumps({"lifecycle.published": snap.version}))
    elif command == "retrain":
        from avenir_tpu_torch.lifecycle.retrain import (
            RetrainDaemon, bandit_refit_train_fn)
        learner_type = conf.get_required("learner.type")
        actions = conf.get_list("action.list")
        if not actions:
            raise ValueError("action.list must name the candidate actions")
        delim = conf.get("field.delim.regex", ",")

        def rewards():
            return [(r[0], float(r[1]))
                    for r in read_csv_lines(in_path, delim)]
        daemon = RetrainDaemon(registry, bandit_refit_train_fn(
            learner_type, actions, conf.as_dict(), rewards,
            seed=conf.get_int("random.seed", 0), device=device))
        snap = daemon.run_once()
        if snap is None:
            raise RuntimeError(
                f"retrain wave failed: {daemon.last_error!r}")
        with open(out_path, "w") as fh:
            _json.dump(snap.manifest, fh, sort_keys=True)
        print(_json.dumps({"lifecycle.published": snap.version,
                           "lifecycle.train_rows":
                               snap.manifest["train_rows"]}))
    elif command == "prune":
        keep = conf.get_int("lifecycle.max.keep")
        if keep is None:
            raise ValueError("prune needs lifecycle.max.keep")
        removed = registry.prune(keep)
        print(_json.dumps({"lifecycle.pruned": removed,
                           "lifecycle.head": registry.latest_version()}))
    else:
        raise ValueError(
            f"invalid lifecycle.command {command!r} (list, show, publish, "
            "retrain, prune)")


VERBS: Dict[str, Callable[[JobConfig, str, str, torch.device], None]] = {
    "BayesianDistribution": run_bayesian_distribution,
    "BayesianPredictor": run_bayesian_predictor,
    "NearestNeighbor": run_nearest_neighbor,
    "SameTypeSimilarity": run_same_type_similarity,
    "FeatureCondProbJoiner": run_feature_cond_prob_joiner,
    "WordCounter": run_word_counter,
    "UnderSamplingBalancer": run_under_sampling,
    "BaggingSampler": run_bagging,
    "LogisticRegressionJob": run_logistic_regression,
    "FisherDiscriminant": run_fisher_discriminant,
    "Projection": run_projection,
    "ReinforcementLearnerTopology": run_reinforcement_learner,
    "Lifecycle": run_lifecycle,
    "MutualInformation": run_mutual_information,
    "CramerCorrelation": lambda c, i, o, d: run_correlation(
        c, i, o, d, "cramerIndex"),
    "HeterogeneityReductionCorrelation": lambda c, i, o, d: run_correlation(
        c, i, o, d, "concentrationCoeff"),
    "ClassPartitionGenerator": run_class_partition_generator,
    "SplitGenerator": run_split_generator,
    "DataPartitioner": run_data_partitioner,
    "TreeBuilder": run_tree_builder,
    "TreePredictor": run_tree_predictor,
    "MarkovStateTransitionModel": run_markov_state_transition_model,
    "MarkovModelClassifier": run_markov_model_classifier,
    "HiddenMarkovModelBuilder": run_hmm_builder,
    "ViterbiStatePredictor": run_viterbi_state_predictor,
    "RandomForestBuilder": run_forest_builder,
    "RandomForestPredictor": run_forest_predictor,
    "GradientBoostBuilder": run_boost_builder,
    "GradientBoostPredictor": run_boost_predictor,
    **{name: (lambda c, i, o, d, _name=name:
              _run_batch_bandit(_name, c, i, o, d))
       for name in ("GreedyRandomBandit", "AuerDeterministic",
                    "SoftMaxBandit", "RandomFirstGreedyBandit")},
}


def _start_live_obs(conf: JobConfig, obs_port, metrics_out):
    """Arm the live observability layer for the job, or return None.

    ``--obs-port`` or ``obs.http.port >= 0`` binds the scrape endpoint (0
    takes a free port, printed first as a JSON line); those, ``obs.live``,
    an explicit ``obs.flight.path`` or ``alerts.enable`` arm the metrics
    pump and the flight recorder (at ``obs.flight.path``, else
    ``<metrics-out>.flight.jsonl``). ``alerts.enable`` arms the SLO
    burn-rate evaluator and the alert manager: ``alerts.out`` (default
    ``<metrics-out>.alerts.jsonl``), ``alerts.high.water`` with
    ``alerts.horizon.s`` (the saturation forecast), ``obs.slo.p99.ms``
    (the admitted-p99 SLO's bound and the recorder's breach bar)."""
    if obs_port is None:
        conf_port = conf.get_int("obs.http.port", -1)
        obs_port = conf_port if conf_port >= 0 else None
    conf_flight = conf.get("obs.flight.path")
    flight_path = conf_flight or (
        metrics_out + ".flight.jsonl" if metrics_out else None)
    if not (obs_port is not None or conf.get_bool("obs.live", False)
            or conf_flight or conf.get_bool("alerts.enable", False)):
        return None
    import json
    import os
    from dataclasses import replace
    from avenir_tpu_torch.obs.live import start_live_obs
    slo = conf.get("obs.slo.p99.ms")
    alerts_on = conf.get_bool("alerts.enable", False)
    alerts_out = conf.get("alerts.out") or (
        metrics_out + ".alerts.jsonl" if metrics_out else None)
    alerts_hw = conf.get_int("alerts.high.water", -1)
    slos = None
    if alerts_on and slo:
        from avenir_tpu_torch.obs.signals import DEFAULT_SLOS
        slos = [(replace(s, bound_ms=float(slo))
                 if s.name == "admitted_p99" else s) for s in DEFAULT_SLOS]
    live_obs = start_live_obs(
        port=obs_port,
        interval_s=float(conf.get("obs.pump.interval.s") or 0.25),
        flight_path=flight_path,
        slo_p99_ms=float(slo) if slo else None,
        alerts=alerts_on or None,
        slos=slos,
        alerts_path=alerts_out if alerts_on else None,
        high_water=alerts_hw if alerts_on and alerts_hw >= 0 else None,
        forecast_horizon_s=float(conf.get("alerts.horizon.s") or 30.0),
        alert_source="cli")
    if live_obs.port is not None:
        print(json.dumps({"obs_port": live_obs.port, "pid": os.getpid()}),
              flush=True)
    return live_obs


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="avenir_tpu_torch",
        description="PyTorch/CUDA drivers for avenir jobs")
    parser.add_argument("verb", choices=sorted([*VERBS, *_LATER_VERBS]))
    parser.add_argument("input", help="input CSV path")
    parser.add_argument("output", help="output path")
    parser.add_argument("--conf", required=True, help="properties file")
    parser.add_argument("-D", action="append", default=[], metavar="key=val",
                        help="config overrides")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the job runs (default cuda; no GPU and "
                             "no --device cpu is an error)")
    parser.add_argument("--metrics-out", metavar="PATH", default=None,
                        help="enable telemetry for the job and write the "
                             "merged report (spans, kernel builds, RSS, "
                             "counters, gauges) after it: JSONL events at "
                             "PATH, Prometheus text at PATH.prom")
    parser.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                        help="serve live telemetry (/metrics, "
                             "/metrics/rates, /healthz, /alerts) on "
                             "localhost:PORT for the job's duration (0 "
                             "takes a free port; the bound one is printed "
                             "first as a JSON line); the flag form of "
                             "obs.http.port")
    parser.add_argument("--profile-dir", metavar="PATH", default=None,
                        help="write a torch.profiler trace of the job "
                             "(host ops and the card's kernels) into PATH "
                             "as Chrome JSON; the flag form of the "
                             "profile.trace.dir key")
    parser.add_argument("--explain", action="store_true",
                        help="print the verb's plan (nodes, edges, "
                             "fingerprints, cache hit or miss a node) "
                             "without running it; with --metrics-out PATH "
                             "the plan's JSON goes to PATH.plan.json")
    parser.add_argument("--resume", action="store_true",
                        help="resume a killed NearestNeighbor, "
                             "BayesianDistribution or MutualInformation job "
                             "over a part-file dir from its per-shard "
                             "journal (<out>.shards/): completed shards are "
                             "skipped and the output is the bytes of an "
                             "uninterrupted run (sets job.resume=true)")
    args = parser.parse_args(argv)

    if args.verb in _LATER_VERBS:
        _refuse(f"the verb {args.verb}", _LATER_VERBS[args.verb])

    conf = JobConfig.from_file(args.conf)
    for override in args.D:
        key, _, value = override.partition("=")
        conf.set(key, value)
    if args.resume:
        conf.set("job.resume", "true")

    from avenir_tpu_torch.obs import runtime as obs_runtime
    from avenir_tpu_torch.utils import profiling
    from avenir_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    obs_runtime.set_device(device)

    if args.explain:
        # build and print the plan, never run it; the probe touches no
        # cache statistics
        from avenir_tpu_torch.cli import plans as cli_plans
        from avenir_tpu_torch.plan import explain as plan_explain
        from avenir_tpu_torch.utils.atomicio import atomic_json_dump
        if not cli_plans.plan_enabled(conf):
            raise ValueError("--explain needs the plan path "
                             "(plan.enable is false)")
        plan = cli_plans.build_plan(args.verb, conf, args.input,
                                    args.output, device)
        if plan is None:
            raise ValueError(
                f"--explain: {args.verb} does not run on the plan path "
                "with this config (plan-capable verbs: "
                + ", ".join(sorted(cli_plans._BUILDERS)) + "; text/"
                "streaming/neighbor-record/regression/journaled-shard "
                "modes keep the hand-wired body)")
        print(plan_explain.render(plan))
        if args.metrics_out:
            atomic_json_dump(plan_explain.plan_json(plan),
                             args.metrics_out + ".plan.json",
                             indent=2, sort_keys=True)
        return 0

    debug_on = conf.get_bool("debug.on", False)
    logger = profiling.get_logger("cli", debug_on)
    logger.debug("verb=%s input=%s output=%s conf=%s device=%s",
                 args.verb, args.input, args.output, args.conf, device)
    # the flag wins over the key
    trace_dir = args.profile_dir or conf.get("profile.trace.dir")
    timer = profiling.StepTimer(args.verb)
    ctx = (profiling.trace(trace_dir) if trace_dir
           else contextlib.nullcontext())
    # --metrics-out arms the obs layer (tracer, build counters, RSS
    # sampler, MetricsRegistry sink) for this job and writes its report
    tel_hub = None
    if args.metrics_out:
        from avenir_tpu_torch.obs import exporters as obs_exporters
        from avenir_tpu_torch.obs import telemetry as obs_telemetry
        tel_hub = obs_exporters.hub().enable()
    live_obs = _start_live_obs(conf, args.obs_port, args.metrics_out)
    # the reference's task-retry budget (mapreduce.map.maxattempts=2,
    # resource/knn.properties:5-6) at the job level: transient failures
    # re-run the verb (every job fully overwrites its outputs); config
    # errors fail fast
    attempts = max(1,
                   conf.get_int("mapreduce.map.maxattempts", 1),
                   conf.get_int("mapreduce.reduce.maxattempts", 1),
                   conf.get_int("mapred.map.max.attempts", 1),
                   conf.get_int("mapred.reduce.max.attempts", 1),
                   conf.get_int("max.attempts", 1))
    if not getattr(VERBS[args.verb], "retry_safe", True):
        # a verb that keeps its own durability (checkpoint and replay)
        # would write partial output on a rerun, not a full overwrite
        attempts = 1
    job_span = (obs_telemetry.span(f"job.{args.verb}") if tel_hub
                else contextlib.nullcontext())
    try:
        with ctx, timer.step(), job_span:
            for attempt in range(1, attempts + 1):
                reg_mark = tel_hub.registry_mark() if tel_hub else 0
                try:
                    VERBS[args.verb](conf, args.input, args.output, device)
                    break
                except (ValueError, KeyError, FileNotFoundError, TypeError,
                        IndexError):
                    raise
                except Exception:
                    if attempt == attempts:
                        raise
                    if tel_hub is not None:
                        # the report sums registries: a failed attempt's
                        # counters must not add to the retry's
                        tel_hub.drop_registries_since(reg_mark)
                    logger.warning("attempt %d/%d of %s failed; retrying",
                                   attempt, attempts, args.verb,
                                   exc_info=True)
    except BaseException:
        # a failing job leaves its flight record (the last windows of live
        # rates) beside the metrics file; an except clause, so that a
        # caller running main() inside its own handler does not read as a
        # crashed job
        if live_obs is not None:
            live_obs.crash_dump("crash:cli")
        raise
    finally:
        if tel_hub is not None:
            # the wall-time summary rides along as gauges; the report is
            # written on failure too
            for key, value in timer.summary().items():
                tel_hub.set_gauge(f"job.{key}", value)
            try:
                # before live_obs.stop(), which clears the hub's alerts
                # provider: the .prom file names any alert firing at exit
                paths = tel_hub.write(args.metrics_out)
            except OSError as exc:
                logger.warning("telemetry report not written to %s: %s",
                               args.metrics_out, exc)
            else:
                logger.info("telemetry report: %s + %s",
                            paths["jsonl"], paths["prom"])
        if live_obs is not None:
            live_obs.stop()
        if tel_hub is not None:
            tel_hub.disable()
    if debug_on:
        logger.debug("timing %s", timer.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
