"""Driver entry points mirroring the reference's ``hadoop jar <Class>`` verbs:

    python -m avenir_tpu_torch BayesianDistribution IN OUT --conf P [-D k=v]
    python -m avenir_tpu_torch BayesianPredictor    IN OUT --conf P
    python -m avenir_tpu_torch NearestNeighbor      IN OUT --conf P
    python -m avenir_tpu_torch MutualInformation    IN OUT --conf P
    python -m avenir_tpu_torch CramerCorrelation    IN OUT --conf P
    python -m avenir_tpu_torch HeterogeneityReductionCorrelation IN OUT ...

Counterpart of ``avenir_tpu/cli/main.py`` (``main``, ``_load_table``,
``_knn_feature_post``, ``_emit_mi_scores`` and the hand-wired bodies of
the six verbs), with the same ``.properties`` keys, schemas and output
files. ``--device {cuda,cpu}`` (default cuda) picks where the job runs;
with no GPU and no ``--device cpu`` the job raises.

Keys that select something this port does not carry yet (among them the
keys of the JAX CLI's part-file KNN path, on the inputs that take it), and
the JAX CLI's other verbs, raise a ValueError naming the key or verb and
the ROADMAP item that ports it; nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

import torch

from avenir_tpu_torch.utils.config import JobConfig
from avenir_tpu_torch.utils.dataset import (
    Featurizer, part_file_paths, read_csv_lines)
from avenir_tpu_torch.utils.roadmap import roadmap_item
from avenir_tpu_torch.utils.schema import FeatureSchema


# keys that select work outside this port, per verb family: key -> the
# later work that ports it
_LAYERS = roadmap_item("Plan, ingest, obs and checkpoint layers")
_PLAN = f"the plan layer ({_LAYERS})"
_OBS = f"the observability layer ({_LAYERS})"
_MULTI = f"the multi-device layer ({roadmap_item('Multi-device layer')})"
_STREAM_NB = ("streaming/sharded Naive Bayes "
              f"({roadmap_item('Streaming/sharded NB and per-shard MI')})")
_LIVE_ANN = f"the live ANN index ({roadmap_item('Live ANN')})"
_LATER_NB = {"plan.enable": _PLAN, "train.sharded": _MULTI,
             "streaming.train": _STREAM_NB, "shard.parts": _STREAM_NB,
             "job.resume": _STREAM_NB}
_LATER_KNN = {"plan.enable": _PLAN, "knn.ann.live": _LIVE_ANN,
              "knn.sharded": _MULTI, "job.resume": _STREAM_NB}
_SHARD_MI = ("per-shard journaled MI "
             f"({roadmap_item('Streaming/sharded NB and per-shard MI')})")
_LATER_MI = {"plan.enable": _PLAN, "train.sharded": _MULTI,
             "shard.parts": _SHARD_MI, "job.resume": _SHARD_MI}
_LATER_PREFIXES = {"knn.ann.live.": _LIVE_ANN}
# observability keys of the JAX CLI: refused when set, like their flags
_LATER_OBS = ("profile.trace.dir", "obs.http.port", "obs.live",
              "obs.flight.path", "alerts.enable")
# The JAX CLI scores a directory of more than one part file on its
# part-file path unless shard.prefetch=false (avenir_tpu/cli/main.py:953-964)
# and reads these keys only there; this port merges the parts, so a key set
# off its JAX default (:420-488, :732) is refused
_PART_PATH = "the part-file KNN path ({})".format(
    roadmap_item("Native CSV loader and the part-file KNN path"))
_PART_KEYS = {"on.bad.row": "raise", "max.bad.fraction": 0.1,
              "quarantine.dir": None, "shard.retries": 1,
              "shard.timeout.s": 0.0, "shard.speculate": True,
              "shard.speculative.factor": 4.0,
              "shard.speculative.min.wait.s": 2.0,
              "shard.prefetch.depth": 2, "shard.journal": True,
              "shard.journal.keep": False, "shard.report": False}
# the JAX CLI's verbs this port does not carry yet -> the ROADMAP queue A
# item that ports them
_SIMILARITY = roadmap_item(
    "`SameTypeSimilarity` and `FeatureCondProbJoiner` verbs")
_TREES = roadmap_item("Trees, forests and boosting")
_EXPLORE = roadmap_item("Explore, regress, discriminant and text")
_SEQUENCES = roadmap_item("Sequences")
_BANDITS = roadmap_item("Bandits and streaming serving")
_LATER_VERBS = {
    "SameTypeSimilarity": _SIMILARITY,
    "FeatureCondProbJoiner": _SIMILARITY,
    "ClassPartitionGenerator": _TREES,
    "SplitGenerator": _TREES,
    "DataPartitioner": _TREES,
    "TreeBuilder": _TREES,
    "TreePredictor": _TREES,
    "RandomForestBuilder": _TREES,
    "RandomForestPredictor": _TREES,
    "GradientBoostBuilder": _TREES,
    "GradientBoostPredictor": _TREES,
    "Projection": _EXPLORE,
    "WordCounter": _EXPLORE,
    "UnderSamplingBalancer": _EXPLORE,
    "BaggingSampler": _EXPLORE,
    "LogisticRegressionJob": _EXPLORE,
    "FisherDiscriminant": _EXPLORE,
    "MarkovStateTransitionModel": _SEQUENCES,
    "MarkovModelClassifier": _SEQUENCES,
    "HiddenMarkovModelBuilder": _SEQUENCES,
    "ViterbiStatePredictor": _SEQUENCES,
    "GreedyRandomBandit": _BANDITS,
    "AuerDeterministic": _BANDITS,
    "SoftMaxBandit": _BANDITS,
    "RandomFirstGreedyBandit": _BANDITS,
    "ReinforcementLearnerTopology": _BANDITS,
    "Lifecycle": _BANDITS,
}


def _refuse(key: str, later: str) -> None:
    raise ValueError(f"{key} is not supported by avenir_tpu_torch yet: "
                     f"{later} ports it; run avenir_tpu for this job")


def _check_keys(conf: JobConfig, later: Dict[str, str]) -> None:
    for key, work in later.items():
        if conf.get_bool(key, False):
            _refuse(f"{key}={conf.get(key)}", work)


def _check_part_keys(conf: JobConfig, in_path: str) -> None:
    """Refuse the keys of the JAX CLI's part-file KNN path where the JAX
    CLI would take it and read them."""
    if (len(part_file_paths(in_path)) < 2
            or not conf.get_bool("shard.prefetch", True)):
        return
    for key, default in _PART_KEYS.items():
        if key not in conf:
            continue
        if isinstance(default, bool):
            value = conf.get_bool(key, default)
        elif isinstance(default, int):
            value = conf.get_int(key, default)
        elif isinstance(default, float):
            value = conf.get_float(key, default)
        else:
            value = conf.get(key)
        if value != default:
            _refuse(f"{key}={conf.get(key)}", _PART_PATH)


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


def _check_tabular(conf: JobConfig) -> None:
    if not conf.get_bool("tabular.input", True):
        _refuse("tabular.input=false",
                f"text Naive Bayes ({roadmap_item('Text Naive Bayes')})")


def run_bayesian_distribution(conf: JobConfig, in_path: str, out_path: str,
                              device: torch.device) -> None:
    """Train Naive Bayes distributions (reference BayesianDistribution)."""
    from avenir_tpu_torch.models import naive_bayes as nb
    _check_keys(conf, _LATER_NB)
    _check_tabular(conf)
    fz, rows = _load_table(conf, in_path, device)
    table = fz.transform(rows)
    model, meta, metrics = nb.train(table)
    nb.save_model(model, meta, out_path, delim=conf.get("field.delim", ","))
    print(metrics.to_json())


def run_bayesian_predictor(conf: JobConfig, in_path: str, out_path: str,
                           device: torch.device) -> None:
    """Predict with a trained model (reference BayesianPredictor). Honors
    ``field.delim.out``, ``bp.predict.class``, ``bp.predict.class.cost``,
    ``class.prob.diff.threshold`` and ``output.feature.prob.only``."""
    from avenir_tpu_torch.models import naive_bayes as nb
    _check_keys(conf, _LATER_NB)
    _check_tabular(conf)
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


def run_nearest_neighbor(conf: JobConfig, in_path: str, out_path: str,
                         device: torch.device) -> None:
    """KNN classification (reference NearestNeighbor job, fused with the
    distance computation). ``in_path`` is the test data;
    ``train.data.path`` points at the training data. Both spellings of the
    class-weighting key are honored (``class.condition.weighted`` and the
    ``class.condtion.weighted`` typo of resource/knn.properties:34)."""
    from avenir_tpu_torch.models import knn
    _check_keys(conf, _LATER_KNN)
    for key in conf.keys():
        for prefix, work in _LATER_PREFIXES.items():
            if key.startswith(prefix):
                _refuse(key, work)
    feed = roadmap_item("Threaded `DeviceFeed` (`feed.depth`)")
    for key, work in (("feed.depth", f"the threaded DeviceFeed ({feed})"),
                      ("mesh.shape", _MULTI)):
        if key in conf:
            _refuse(key, work)
    if conf.get("neighbor.data.path"):
        _refuse("neighbor.data.path", "neighbor-record replay "
                f"({roadmap_item('Neighbor-record replay')})")
    if conf.get("prediction.mode", "classification") != "classification":
        _refuse(f"prediction.mode={conf.get('prediction.mode')}",
                f"KNN regression ({roadmap_item('KNN regression')})")
    _check_part_keys(conf, in_path)
    validation = conf.get_bool("validation.mode", False)
    fz, train_rows = _load_table(conf, conf.get_required("train.data.path"),
                                 device)
    train = fz.transform(train_rows)
    cfg = knn.KnnConfig(
        top_match_count=conf.get_int("top.match.count", 5),
        kernel_function=conf.get("kernel.function", "none"),
        kernel_param=conf.get_int("kernel.param", 100),
        class_cond_weighted=(conf.get_bool("class.condition.weighted", False)
                             or conf.get_bool("class.condtion.weighted",
                                              False)),
        inverse_distance_weighted=conf.get_bool("inverse.distance.weighted",
                                                False),
        decision_threshold=conf.get_float("decision.threshold", -1.0),
        positive_class=conf.get("positive.class.value"),
        distance_scale=conf.get_int("distance.scale", 1000),
        algorithm=fz.schema.dist_algorithm or "euclidean",
        feed_chunk_rows=conf.get_int("feed.chunk.rows", 0),
        mode=conf.get("knn.mode", "fast"),
        fused=conf.get_bool("knn.fused", True),
        quantized=conf.get_bool("knn.quantized", False),
        quantized_oversample=conf.get_int("knn.quantized.oversample", 4),
        quantized_dtype=conf.get("knn.quantized.dtype", "int8"),
        ann=conf.get_bool("knn.ann", False),
        ann_nlist=conf.get_int("knn.ann.nlist", 0),
        ann_nprobe=conf.get_int("knn.ann.nprobe", 0),
        ann_iters=conf.get_int("knn.ann.iters", 15),
        ann_seed=conf.get_int("knn.ann.seed", 0))
    delim = conf.get("field.delim.out", ",")
    test_rows = read_csv_lines(in_path, conf.get("field.delim.regex", ","))
    # with the chunked feed the test table stays on the host and streams
    # to the device chunk by chunk
    test_device = "cpu" if cfg.feed_chunk_rows > 0 else device
    test = fz.transform(test_rows, with_labels=validation,
                        device=test_device)

    feature_post = _knn_feature_post(train, cfg)
    pred = knn.classify(train, test, cfg, feature_post=feature_post)
    output_distr = conf.get_bool("output.class.distr", False)
    with open(out_path, "w") as fh:
        for i in range(test.n_rows):
            parts = [test.ids[i], train.class_values[int(pred.predicted[i])]]
            if output_distr and pred.class_prob is not None:
                for ci, cls in enumerate(train.class_values):
                    parts += [cls, str(int(pred.class_prob[i, ci]))]
            fh.write(delim.join(parts) + "\n")
    if validation and test.labels is not None:
        cm = knn.validate(pred, test,
                          positive_class=conf.get("positive.class.value"))
        print(cm.report().to_json())


def run_mutual_information(conf: JobConfig, in_path: str, out_path: str,
                           device: torch.device) -> None:
    """All MI distribution families + feature-selection scores (reference
    MutualInformation job). Output: per-feature class MI lines, pair MI
    lines, then each selection algorithm's ranking (``mi.score.algorithms``
    names match the reference registry)."""
    from avenir_tpu_torch.explore import mutual_information as mi
    _check_keys(conf, _LATER_MI)
    if "mesh.shape" in conf:
        _refuse("mesh.shape", _MULTI)
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


VERBS: Dict[str, Callable[[JobConfig, str, str, torch.device], None]] = {
    "BayesianDistribution": run_bayesian_distribution,
    "BayesianPredictor": run_bayesian_predictor,
    "NearestNeighbor": run_nearest_neighbor,
    "MutualInformation": run_mutual_information,
    "CramerCorrelation": lambda c, i, o, d: run_correlation(
        c, i, o, d, "cramerIndex"),
    "HeterogeneityReductionCorrelation": lambda c, i, o, d: run_correlation(
        c, i, o, d, "concentrationCoeff"),
}


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
                        help="not supported yet (refused)")
    parser.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                        help="not supported yet (refused)")
    parser.add_argument("--resume", action="store_true",
                        help="not supported yet (refused)")
    args = parser.parse_args(argv)

    if args.verb in _LATER_VERBS:
        _refuse(f"the verb {args.verb}", _LATER_VERBS[args.verb])
    if args.metrics_out is not None or args.obs_port is not None:
        _refuse("--metrics-out/--obs-port", _OBS)
    if args.resume:
        _refuse("--resume", _STREAM_NB)

    conf = JobConfig.from_file(args.conf)
    for override in args.D:
        key, _, value = override.partition("=")
        conf.set(key, value)
    for key in _LATER_OBS:
        if key in conf:
            _refuse(key, _OBS)

    from avenir_tpu_torch.utils import profiling
    from avenir_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    logger = profiling.get_logger("cli", conf.get_bool("debug.on", False))
    logger.debug("verb=%s input=%s output=%s conf=%s device=%s",
                 args.verb, args.input, args.output, args.conf, device)
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
    for attempt in range(1, attempts + 1):
        try:
            VERBS[args.verb](conf, args.input, args.output, device)
            break
        except (ValueError, KeyError, FileNotFoundError, TypeError,
                IndexError):
            raise
        except Exception:
            if attempt == attempts:
                raise
            logger.warning("attempt %d/%d of %s failed; retrying",
                           attempt, attempts, args.verb, exc_info=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
