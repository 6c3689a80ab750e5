"""Driver entry points mirroring the reference's ``hadoop jar <Class>`` verbs:

    python -m avenir_tpu_torch BayesianDistribution IN OUT --conf P [-D k=v]
    python -m avenir_tpu_torch BayesianPredictor    IN OUT --conf P
    python -m avenir_tpu_torch NearestNeighbor      IN OUT --conf P

Counterpart of ``avenir_tpu/cli/main.py`` (``main``, ``_load_table``,
``_knn_feature_post`` and the hand-wired bodies of the three verbs), with
the same ``.properties`` keys, schemas and output files. ``--device
{cuda,cpu}`` (default cuda) picks where the job runs; with no GPU and no
``--device cpu`` the job raises.

Keys that select something this port does not carry yet raise a
ValueError naming the key and the later work that ports it; nothing is
silently ignored.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

import torch

from avenir_tpu_torch.utils.config import JobConfig
from avenir_tpu_torch.utils.dataset import Featurizer, read_csv_lines
from avenir_tpu_torch.utils.schema import FeatureSchema

# keys that select work outside this port, per verb family: key -> the
# later work that ports it (ROADMAP queue A)
_PLAN = "the plan layer (ROADMAP queue A item 13)"
_MULTI = "the multi-device layer (ROADMAP queue A item 14)"
_STREAM_NB = "streaming/sharded Naive Bayes (ROADMAP queue A item 6)"
_QUANT = "the quantized candidate pass (ROADMAP queue A item 8)"
_IVF = "the IVF index (ROADMAP queue A item 8)"
_LATER_NB = {"plan.enable": _PLAN, "train.sharded": _MULTI,
             "streaming.train": _STREAM_NB, "shard.parts": _STREAM_NB,
             "job.resume": _STREAM_NB}
_LATER_KNN = {"plan.enable": _PLAN, "knn.quantized": _QUANT,
              "knn.ann": _IVF, "knn.sharded": _MULTI,
              "job.resume": _STREAM_NB}
_LATER_PREFIXES = {"knn.ann.": _IVF, "knn.quantized.": _QUANT}
# observability keys of the JAX CLI (ROADMAP queue A item 13): refused
# when set, like their flags
_LATER_OBS = ("profile.trace.dir", "obs.http.port", "obs.live",
              "obs.flight.path", "alerts.enable")
_LATER_VERBS = {
    "SameTypeSimilarity": "ROADMAP queue A item 7",
    "FeatureCondProbJoiner": "ROADMAP queue A item 7",
}


def _refuse(key: str, later: str) -> None:
    raise ValueError(f"{key} is not supported by avenir_tpu_torch yet: "
                     f"{later} ports it; run avenir_tpu for this job")


def _check_keys(conf: JobConfig, later: Dict[str, str]) -> None:
    for key, work in later.items():
        if conf.get_bool(key, False):
            _refuse(f"{key}={conf.get(key)}", work)


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
                "text Naive Bayes (ROADMAP queue A item 5)")


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
    for key, work in (("feed.depth",
                       "the threaded DeviceFeed (ROADMAP queue A item 1)"),
                      ("mesh.shape", _MULTI)):
        if key in conf:
            _refuse(key, work)
    if conf.get("neighbor.data.path"):
        _refuse("neighbor.data.path",
                "neighbor-record replay (ROADMAP queue A item 4)")
    if conf.get("prediction.mode", "classification") != "classification":
        _refuse(f"prediction.mode={conf.get('prediction.mode')}",
                "KNN regression (ROADMAP queue A item 3)")
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
        fused=conf.get_bool("knn.fused", True))
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


VERBS: Dict[str, Callable[[JobConfig, str, str, torch.device], None]] = {
    "BayesianDistribution": run_bayesian_distribution,
    "BayesianPredictor": run_bayesian_predictor,
    "NearestNeighbor": run_nearest_neighbor,
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
        _refuse("--metrics-out/--obs-port",
                "the observability layer (ROADMAP queue A item 13)")
    if args.resume:
        _refuse("--resume", _STREAM_NB)

    conf = JobConfig.from_file(args.conf)
    for override in args.D:
        key, _, value = override.partition("=")
        conf.set(key, value)
    for key in _LATER_OBS:
        if key in conf:
            _refuse(key, "the observability layer (ROADMAP queue A item 13)")

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
