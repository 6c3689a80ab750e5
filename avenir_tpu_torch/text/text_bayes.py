"""Text-mode Naive Bayes: a bag-of-words classifier over tokenized text.

Counterpart of ``avenir_tpu/text/text_bayes.py`` (``TextBayesModel``,
``train``, ``predict``, ``save_model``, ``load_model``,
``TEXT_ORDINAL``). The reference's text path lives inside
BayesianDistribution: when the input is not tabular, each row is
``text<delim>classVal`` and ``mapText`` (BayesianDistribution.java
:187-196) tokenizes the text and emits (classVal, ordinal=1, token) -> 1,
every token a "bin" of the single text feature at ordinal 1. Prediction
follows the tabular Bayes rule (BayesianPredictor.java:396-421) with
P(token|class) in place of P(bin|class):

    train:   counts[c, v] += 1 for every (class c, token v) occurrence
    predict: argmax_c  log P(c) + sum_tokens log P(token|class c)

with Laplace smoothing over the vocabulary.

The host tokenizes and encodes the vocabulary in first-seen order; K1
counts the documents a class and the [C, V] (class, token) occurrences
(``ops/histogram.class_bin_counts_exact``), exact in int64 where the JAX
package's f32 scatter-add is exact only below 2^24 a cell. The model
holds the counts as float64. Prediction runs on the counts' device: the
log prior, the Laplace-smoothed log conditionals (XLA's CPU ``log``,
``infotheory.xla_log``), the padded gather, the sum over a document's
tokens in the order of the compiled reduction (``infotheory.xla_sum``),
and ``argmax``: the JAX package's scores bit for bit.

The model file is the reference's 4-field empty-column tagged union
(BayesianPredictor.java:194-218), the text feature at ordinal
``TEXT_ORDINAL`` = 1 and the token as the bin label: the same bytes as
the JAX package's, each package's ``load_model`` reading the other's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.histogram import class_bin_counts_exact
from avenir_tpu_torch.ops.infotheory import xla_log, xla_sum
from avenir_tpu_torch.text.analyzer import StandardAnalyzer
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, MetricsRegistry

TEXT_ORDINAL = 1   # BayesianDistribution.java:127 ``featureAttrOrdinal = 1``


@dataclass
class TextBayesModel:
    """The vocabulary and the count tensors (float64, on one device)."""

    class_values: Tuple[str, ...]
    vocab: Dict[str, int]
    class_counts: torch.Tensor    # [C]    documents per class
    token_counts: torch.Tensor    # [C, V] token occurrences per class

    @property
    def n_classes(self) -> int:
        return len(self.class_values)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def train(rows: Sequence[Sequence[str]], text_ordinal: int = 0,
          class_ordinal: int = 1,
          analyzer: Optional[StandardAnalyzer] = None,
          device: DeviceLike = "cuda"
          ) -> Tuple[TextBayesModel, MetricsRegistry]:
    """Rows are parsed CSV records, the text at ``text_ordinal`` and the
    class label at ``class_ordinal`` (the reference hardwires 0 and 1,
    mapText :188-189)."""
    dev = resolve_device(device)
    analyzer = analyzer or StandardAnalyzer()
    class_index: Dict[str, int] = {}
    vocab: Dict[str, int] = {}
    doc_class: List[int] = []
    token_class: List[int] = []
    token_ids: List[int] = []
    for row in rows:
        ci = class_index.setdefault(row[class_ordinal], len(class_index))
        doc_class.append(ci)
        for tok in analyzer.tokenize(row[text_ordinal]):
            token_class.append(ci)
            token_ids.append(vocab.setdefault(tok, len(vocab)))

    def on_device(values):
        return torch.from_numpy(np.asarray(values, np.int32)).to(dev)

    n_classes, vocab_size = len(class_index), max(len(vocab), 1)
    doc = on_device(doc_class)
    # the documents a class: K1 with the class as the bin of one label
    cls = class_bin_counts_exact(doc, torch.zeros_like(doc), 1,
                                 n_classes).reshape(n_classes)
    tok = class_bin_counts_exact(on_device(token_ids),
                                 on_device(token_class), n_classes,
                                 vocab_size)
    metrics = MetricsRegistry()
    metrics.set("Distribution Data", "Records", len(doc_class))
    metrics.set("Distribution Data", "Vocabulary", len(vocab))
    model = TextBayesModel(
        class_values=tuple(class_index), vocab=dict(vocab),
        class_counts=cls.to(torch.float64),
        token_counts=tok.to(torch.float64))
    return model, metrics


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log``, with ``log 0 = -inf`` (a zero count under
    ``laplace.smoothing=0``)."""
    return torch.where(x > 0, xla_log(x),
                       torch.full_like(x, float("-inf")))


def _scores(model: TextBayesModel, ids: torch.Tensor, mask: torch.Tensor,
            laplace: float) -> torch.Tensor:
    """[N, C] log scores of the padded documents ``ids`` [N, L] (OOV and
    padding at id 0, ``mask`` 0): the counterpart of the JAX package's
    ``_predict_kernel`` in f32, the counts rounded to f32 as its model
    holds them."""
    cc = model.class_counts.to(torch.float32)
    tc = model.token_counts.to(torch.float32)
    # the count totals are integer sums, exact in float64 in any order
    log_prior = _log(cc + 1e-30) - _log(
        model.class_counts.sum().to(torch.float32) + 1e-30)
    # log P(v|c) with Laplace smoothing over the vocabulary
    log_cond = _log(tc + laplace) - _log(
        model.token_counts.sum(1, keepdim=True).to(torch.float32)
        + laplace * tc.shape[1])
    doc_ll = xla_sum(log_cond[:, ids] * mask.unsqueeze(0), 2).T  # [N, C]
    return doc_ll + log_prior.reshape(1, -1)


def predict(model: TextBayesModel, texts: Sequence[str],
            analyzer: Optional[StandardAnalyzer] = None,
            laplace: float = 1.0,
            truth: Optional[Sequence[str]] = None
            ) -> Tuple[List[str], np.ndarray, Optional[ConfusionMatrix]]:
    """Classify texts on the model's device; returns (labels, the [N, C]
    log-score matrix, the confusion matrix when ``truth`` is given)."""
    analyzer = analyzer or StandardAnalyzer()
    token_lists = [[model.vocab[t] for t in analyzer.tokenize(x)
                    if t in model.vocab] for x in texts]
    max_len = max((len(t) for t in token_lists), default=0) or 1
    n = len(texts)
    ids = np.zeros((n, max_len), np.int64)
    mask = np.zeros((n, max_len), np.float32)
    for i, toks in enumerate(token_lists):
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1.0
    dev = model.class_counts.device
    scores = _scores(model, torch.from_numpy(ids).to(dev),
                     torch.from_numpy(mask).to(dev), laplace)
    pred_idx = torch.argmax(scores, dim=1).cpu().numpy()
    labels = [model.class_values[i] for i in pred_idx]

    confusion = None
    if truth is not None:
        confusion = ConfusionMatrix(model.class_values)
        cls_index = {c: i for i, c in enumerate(model.class_values)}
        unknown = sorted({t for t in truth if t not in cls_index})
        if unknown:
            raise ValueError(
                f"truth labels {unknown} not among model classes "
                f"{list(model.class_values)}")
        confusion.update(pred_idx,
                         np.asarray([cls_index[t] for t in truth], np.int32))
    return labels, scores.cpu().numpy(), confusion


def save_model(model: TextBayesModel, path: str, delim: str = ",") -> None:
    """The reference's 4-field tagged-union lines, the token as the bin
    label."""
    cls_counts = model.class_counts.cpu().numpy()
    tok_counts = model.token_counts.cpu().numpy()
    inv_vocab = {i: t for t, i in model.vocab.items()}
    lines: List[str] = []
    for ci, cls in enumerate(model.class_values):
        for vi in np.nonzero(tok_counts[ci])[0]:
            lines.append(delim.join([cls, str(TEXT_ORDINAL),
                                     inv_vocab[int(vi)],
                                     str(int(round(tok_counts[ci, vi])))]))
        lines.append(delim.join([cls, "", "",
                                 str(int(round(cls_counts[ci])))]))
    marginal = tok_counts.sum(axis=0)
    for vi in np.nonzero(marginal)[0]:
        lines.append(delim.join(["", str(TEXT_ORDINAL), inv_vocab[int(vi)],
                                 str(int(round(marginal[vi])))]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_model(path: str, delim: str = ",",
               device: DeviceLike = "cuda") -> TextBayesModel:
    """A model file of either package; the feature-prior marginal lines
    are skipped (they follow from the posteriors)."""
    class_index: Dict[str, int] = {}
    vocab: Dict[str, int] = {}
    cls_rows: List[Tuple[int, float]] = []
    tok_rows: List[Tuple[int, int, float]] = []
    with open(path) as fh:
        for line in fh:
            items = line.rstrip("\n").split(delim)
            if not any(items) or items[0] == "":
                continue
            ci = class_index.setdefault(items[0], len(class_index))
            if items[1] == "" and items[2] == "":
                cls_rows.append((ci, float(items[3])))
            else:
                vi = vocab.setdefault(items[2], len(vocab))
                tok_rows.append((ci, vi, float(items[3])))
    n_classes, vocab_size = len(class_index), max(len(vocab), 1)
    cls = np.zeros((n_classes,), np.float64)
    tok = np.zeros((n_classes, vocab_size), np.float64)
    for ci, v in cls_rows:
        cls[ci] = v
    for ci, vi, v in tok_rows:
        tok[ci, vi] = v
    dev = resolve_device(device)
    return TextBayesModel(class_values=tuple(class_index), vocab=dict(vocab),
                          class_counts=torch.from_numpy(cls).to(dev),
                          token_counts=torch.from_numpy(tok).to(dev))
