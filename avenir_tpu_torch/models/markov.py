"""Markov-chain state-transition model + classifier.

Counterpart of ``avenir_tpu/models/markov.py`` (``MarkovModel``,
``encode_sequences``, ``train``, ``train_streamed``, ``save_model``,
``load_model``, ``classify``, ``validate``, ``transaction_states``,
``next_states``), with the reference's semantics:

- **train** (MarkovStateTransitionModel.java:116-133, per class label at
  :246-270): the (class, source, destination) bigram counts of a padded
  ``[B, T]`` batch are K4's function, pair contingency counts of the ids
  ``a = class·S + src`` and ``b = dst``, a step masked past its row's
  length taking ``a = -1``, which K4 drops. ``_bigram_counts`` builds those
  ids as torch ops on the device and counts them through
  ``ops/histogram.pair_counts``, in launches of fewer than 2^24
  transitions each (K4's f32 cells are exact below 2^24), summed in int64:
  the counts are exact at any size. The JAX package's one-hot product is
  exact only below 2^24 a cell; below that the two agree.
- **normalize**: the reference's Laplace rule and scaled-int division
  (``utils/tables.laplace_and_scale``), on the host.
- **classify** (MarkovModelClassifier.java:121-144): the log ratio of the
  two class-conditional matrices, built on the host with numpy as the JAX
  package builds it, then one gather and a sum over time in f32 on the
  device, in the order of XLA's CPU row reduction where it was measured
  (``_row_sum``); the sign picks the class.

Wire format (reducer cleanup :201-241): optional states line, then for a
class-based model ``classLabel:<label>`` followed by S matrix rows, repeated
per label; global model is just the S rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix
from avenir_tpu_torch.utils.tables import laplace_and_scale

#: the most transitions one K4 launch counts: each of its f32 cells then
#: stays below 2^24, where f32 integers are exact
MAX_LAUNCH_TRANSITIONS = (1 << 24) - 1


@dataclass
class MarkovModel:
    states: List[str]
    scale: int                      # trans.prob.scale (1 -> float probs)
    trans: Optional[np.ndarray] = None             # [S, S] global
    class_trans: Optional[Dict[str, np.ndarray]] = None  # per class label


def encode_sequences(sequences: Sequence[Sequence[str]], states: List[str],
                     device: DeviceLike = "cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad string state sequences to [B, T >= 2] int32 codes + lengths on
    ``device``."""
    index = {s: i for i, s in enumerate(states)}
    t_max = max((len(s) for s in sequences), default=1)
    batch = np.zeros((len(sequences), max(t_max, 2)), np.int32)
    lengths = np.zeros(len(sequences), np.int32)
    for b, seq in enumerate(sequences):
        codes = [index[s] for s in seq]
        batch[b, :len(codes)] = codes
        lengths[b] = len(codes)
    dev = resolve_device(device)
    return torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev)


def _launch_rows(lengths: torch.Tensor) -> List[Tuple[int, int]]:
    """Consecutive row ranges, each holding at most
    ``MAX_LAUNCH_TRANSITIONS`` transitions (a row of ``n`` states holds
    ``n - 1``): the rows of one K4 launch each."""
    trans = np.maximum(lengths.cpu().numpy().astype(np.int64) - 1, 0)
    if trans.size and trans.max() > MAX_LAUNCH_TRANSITIONS:
        raise ValueError(
            f"a sequence with {int(trans.max())} transitions exceeds the "
            f"{MAX_LAUNCH_TRANSITIONS} that one exact K4 launch counts; "
            "split the sequence")
    # each launch takes the longest run of rows that fits
    ends = np.cumsum(trans)
    ranges, lo, base = [], 0, 0
    while lo < len(trans):
        hi = int(np.searchsorted(ends, base + MAX_LAUNCH_TRANSITIONS,
                                 side="right"))
        ranges.append((lo, hi))
        lo, base = hi, int(ends[hi - 1])
    return ranges


def _bigram_ids(seqs: torch.Tensor, lengths: torch.Tensor,
                class_ids: Optional[torch.Tensor],
                n_states: int) -> torch.Tensor:
    """K4's operands for a [B, T] batch: one [2, B·(T-1)] int32 tensor
    whose rows are ``a = class·S + src`` and ``b = dst`` of every step, a
    step past its row's length taking ``a = -1`` (two rows of one tensor:
    K4 reads ``b`` at a fixed stride past ``a``)."""
    src, dst = seqs[:, :-1], seqs[:, 1:]
    pos = torch.arange(src.shape[1], device=seqs.device)[None, :]
    mask = pos + 1 < lengths[:, None]                           # [B, T-1]
    lhs = src if class_ids is None else (class_ids[:, None] * n_states
                                         + src)
    ids = torch.empty((2, src.numel()), dtype=torch.int32,
                      device=seqs.device)
    ids[0] = torch.where(mask, lhs, -1).reshape(-1)
    ids[1] = dst.reshape(-1)
    return ids


def _bigram_counts(seqs: torch.Tensor, lengths: torch.Tensor,
                   class_ids: Optional[torch.Tensor],
                   n_states: int, n_classes: int) -> torch.Tensor:
    """[B, T] padded sequences -> [n_classes, S, S] int64 transition counts
    (n_classes=1 for the global model): the combiner, shuffle and reducer
    of the reference as K4 launches of fewer than 2^24 transitions each,
    their exact f32 counts added in int64."""
    counts = torch.zeros((n_classes * n_states, n_states), dtype=torch.int64,
                         device=seqs.device)
    for lo, hi in _launch_rows(lengths):
        ids = _bigram_ids(seqs[lo:hi], lengths[lo:hi],
                          None if class_ids is None else class_ids[lo:hi],
                          n_states)
        counts += histogram.pair_counts(ids[0], ids[1], n_classes * n_states,
                                        n_states).to(torch.int64)
    return counts.reshape(n_classes, n_states, n_states)


def train_encoded(seqs: torch.Tensor, lengths: torch.Tensor,
                  states: List[str],
                  class_ids: Optional[torch.Tensor] = None,
                  label_values: Optional[List[str]] = None,
                  scale: int = 1000) -> MarkovModel:
    """``train`` on sequences already encoded (``encode_sequences``; for a
    class-conditional model ``class_ids`` [B] index ``label_values``)."""
    n_classes = 1 if class_ids is None else len(label_values)
    counts = _bigram_counts(seqs, lengths, class_ids, len(states),
                            n_classes).cpu().numpy()
    # while f32 holds every row's sum (and the Laplace ones) exactly, the
    # counts normalize in f32, as the JAX package normalizes its product's
    # f32 counts, bit for bit; past that, in float64, where they stay exact
    f32_exact = counts.sum(axis=-1).max(initial=0) + len(states) < 1 << 24
    counts = counts.astype(np.float32 if f32_exact else np.float64)
    if class_ids is None:
        return MarkovModel(states=list(states), scale=scale,
                           trans=laplace_and_scale(counts[0], scale))
    per_class = {label: laplace_and_scale(counts[i], scale)
                 for i, label in enumerate(label_values)}
    return MarkovModel(states=list(states), scale=scale,
                       class_trans=per_class)


def train(sequences: Sequence[Sequence[str]], states: List[str],
          class_labels: Optional[Sequence[str]] = None,
          label_values: Optional[List[str]] = None,
          scale: int = 1000, device: DeviceLike = "cuda") -> MarkovModel:
    """Build the (optionally class-conditional) transition model."""
    seqs, lengths = encode_sequences(sequences, states, device)
    if class_labels is None:
        return train_encoded(seqs, lengths, states, scale=scale)
    label_values = label_values or sorted(set(class_labels))
    lab_index = {v: i for i, v in enumerate(label_values)}
    class_ids = torch.tensor([lab_index[c] for c in class_labels],
                             dtype=torch.int32, device=seqs.device)
    return train_encoded(seqs, lengths, states, class_ids, label_values,
                         scale)


def train_streamed(path: str, states: List[str], delim_regex: str = ",",
                   skip_fields: int = 0, class_label_ord: int = -1,
                   label_values: Optional[List[str]] = None,
                   scale: int = 1000, chunk_rows: int = 65536,
                   device: DeviceLike = "cuda") -> MarkovModel:
    """Out-of-core transition-model training: stream CSV rows, count each
    chunk of ``chunk_rows`` rows (or fewer, so that a chunk holds at most
    ``MAX_LAUNCH_TRANSITIONS`` transitions) and discard it; the chunks'
    exact counts add on the host in float64, so the streamed model equals
    ``train``'s on the same data. A single row of more transitions is
    rejected. For class-conditional models pass ``label_values``; absent
    that a label-discovery pass runs first."""
    from avenir_tpu_torch.utils.dataset import iter_csv_rows
    dev = resolve_device(device)
    n_states = len(states)
    if class_label_ord >= 0 and label_values is None:
        seen = set()
        for row in iter_csv_rows(path, delim_regex):
            seen.add(row[class_label_ord])
        label_values = sorted(seen)
    n_classes = len(label_values) if class_label_ord >= 0 else 1
    lab_index = ({v: i for i, v in enumerate(label_values)}
                 if class_label_ord >= 0 else None)
    eff_skip = skip_fields + (1 if class_label_ord >= 0 else 0)
    counts = None
    pending: List[List[str]] = []
    pending_trans = 0

    def flush():
        nonlocal counts, pending_trans
        pending_trans = 0
        if not pending:
            return
        batch, lengths = encode_sequences([r[eff_skip:] for r in pending],
                                          states, dev)
        cids = None
        if lab_index is not None:
            cids = torch.tensor([lab_index[r[class_label_ord]]
                                 for r in pending], dtype=torch.int32,
                                device=dev)
        part = _bigram_counts(batch, lengths, cids, n_states,
                              n_classes).cpu().numpy().astype(np.float64)
        counts = part if counts is None else counts + part
        pending.clear()

    for row in iter_csv_rows(path, delim_regex):
        t = max(len(row) - eff_skip - 1, 0)     # this row's transitions
        if t > MAX_LAUNCH_TRANSITIONS:
            raise ValueError(
                f"sequence with {t} transitions exceeds the 2^24 f32-exact "
                "per-chunk envelope; split the sequence or use train()")
        if pending and pending_trans + t > MAX_LAUNCH_TRANSITIONS:
            flush()
        pending.append(row)
        pending_trans += t
        if len(pending) >= chunk_rows:
            flush()
    flush()
    if counts is None:
        raise ValueError(f"no rows in {path}")
    if lab_index is None:
        return MarkovModel(states=list(states), scale=scale,
                           trans=laplace_and_scale(counts[0], scale))
    per_class = {label: laplace_and_scale(counts[i], scale)
                 for i, label in enumerate(label_values)}
    return MarkovModel(states=list(states), scale=scale,
                       class_trans=per_class)


# --------------------------------------------------------------------------
# wire format
# --------------------------------------------------------------------------

def _fmt(v: float, scale: int) -> str:
    return str(int(v)) if scale > 1 else format(v, "g")


def save_model(model: MarkovModel, path: str, output_states: bool = True,
               delim: str = ",") -> None:
    lines: List[str] = []
    if output_states:
        lines.append(delim.join(model.states))
    if model.class_trans is not None:
        for label, mat in model.class_trans.items():
            lines.append(f"classLabel:{label}")
            for row in mat:
                lines.append(delim.join(_fmt(v, model.scale) for v in row))
    else:
        for row in model.trans:
            lines.append(delim.join(_fmt(v, model.scale) for v in row))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_model(path: str, class_label_based: bool = False,
               scale: int = 1000, delim: str = ",") -> MarkovModel:
    """Parse the MarkovModel.java:38-63 line layout (first line = states)."""
    with open(path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.strip()]
    states = lines[0].split(delim)
    n = len(states)
    pos = 1
    if class_label_based:
        class_trans: Dict[str, np.ndarray] = {}
        while pos < len(lines):
            if lines[pos].startswith("classLabel"):
                label = lines[pos].split(":")[1]
                pos += 1
                mat = np.asarray(
                    [[float(v) for v in lines[pos + i].split(delim)]
                     for i in range(n)])
                pos += n
                class_trans[label] = mat
            else:
                pos += 1
        return MarkovModel(states=states, scale=scale,
                           class_trans=class_trans)
    mat = np.asarray([[float(v) for v in lines[pos + i].split(delim)]
                      for i in range(n)])
    return MarkovModel(states=states, scale=scale, trans=mat)


# --------------------------------------------------------------------------
# classify
# --------------------------------------------------------------------------

def _row_sum(vals: torch.Tensor) -> torch.Tensor:
    """f32 sums of the rows of [B, n] ``vals`` in one fixed order, the
    same on every device: in sequence below 16 terms; from 16 on, eight
    partial sums over the whole groups of eight, folded in halves (lanes
    0-3 + 4-7, then 0-1 + 2-3, then 0 + 1), then the rest in sequence.
    This is the order XLA's CPU backend sums such a row in, measured
    equal for n ≤ 19 and 24 ≤ n ≤ 32 (sequences of up to 33 states, the
    tutorials' 5-30 among them); other n round in another order, within
    f32 rounding of the same terms."""
    n = vals.shape[1]
    acc = torch.zeros_like(vals[:, 0])
    if n < 16:
        for t in range(n):
            acc = acc + vals[:, t]
        return acc
    whole = (n // 8) * 8
    lanes = torch.zeros_like(vals[:, :8])
    for v in range(0, whole, 8):
        lanes = lanes + vals[:, v:v + 8]
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    acc = lanes[:, 0]
    for t in range(whole, n):
        acc = acc + vals[:, t]
    return acc


def log_odds(seqs: torch.Tensor, lengths: torch.Tensor,
             log_ratio: torch.Tensor) -> torch.Tensor:
    """Σ_t log(P0[s_{t-1},s_t] / P1[...]) per sequence — one gather and a
    sum over time, in f32."""
    src, dst = seqs[:, :-1].long(), seqs[:, 1:].long()
    pos = torch.arange(src.shape[1], device=seqs.device)[None, :]
    mask = (pos + 1 < lengths[:, None]).to(torch.float32)
    return _row_sum(log_ratio[src, dst] * mask)


def classify(model: MarkovModel, sequences: Sequence[Sequence[str]],
             class_labels: Tuple[str, str], device: DeviceLike = "cuda"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(predicted labels, f32 log odds). Positive log-odds ->
    class_labels[0] (MarkovModelClassifier.java:130-144)."""
    seqs, lengths = encode_sequences(sequences, model.states, device)
    return classify_encoded(model, seqs, lengths, class_labels)


def classify_encoded(model: MarkovModel, seqs: torch.Tensor,
                     lengths: torch.Tensor, class_labels: Tuple[str, str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``classify`` on sequences already encoded (``encode_sequences``)."""
    if model.class_trans is None:
        raise ValueError("classification needs a class-label-based model")
    m0 = np.maximum(model.class_trans[class_labels[0]], 1e-12)
    m1 = np.maximum(model.class_trans[class_labels[1]], 1e-12)
    log_ratio = torch.from_numpy(np.log(m0 / m1).astype(np.float32)) \
        .to(seqs.device)
    odds = log_odds(seqs, lengths, log_ratio).cpu().numpy()
    pred = np.where(odds > 0, class_labels[0], class_labels[1])
    return pred, odds


def validate(pred: np.ndarray, truth: Sequence[str],
             class_labels: Sequence[str],
             positive_class: Optional[str] = None) -> ConfusionMatrix:
    cm = ConfusionMatrix(list(class_labels), positive_class=positive_class)
    index = {v: i for i, v in enumerate(class_labels)}
    cm.update(np.asarray([index[p] for p in pred]),
              np.asarray([index[t] for t in truth]))
    return cm


# --------------------------------------------------------------------------
# transaction-history states + next-state prediction
# (the email-marketing tutorial's pre/post stages, resource/xaction_state.rb
# and resource/mark_plan.rb)
# --------------------------------------------------------------------------

#: the tutorial's 9 two-letter states: (days-gap S/M/L) x (amount L/E/G)
XACTION_STATES = ["SL", "SE", "SG", "ML", "ME", "MG", "LL", "LE", "LG"]


def transaction_states(history: Sequence[Tuple[int, float]]) -> List[str]:
    """Encode one customer's ordered (day, amount) purchase history as the
    tutorial's two-letter state sequence (resource/xaction_state.rb:12-45):
    first letter = days since previous purchase (<30 S, <60 M, else L),
    second = previous amount vs current (prev < 0.9*amt L, < 1.1*amt E,
    else G). ``day`` is any absolute day number (date ordinal)."""
    seq: List[str] = []
    for (pr_day, pr_amt), (day, amt) in zip(history, history[1:]):
        days_diff = day - pr_day
        dd = "S" if days_diff < 30 else ("M" if days_diff < 60 else "L")
        if pr_amt < 0.9 * amt:
            ad = "L"
        elif pr_amt < 1.1 * amt:
            ad = "E"
        else:
            ad = "G"
        seq.append(dd + ad)
    return seq


def next_states(model: MarkovModel, last_states: Sequence[str],
                device: DeviceLike = "cuda") -> List[str]:
    """Most likely next state per customer given their latest state — the
    argmax over the state's f32 transition row, first index on ties
    (resource/mark_plan.rb:75-81, which the tutorial maps to the optimum
    marketing contact time)."""
    if model.trans is None:
        raise ValueError("next-state prediction needs a global model")
    dev = resolve_device(device)
    index = {s: i for i, s in enumerate(model.states)}
    rows = torch.tensor([index[s] for s in last_states], dtype=torch.long,
                        device=dev)
    trans = torch.from_numpy(np.asarray(model.trans, np.float32)).to(dev)
    best = torch.argmax(trans[rows], dim=1).cpu().numpy()
    return [model.states[i] for i in best]
