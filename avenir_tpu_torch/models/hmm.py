"""Hidden Markov model: builder + Viterbi predictor.

Counterpart of ``avenir_tpu/models/hmm.py`` (``HmmModel``,
``train_fully_tagged``, ``train_partially_tagged``, ``_normalize``,
``_encode_padded_batch``, Baum-Welch: ``_bw_em_iter``, the chunked and the
single-dispatch paths, ``ll_converged``, ``train_baum_welch``;
``save_model``, ``load_model``, ``_log_params``, ``predict_states``), for
one device. The reference's HiddenMarkovModelBuilder MR
(src/main/java/org/avenir/markov/HiddenMarkovModelBuilder.java):

- **fully tagged** rows of ``obs:state`` pairs (:136-166) and **partially
  tagged** rows (:174-260, each observation between two states attributed
  to the nearest state with a decaying ``window.function`` weight, the
  evident intent of the reference's window arithmetic) are counted on the
  host, as the JAX package counts them.
- **untagged** rows train by Baum-Welch EM on the device: a log-space
  forward-backward over the padded ``[B, T]`` batch, as plain torch ops,
  in either of the JAX package's two E-step forms (2T sequential ``[B, S]``
  steps, or associative scans over (logsumexp, +) matrices, for
  ``B·S ≤ 65,536``). XLA's CPU ``exp`` and ``log`` are not torch's, and
  the associative scan combines in another order than JAX's, so the
  log-likelihoods and parameters agree with the JAX package's within
  rounding, not bit for bit.
- the model text format (HiddenMarkovModel.java:46-70): line 1 states,
  line 2 observations, S transition rows, S emission rows, 1 initial row.
- **ViterbiStatePredictor** (:114-142): ``ops/scanops.viterbi_batch``, bit
  for bit the JAX package's paths; output keeps the reference's reversed
  (latest-first) state order.

The sequence-parallel entry points (``score_long``,
``predict_states_long``) and ``train_baum_welch(mesh=...)`` belong to the
multi-device layer, which this port does not carry yet: they raise.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.scanops import (
    associative_scan, lseplus, lseplus_eye, viterbi_batch)
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.roadmap import roadmap_item
from avenir_tpu_torch.utils.tables import laplace_and_scale

_MULTI = (f"the multi-device layer ({roadmap_item('Multi-device layer')}) "
          "ports the sequence-parallel HMM paths")


@dataclass
class HmmModel:
    states: List[str]
    observations: List[str]
    trans: np.ndarray        # [S, S]
    emit: np.ndarray         # [S, O]
    initial: np.ndarray      # [S]
    scale: int = 1


# --------------------------------------------------------------------------
# builder
# --------------------------------------------------------------------------

def train_fully_tagged(rows: Sequence[Sequence[str]], states: List[str],
                       observations: List[str], sub_field_delim: str = ":",
                       scale: int = 1, skip_field_count: int = 0) -> HmmModel:
    """Rows of ``obs:state`` tokens -> counts -> normalized model."""
    s_idx = {s: i for i, s in enumerate(states)}
    o_idx = {o: i for i, o in enumerate(observations)}
    n_s, n_o = len(states), len(observations)
    trans = np.zeros((n_s, n_s))
    emit = np.zeros((n_s, n_o))
    initial = np.zeros(n_s)
    for row in rows:
        pairs = [t.split(sub_field_delim) for t in row[skip_field_count:]]
        if not pairs:
            continue
        initial[s_idx[pairs[0][1]]] += 1
        prev = None
        for obs, state in pairs:
            emit[s_idx[state], o_idx[obs]] += 1
            if prev is not None:
                trans[s_idx[prev], s_idx[state]] += 1
            prev = state
    return _normalize(states, observations, trans, emit, initial, scale)


def train_partially_tagged(rows: Sequence[Sequence[str]], states: List[str],
                           observations: List[str],
                           window_function: Sequence[int],
                           scale: int = 1) -> HmmModel:
    """Rows mixing observations and occasional state tokens; observations
    within half the gap of a state count toward it with window weights."""
    s_idx = {s: i for i, s in enumerate(states)}
    o_idx = {o: i for i, o in enumerate(observations)}
    wf = list(window_function)
    n_s, n_o = len(states), len(observations)
    trans = np.zeros((n_s, n_s))
    emit = np.zeros((n_s, n_o))
    initial = np.zeros(n_s)

    for row in rows:
        state_pos = [i for i, t in enumerate(row) if t in s_idx]
        if not state_pos:
            continue
        initial[s_idx[row[state_pos[0]]]] += 1
        for k in range(len(state_pos) - 1):
            trans[s_idx[row[state_pos[k]]], s_idx[row[state_pos[k + 1]]]] += 1
        for k, p in enumerate(state_pos):
            left_gap = (p - state_pos[k - 1]) // 2 if k > 0 else None
            right_gap = ((state_pos[k + 1] - p) // 2
                         if k < len(state_pos) - 1 else None)
            if left_gap is None and right_gap is None:
                # single state: reference bounds are leftBound=p/2 (inclusive)
                # and rightBound=p+(len-1-p)/2, i.e. ceil(p/2) obs on the left
                left_gap = p - p // 2
                right_gap = (len(row) - 1 - p) // 2
            elif left_gap is None:
                left_gap = min(right_gap, p)
            elif right_gap is None:
                right_gap = min(left_gap, len(row) - 1 - p)
            state = s_idx[row[p]]
            for w, j in enumerate(range(p - 1, max(p - 1 - left_gap, -1), -1)):
                if row[j] in o_idx:
                    emit[state, o_idx[row[j]]] += wf[min(w, len(wf) - 1)]
            for w, j in enumerate(range(p + 1,
                                        min(p + 1 + right_gap, len(row)))):
                if row[j] in o_idx:
                    emit[state, o_idx[row[j]]] += wf[min(w, len(wf) - 1)]
    return _normalize(states, observations, trans, emit, initial, scale)


def _normalize(states, observations, trans, emit, initial, scale) -> HmmModel:
    trans_n = laplace_and_scale(trans, scale)
    emit_n = laplace_and_scale(emit, scale)
    init_n = laplace_and_scale(initial[None, :], scale)[0]
    return HmmModel(states=list(states), observations=list(observations),
                    trans=trans_n, emit=emit_n, initial=init_n, scale=scale)


def _encode_padded_batch(obs_rows: Sequence[Sequence[str]],
                         observations: Sequence[str]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Observation rows -> (padded [B, T>=2] int32 codes, lengths), with a
    clear error for tokens outside the vocabulary."""
    o_idx = {o: i for i, o in enumerate(observations)}
    t_max = max((len(r) for r in obs_rows), default=1)
    batch = np.zeros((len(obs_rows), max(t_max, 2)), np.int32)
    lengths = np.zeros(len(obs_rows), np.int32)
    for b, row in enumerate(obs_rows):
        try:
            codes = [o_idx[o] for o in row]
        except KeyError as exc:
            raise ValueError(
                f"observation {exc.args[0]!r} (row {b}) is not in the "
                f"model's observation vocabulary") from None
        batch[b, :len(codes)] = codes
        lengths[b] = len(codes)
    return batch, lengths


# --------------------------------------------------------------------------
# unsupervised training: Baum-Welch EM
# --------------------------------------------------------------------------

def _bw_em_iter(obs: torch.Tensor, lengths: torch.Tensor,
                seq_w: torch.Tensor, eps: torch.Tensor, n_states: int,
                n_obs: int):
    """The ONE-EM-iteration function ``em_iter(li, lt, le) -> ((li', lt',
    le'), total weighted LL under the input parameters)`` that both
    EM paths run, so the two cannot drift numerically.

    E-step: log-space forward-backward over the padded [B, T] batch with
    length masks; ``seq_w`` is a per-sequence weight folded into every
    expected count and the LL; ``eps`` the M-step count smoothing. The
    form is the JAX package's choice: associative scans over (logsumexp,
    +) matrices for small batches (``B·S ≤ 65,536``), 2T sequential
    ``[B, S]`` steps above."""
    bsz, t_max = obs.shape
    dev = obs.device
    obs = obs.long()
    lengths = lengths.long()
    t_iota = torch.arange(t_max, device=dev)
    NEG = -1e30
    use_assoc = bsz * n_states <= 65536
    valid = t_iota[None, :] < lengths[:, None]                   # [B, T]
    xi_valid = (t_iota[None, :] + 1 < lengths[:, None])[:, :, None, None]
    oh_o = torch.nn.functional.one_hot(obs, n_obs).to(torch.float32)
    rows = torch.arange(bsz, device=dev)

    def e_step_assoc(li, lt, le):
        """Step 0's matrix is the rank-1 broadcast of alpha0 and steps
        past a row's length are the semiring identity, so prefixes freeze
        at la[n-1] and suffix products of padding collapse to identity:
        ragged lengths are exact."""
        emit_t = le.t()                                          # [O, S]
        ident = lseplus_eye(n_states, device=dev)
        mats = lt[None, None, :, :] + emit_t[obs][:, :, None, :]  # [B,T,S,S]
        alpha0 = li[None, :] + emit_t[obs[:, 0]]                 # [B, S]
        mats[:, 0] = alpha0[:, None, :].expand(bsz, n_states, n_states)
        mats = torch.where(valid[:, :, None, None], mats, ident)
        prefix = associative_scan(lseplus, mats, dim=1)          # [B,T,S,S]
        la = prefix[:, :, 0, :]                                  # [B, T, S]
        ll = torch.logsumexp(la[:, -1], dim=-1)
        # suffix products M_t^T ∘ … : the transposes scanned in reverse,
        # the row-reduction read off axis -2
        suffix_t = associative_scan(lseplus, mats.transpose(-1, -2), dim=1,
                                    reverse=True)
        lb = torch.cat([torch.logsumexp(suffix_t[:, 1:], dim=-2),
                        torch.zeros((bsz, 1, n_states), device=dev)], dim=1)
        return la, lb, ll

    def e_step_seq(li, lt, le):
        emit_t = le.t()
        la_prev = torch.full((bsz, n_states), NEG, device=dev)
        las = []
        for t in range(t_max):
            if t == 0:
                la_t = li[None, :] + emit_t[obs[:, 0]]
            else:
                la_t = (torch.logsumexp(la_prev[:, :, None]
                                        + lt[None, :, :], dim=1)
                        + emit_t[obs[:, t]])
            la_t = torch.where(valid[:, t:t + 1], la_t, la_prev)
            las.append(la_t)
            la_prev = la_t
        la = torch.stack(las, dim=1)
        ll = torch.logsumexp(la[rows, lengths - 1], dim=-1)
        lb_next = torch.zeros((bsz, n_states), device=dev)
        lbs = [lb_next] * t_max
        last = (lengths - 1)[:, None]
        for t in range(t_max - 1, -1, -1):
            o_next = obs[:, min(t + 1, t_max - 1)]
            lb_t = torch.where(
                t >= last, torch.zeros_like(lb_next),
                torch.logsumexp(lt[None, :, :] + emit_t[o_next][:, None, :]
                          + lb_next[:, None, :], dim=2))
            lbs[t] = lb_t
            lb_next = lb_t
        return la, torch.stack(lbs, dim=1), ll

    def em_iter(li, lt, le):
        la, lb, ll = (e_step_assoc if use_assoc else e_step_seq)(li, lt, le)
        lgamma = la + lb - ll[:, None, None]                     # [B, T, S]
        gamma = torch.where(valid[:, :, None], torch.exp(lgamma),
                            torch.zeros((), device=dev))
        # transitions: xi_t = P(q_t=i, q_{t+1}=j | o) for t+1 < n
        emit_t = le.t()
        o_next = torch.roll(obs, -1, dims=1)
        lb_next = torch.roll(lb, -1, dims=1)
        lxi = (la[:, :, :, None] + lt[None, None, :, :]
               + emit_t[o_next][:, :, None, :] + lb_next[:, :, None, :]
               - ll[:, None, None, None])
        xi = torch.where(xi_valid, torch.exp(lxi), torch.zeros((), device=dev))
        a_counts = xi.sum(dim=1)                                 # [B, S, S]
        b_counts = torch.einsum("bts,bto->bso", gamma, oh_o)     # [B, S, O]
        init_counts = gamma[:, 0]
        a_sum = (a_counts * seq_w[:, None, None]).sum(dim=0) + eps
        b_sum = (b_counts * seq_w[:, None, None]).sum(dim=0) + eps
        i_sum = (init_counts * seq_w[:, None]).sum(dim=0) + eps
        lt_new = torch.log(a_sum / a_sum.sum(dim=1, keepdim=True))
        le_new = torch.log(b_sum / b_sum.sum(dim=1, keepdim=True))
        li_new = torch.log(i_sum / i_sum.sum())
        return (li_new, lt_new, le_new), (ll * seq_w).sum()

    return em_iter


def _baum_welch_chunk(em_iter, li, lt, le, n_iters: int):
    """A chunk of ``n_iters`` EM iterations with no readback (the
    checkpointing path: the host checks convergence and writes a
    checkpoint between chunks). Returns (li, lt, le, [n_iters] f32 LL
    history)."""
    lls = []
    for _ in range(n_iters):
        (li, lt, le), ll = em_iter(li, lt, le)
        lls.append(ll)
    return li, lt, le, torch.stack(lls)


def _baum_welch_while(em_iter, li, lt, le, ll_rel_tol: torch.Tensor,
                      max_iters: int):
    """EM to convergence: the :func:`ll_converged` test in f32 on the
    device after every iteration, read back with one ``.item()``, as the
    JAX package's while-loop runs it; a negative ``ll_rel_tol`` disables
    the early stop and the loop runs exactly ``max_iters``. Returns (li,
    lt, le, [iterations run] f32 LL history)."""
    lls = []
    armed = float(ll_rel_tol) >= 0
    one = torch.ones((), device=ll_rel_tol.device)
    while len(lls) < max_iters:
        (li, lt, le), ll = em_iter(li, lt, le)
        lls.append(ll)
        if armed and len(lls) >= 2:
            gain = torch.abs(lls[-1] - lls[-2])
            if bool((gain <= ll_rel_tol * torch.maximum(one, torch.abs(ll)))
                    .item()):
                break
    return li, lt, le, torch.stack(lls)


def ll_converged(hist: Sequence[float], ll_rel_tol: float) -> bool:
    """The ONE tolerance test: per-iteration LL gain at/below
    ``ll_rel_tol * max(1, |LL|)`` — used by the training loop's early stop
    and by callers reporting convergence, so the two cannot drift apart."""
    return len(hist) >= 2 and abs(hist[-1] - hist[-2]) <= (
        ll_rel_tol * max(1.0, abs(hist[-1])))


def data_fingerprint(batch: np.ndarray, lengths: np.ndarray,
                     observations: Sequence[str], n_states: int) -> str:
    """sha256 of (padded int32 batch, lengths, vocabulary, state count):
    the JAX package's fingerprint bytes, so a checkpoint resumes in
    either package, and only on the data and configuration it was
    written for."""
    fp = hashlib.sha256()
    fp.update(batch.tobytes())
    fp.update(np.asarray(lengths).tobytes())
    fp.update(repr(list(observations)).encode())
    fp.update(str(n_states).encode())
    return fp.hexdigest()


def train_baum_welch(obs_rows: Sequence[Sequence[str]],
                     observations: List[str], n_states: int, *,
                     n_iters: int = 50, seed: int = 0, scale: int = 1,
                     state_names: Optional[List[str]] = None,
                     smoothing: float = 1e-4,
                     ll_rel_tol: Optional[float] = None,
                     chunk_size: int = 10,
                     mesh=None, axis_name: str = "data",
                     checkpoint_path: Optional[str] = None,
                     device: DeviceLike = "cuda"
                     ) -> Tuple[HmmModel, np.ndarray]:
    """Unsupervised HMM training by Baum-Welch EM on ``device``. Returns
    the model (states ``s0..s{K-1}`` unless named) and the per-iteration
    total log-likelihood, which EM keeps non-decreasing.

    Initialization draws from ``np.random.default_rng(seed)`` as the JAX
    package does, so both start from the same parameters. Without a
    ``checkpoint_path`` the tolerance test (``ll_rel_tol``) runs after
    every iteration and ``len(ll_hist) <= n_iters`` exactly. With one,
    iterations run in chunks of ``chunk_size`` (the last clamped to the
    budget); after each chunk the host writes the log-parameters and LL
    history atomically (``.npz`` keys ``li``, ``lt``, ``le``, ``ll``,
    ``data_fp``) and checks convergence, and a restart over the same
    path and data continues from the saved iteration. The file is the
    JAX package's, so a checkpoint crosses between the two packages."""
    if mesh is not None:
        raise ValueError(f"train_baum_welch(mesh=...) is not supported by "
                         f"avenir_tpu_torch yet: {_MULTI}")
    if n_states < 1:
        raise ValueError("n_states must be >= 1")
    if state_names is not None and len(state_names) != n_states:
        raise ValueError(
            f"{len(state_names)} state names for {n_states} states")
    if not smoothing > 0:
        # eps=0 turns an unreached state's M-step into log(0/0) = NaN
        raise ValueError(f"smoothing must be > 0, got {smoothing}")
    empties = [b for b, r in enumerate(obs_rows) if len(r) == 0]
    if empties:
        raise ValueError(
            f"zero-length observation rows (e.g. row {empties[0]}) cannot "
            f"be trained on; drop them before calling train_baum_welch")
    dev = resolve_device(device)
    batch, lengths = _encode_padded_batch(obs_rows, observations)

    rng = np.random.default_rng(seed)

    # random row-stochastic init breaks the label symmetry
    def rand_log_stochastic(shape):
        m = rng.dirichlet(np.ones(shape[-1]) * 3.0, size=shape[:-1])
        return np.log(np.maximum(m, 1e-8)).astype(np.float32)

    li0 = rand_log_stochastic((n_states,)) if n_states > 1 else (
        np.zeros((1,), np.float32))
    lt0 = rand_log_stochastic((n_states, n_states))
    le0 = rand_log_stochastic((n_states, len(observations)))
    data_fp = data_fingerprint(batch, lengths, observations, n_states)

    hist: list = []
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            if str(ck["data_fp"]) != data_fp:
                warnings.warn(
                    f"checkpoint {checkpoint_path} belongs to different "
                    "data/config (fingerprint mismatch); training fresh",
                    stacklevel=2)
            else:
                li0, lt0, le0 = (np.asarray(ck[k], np.float32)
                                 for k in ("li", "lt", "le"))
                hist = np.asarray(ck["ll"], np.float64).tolist()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    em_iter = _bw_em_iter(put(batch), put(lengths),
                          torch.ones(len(batch), device=dev),
                          torch.tensor(smoothing, dtype=torch.float32,
                                       device=dev),
                          n_states, len(observations))
    li, lt, le = put(li0), put(lt0), put(le0)

    def save_checkpoint():
        # .npz suffix keeps np.savez from appending one; replace is atomic
        tmp = f"{checkpoint_path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, li=li.cpu().numpy(), lt=lt.cpu().numpy(),
                 le=le.cpu().numpy(), ll=np.asarray(hist, np.float64),
                 data_fp=data_fp)
        os.replace(tmp, checkpoint_path)

    if checkpoint_path is None:
        budget = n_iters - len(hist)
        if budget > 0 and not (ll_rel_tol is not None
                               and ll_converged(hist, ll_rel_tol)):
            tol = torch.tensor(-1.0 if ll_rel_tol is None else ll_rel_tol,
                               dtype=torch.float32, device=dev)
            li, lt, le, ll_h = _baum_welch_while(em_iter, li, lt, le, tol,
                                                 budget)
            hist.extend(ll_h.cpu().numpy().astype(np.float64).tolist())
    else:
        chunk = max(1, min(chunk_size, n_iters))
        while len(hist) < n_iters and not (
                ll_rel_tol is not None and ll_converged(hist, ll_rel_tol)):
            take = min(chunk, n_iters - len(hist))
            li, lt, le, ll_c = _baum_welch_chunk(em_iter, li, lt, le, take)
            hist.extend(ll_c.cpu().numpy().astype(np.float64).tolist())
            save_checkpoint()
    ll_hist = np.asarray(hist)
    li, lt, le = (t.cpu().numpy() for t in (li, lt, le))

    states = state_names or [f"s{i}" for i in range(n_states)]
    if scale > 1:
        trans = np.rint(np.exp(lt) * scale)
        emit = np.rint(np.exp(le) * scale)
        initial = np.rint(np.exp(li) * scale)
    else:
        trans, emit, initial = np.exp(lt), np.exp(le), np.exp(li)
    model = HmmModel(states=list(states), observations=list(observations),
                     trans=trans, emit=emit, initial=initial, scale=scale)
    return model, ll_hist


# --------------------------------------------------------------------------
# wire format (states / observations / S trans rows / S emit rows / initial)
# --------------------------------------------------------------------------

def save_model(model: HmmModel, path: str, delim: str = ",") -> None:
    fmt = (lambda v: str(int(v))) if model.scale > 1 else (
        lambda v: format(v, "g"))
    lines = [delim.join(model.states), delim.join(model.observations)]
    for row in model.trans:
        lines.append(delim.join(fmt(v) for v in row))
    for row in model.emit:
        lines.append(delim.join(fmt(v) for v in row))
    lines.append(delim.join(fmt(v) for v in model.initial))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_model(path: str, scale: int = 1, delim: str = ",") -> HmmModel:
    with open(path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.strip()]
    states = lines[0].split(delim)
    observations = lines[1].split(delim)
    n_s = len(states)
    parse = lambda line: [float(v) for v in line.split(delim)]  # noqa: E731
    trans = np.asarray([parse(lines[2 + i]) for i in range(n_s)])
    emit = np.asarray([parse(lines[2 + n_s + i]) for i in range(n_s)])
    initial = np.asarray(parse(lines[2 + 2 * n_s]))
    return HmmModel(states=states, observations=observations, trans=trans,
                    emit=emit, initial=initial, scale=scale)


# --------------------------------------------------------------------------
# Viterbi prediction
# --------------------------------------------------------------------------

def _log_params(model: HmmModel, device: DeviceLike = "cuda"):
    """(log initial, log trans, log emit) as float32 tensors on
    ``device``, un-scaled and floored at 1e-12 to keep log finite (the
    logs taken in float64 on the host, as the JAX package takes them)."""
    dev = resolve_device(device)
    norm = float(model.scale) if model.scale > 1 else 1.0

    def safe_log(m):
        return torch.from_numpy(np.log(np.maximum(m / norm, 1e-12))
                                .astype(np.float32)).to(dev)

    return safe_log(model.initial), safe_log(model.trans), safe_log(model.emit)


def predict_states(model: HmmModel, obs_rows: Sequence[Sequence[str]],
                   reversed_output: bool = True, device: DeviceLike = "cuda"
                   ) -> List[List[str]]:
    """Most-likely state path per observation row; ``reversed_output``
    keeps the reference's latest-state-first emission
    (ViterbiStatePredictor.java:136-140)."""
    batch, lengths = _encode_padded_batch(obs_rows, model.observations)
    li, lt, le = _log_params(model, device)
    paths, _scores = viterbi_batch(li, lt, le,
                                   torch.from_numpy(batch).to(li.device),
                                   torch.from_numpy(lengths).to(li.device))
    paths = paths.cpu().numpy()
    out = []
    for b, row in enumerate(obs_rows):
        seq = [model.states[s] for s in paths[b, :len(row)]]
        out.append(seq[::-1] if reversed_output else seq)
    return out


def score_long(model: HmmModel, obs_row: Sequence[str], *, mesh,
               axis_name: str = "data") -> float:
    """log P(observations) of one long sequence with its time axis sharded
    across a device mesh: not carried by this port yet."""
    raise ValueError(f"score_long is not supported by avenir_tpu_torch yet: "
                     f"{_MULTI}")


def predict_states_long(model: HmmModel, obs_row: Sequence[str], *, mesh,
                        axis_name: str = "data") -> List[str]:
    """The Viterbi path of one long sequence with its time axis sharded
    across a device mesh: not carried by this port yet."""
    raise ValueError(f"predict_states_long is not supported by "
                     f"avenir_tpu_torch yet: {_MULTI}")
