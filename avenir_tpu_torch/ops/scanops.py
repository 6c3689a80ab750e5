"""Sequential DP as scans: Viterbi and its semiring matrix products.

Counterpart of ``avenir_tpu/ops/scanops.py`` (``maxplus``, ``maxplus_eye``,
``lseplus``, ``lseplus_eye``, ``viterbi_path``, ``viterbi_batch``,
``viterbi_scores_associative``), plus ``associative_scan``, the torch
counterpart of ``lax.associative_scan`` that the Baum-Welch E-step and
``viterbi_scores_associative`` combine with.

The reference's Viterbi is a per-row Java loop over observations
(ViterbiDecoder.java:66-105: path-prob DP + back-pointers, backtrack at
:111-143). Here it is one loop over time on the whole ``[B, S]`` batch.
Each step keeps the JAX scan's operation order — ``alpha[:, None] +
log_trans``, the max and the first-index argmax over the source axis,
then ``+ log_emit`` — and its freeze past a row's length, so the paths
and scores are the JAX package's bit for bit, on the CPU and the card
alike: f32 adds round the same everywhere, and a maximum and its first
index do not depend on the order of a reduction.

All probabilities are log-space (the reference multiplies raw
probabilities, which underflows on long sequences).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

NEG_INF = -1e30


def maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max-plus matrix product over the last two dims (batched):
    (a ⊗ b)[..., i, j] = max_k a[..., i, k] + b[..., k, j]."""
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def maxplus_eye(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The max-plus identity: 0 on the diagonal, -inf (``NEG_INF``) off
    it."""
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return torch.where(eye, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))


def lseplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(logsumexp, +) semiring matrix product over the last two dims
    (batched): (a ⊗ b)[..., i, j] = logsumexp_k a[..., i, k] + b[..., k, j]
    — the SUM-over-paths sibling of :func:`maxplus`."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


# the (logsumexp, +) identity is the same 0/-inf diagonal matrix
lseplus_eye = maxplus_eye


def associative_scan(fn: Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor],
                     elems: torch.Tensor, dim: int = 0,
                     reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``elems`` along ``dim`` with the associative
    ``fn(earlier, later)``: ``out[t] = e[0] ∘ e[1] ∘ … ∘ e[t]``, or with
    ``reverse`` ``out[t] = e[T-1] ∘ … ∘ e[t]`` (``lax.associative_scan``'s
    reverse: the scan of the reversed sequence, reversed back). Runs in
    ⌈log2 T⌉ steps, each combining every element with the one ``d``
    before it (Hillis-Steele); the association differs from JAX's
    odd-even order, so the results agree within rounding."""
    x = elems.movedim(dim, 0)
    if reverse:
        x = x.flip(0)
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], fn(x[:-d], x[d:])], dim=0)
        d *= 2
    if reverse:
        x = x.flip(0)
    return x.movedim(0, dim)


def viterbi_batch(log_init: torch.Tensor, log_trans: torch.Tensor,
                  log_emit: torch.Tensor, obs_batch: torch.Tensor,
                  lengths: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most-likely state paths for a [B, T] batch of padded observation
    sequences: log_init [S], log_trans [S, S] (src→dst), log_emit [S, O],
    obs_batch [B, T] int (padding may be any id that ``lengths`` masks).
    Returns (paths [B, T] int32 — entries past a row's length repeat its
    last state, best log-probs [B])."""
    n_states = log_init.shape[0]
    bsz, t_len = obs_batch.shape
    dev = obs_batch.device
    obs = obs_batch.long()
    lengths = lengths.to(dev)
    emit_t = log_emit.t()                                    # [O, S]
    alpha = log_init[None, :] + emit_t[obs[:, 0]]            # [B, S]
    keep = torch.arange(n_states, device=dev)[None, :].expand(bsz, n_states)
    backs = []
    for t in range(1, t_len):
        scores = alpha[:, :, None] + log_trans[None, :, :]   # [B, Sp, S]
        back = torch.argmax(scores, dim=1)                   # [B, S]
        best = torch.amax(scores, dim=1) + emit_t[obs[:, t]]
        # freeze the recursion past the true sequence length
        active = (t < lengths)[:, None]
        alpha = torch.where(active, best, alpha)
        backs.append(torch.where(active, back, keep))
    last_state = torch.argmax(alpha, dim=1)                  # [B]
    path = [last_state]
    state = last_state
    for t in range(t_len - 2, -1, -1):
        # state at t+1 -> state at t
        prev = backs[t].gather(1, state[:, None])[:, 0]
        state = torch.where(t + 1 < lengths, prev, state)
        path.append(state)
    paths = torch.stack(path[::-1], dim=1).to(torch.int32)
    return paths, torch.amax(alpha, dim=1)


def viterbi_path(log_init: torch.Tensor, log_trans: torch.Tensor,
                 log_emit: torch.Tensor, obs: torch.Tensor,
                 length: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most-likely state path for one padded observation sequence obs [T]
    (``viterbi_batch`` of one row). Returns (path [T] int32, best
    log-prob scalar)."""
    n = obs.shape[0] if length is None else int(length)
    paths, scores = viterbi_batch(
        log_init, log_trans, log_emit, obs[None, :],
        torch.tensor([n], dtype=torch.int32, device=obs.device))
    return paths[0], scores[0]


def viterbi_scores_associative(log_init: torch.Tensor,
                               log_trans: torch.Tensor,
                               log_emit: torch.Tensor, obs: torch.Tensor
                               ) -> torch.Tensor:
    """Final Viterbi scores via an associative max-plus scan over time:
    per-step matrices M_t[i,j] = trans[i,j] + emit[j, o_t] combined with
    :func:`associative_scan` (log depth over time). Returns the final [S]
    score vector (argmax = Viterbi end state)."""
    obs = obs.long()
    mats = log_trans[None, :, :] + log_emit.t()[obs[1:], None, :]
    prefix = associative_scan(maxplus, mats)                 # [T-1, S, S]
    alpha0 = log_init + log_emit[:, obs[0]]
    return torch.amax(alpha0[:, None] + prefix[-1], dim=0)
