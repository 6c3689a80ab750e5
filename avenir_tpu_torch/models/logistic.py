"""Logistic regression with a resumable coefficient-history file.

Counterpart of ``avenir_tpu/models/logistic.py`` (``LogisticConfig``,
``converged``, ``_coeff_diff_percent``, ``load_coefficients``,
``append_coefficients``, ``train``, ``predict_proba``, ``predict``). The
reference's LogisticRegressionJob (src/main/java/org/avenir/regress/
LogisticRegressionJob.java) is an iterative MR: mappers accumulate the
gradient Σ xᵢ·(y − σ(w·x)), one reducer sums and **appends the new
coefficient row to coeff.file.path** (:238-255), and the driver reruns
until converged; restarts resume from the file's last line (:154-160).
As in the JAX package, the step is a correct ascent step
``w ← w + lr·∇/N`` (the reference stored the raw gradient; SURVEY.md
§2.7).

Two loops, chosen by the convergence threshold as the JAX package
chooses them:

- **the f32 device loop**: ``_ITER_CHUNK`` ascent steps on the device
  per host round trip, the ``[16, D]`` trajectory brought back once a
  chunk. The logits and the gradient are float64 sums of exact f32
  products in a fixed order (the features in turn; the rows, padded to a
  power of two, in a halving tree), each rounded to f32 once, so the
  card's bits equal the CPU's;
  the sigmoid is XLA's (``infotheory.xla_sigmoid``) and the update one
  fused multiply-add, as the JAX package's compiled chunk has them. JAX's
  f32 products sum in Eigen's order, so the coefficients differ from its
  in the last bits (ROADMAP queue C);
- **the float64 host loop** (thresholds under
  ``_F64_FALLBACK_THRESHOLD``): numpy, copied, byte-identical.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.infotheory import fma, xla_sigmoid


@dataclass(frozen=True)
class LogisticConfig:
    learning_rate: float = 0.5         # learning.rate (new; reference lacked)
    max_iterations: int = 100          # iteration.limit
    convergence_threshold: float = 1.0  # convergence threshold (percent)
    convergence_criteria: str = "average"  # all | average
    add_intercept: bool = True


_ITER_CHUNK = 16   # gradient steps per device dispatch
# below this percent-relative threshold float32 iterates hit their fixed
# point before the test can pass; use the float64 host loop instead
_F64_FALLBACK_THRESHOLD = 1e-4


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """float64 sum over the last axis, whose length is a power of two, in
    a fixed order: the halves added elementwise until one element is left,
    so every device rounds alike."""
    while t.shape[-1] > 1:
        half = t.shape[-1] // 2
        t = t[..., :half] + t[..., half:]
    return t[..., 0]


def _feature_major(xp: torch.Tensor) -> torch.Tensor:
    """The f32 rows as a ``[D, P]`` float64 tensor, features leading and
    the rows padded with zeros to a power of two: a padded row's products
    are exact zeros, so it adds nothing to the gradient."""
    n, d = xp.shape
    p = 1 << max(n - 1, 0).bit_length()
    x64 = torch.zeros((d, p), dtype=torch.float64, device=xp.device)
    x64[:, :n] = xp.T
    return x64


def _logits(x64: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w`` of feature-major ``x64``: the exact products summed
    over the features in order, in float64, rounded once."""
    w64 = w.double()
    acc = x64[0] * w64[0]
    for j in range(1, x64.shape[0]):
        acc = acc + x64[j] * w64[j]
    return acc.float()


def _gradient(x64: torch.Tensor, y: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """f32 Σ_n x_n (y_n − σ(w·x_n)): the residual in f32 as the JAX
    package's fusion computes it, the exact products summed over the rows
    in float64 (``_tree_sum``)."""
    resid = (y - xla_sigmoid(_logits(x64, w))).double()
    return _tree_sum(x64 * resid).float()


def _train_chunk(x64: torch.Tensor, y: torch.Tensor, w0: torch.Tensor,
                 step_scale: torch.Tensor) -> torch.Tensor:
    """``_ITER_CHUNK`` ascent steps on the device over feature-major rows
    (``_feature_major``, ``y`` padded alike); returns the
    ``[_ITER_CHUNK, D]`` f32 trajectory. The host truncates the tail
    chunk."""
    w = w0
    traj = []
    for _ in range(_ITER_CHUNK):
        w = fma(step_scale, _gradient(x64, y, w), w)
        traj.append(w)
    return torch.stack(traj)


def _coeff_diff_percent(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """|new − old|·100/|old| (LogisticRegressor.setCoefficientDiff :107-113)."""
    denom = np.where(np.abs(old) > 1e-12, np.abs(old), 1e-12)
    return np.abs(new - old) * 100.0 / denom


def converged(new: np.ndarray, old: np.ndarray, cfg: LogisticConfig) -> bool:
    diff = _coeff_diff_percent(new, old)
    if cfg.convergence_criteria == "all":
        return bool((diff <= cfg.convergence_threshold).all())
    return bool(diff.mean() <= cfg.convergence_threshold)


def _prepare(x: torch.Tensor, cfg: LogisticConfig) -> torch.Tensor:
    x = x.to(torch.float32)
    if cfg.add_intercept:
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([ones, x], dim=1)
    return x


def load_coefficients(path: str, n_coeffs: int,
                      delim: str = ",") -> Tuple[np.ndarray, int]:
    """Resume from the history file's last line (reference :154-160).
    Returns (coefficients, completed iterations)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return np.zeros(n_coeffs), 0
    with open(path) as fh:
        lines = [l.strip() for l in fh if l.strip()]
    if not lines:
        return np.zeros(n_coeffs), 0
    return np.asarray([float(v) for v in lines[-1].split(delim)]), len(lines)


def append_coefficients(path: str, w: np.ndarray, delim: str = ",") -> None:
    with open(path, "a") as fh:
        fh.write(delim.join(repr(float(v)) for v in w) + "\n")


def train(x: torch.Tensor, y: torch.Tensor, cfg: LogisticConfig,
          coeff_file_path: Optional[str] = None
          ) -> Tuple[np.ndarray, int, bool]:
    """Outer driver loop (host) around the device steps, on ``x``'s
    device.

    Returns (coefficients, iterations run, converged?). With
    ``coeff_file_path`` each iteration appends to the history file and a
    restart resumes from its last line — the reference's checkpoint
    contract.
    """
    xp = _prepare(x, cfg)
    yp = y.to(torch.float32)
    n, d = xp.shape
    w = np.zeros(d)
    start_iter = 0
    if coeff_file_path:
        w, start_iter = load_coefficients(coeff_file_path, d)

    is_converged = False
    it = start_iter

    if cfg.convergence_threshold < _F64_FALLBACK_THRESHOLD:
        # float64 host loop: the reference's Java-double resolution for
        # thresholds float32 iterates cannot resolve
        xh = xp.cpu().numpy().astype(np.float64)
        yh = yp.cpu().numpy().astype(np.float64)
        scale = cfg.learning_rate / n
        while it < cfg.max_iterations and not is_converged:
            logits = np.clip(xh @ w, -500.0, 500.0)
            new_w = w + scale * (xh.T @ (yh - 1.0 / (1.0 + np.exp(-logits))))
            it += 1
            if coeff_file_path:
                append_coefficients(coeff_file_path, new_w)
            if it > 1 and converged(new_w, w, cfg):
                is_converged = True
            w = new_w
        return w, it, is_converged

    x64 = _feature_major(xp)
    y_pad = torch.zeros(x64.shape[1], dtype=torch.float32, device=xp.device)
    y_pad[:n] = yp
    step_scale = torch.tensor(np.float32(cfg.learning_rate / n),
                              device=xp.device)
    while it < cfg.max_iterations and not is_converged:
        k = min(_ITER_CHUNK, cfg.max_iterations - it)
        w0 = torch.from_numpy(np.asarray(w, np.float32)).to(xp.device)
        traj = _train_chunk(x64, y_pad, w0, step_scale).cpu().numpy()[:k]
        for new_w in traj:
            it += 1
            if coeff_file_path:
                append_coefficients(coeff_file_path, new_w)
            if it > 1 and converged(new_w, w, cfg):
                w = new_w
                is_converged = True
                break
            w = new_w
    return w, it, is_converged


def predict_proba(x: torch.Tensor, w: np.ndarray,
                  cfg: LogisticConfig) -> np.ndarray:
    xp = _prepare(x, cfg)
    w_t = torch.from_numpy(np.asarray(w, np.float32)).to(xp.device)
    return xla_sigmoid(_logits(xp.T.double(), w_t)).cpu().numpy()


def predict(x: torch.Tensor, w: np.ndarray, cfg: LogisticConfig,
            threshold: float = 0.5) -> np.ndarray:
    return (predict_proba(x, w, cfg) >= threshold).astype(np.int64)
