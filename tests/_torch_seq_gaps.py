"""The largest differences between the sequence models of the JAX package
and of its port on the CPU, on the seeded inputs of
``tests/test_torch_markov.py`` and ``tests/test_torch_hmm.py``: the
classifier's log odds, the Viterbi scores, and Baum-Welch's log-likelihood
history and log-parameters after 10 iterations in both E-step forms and
both EM paths. Prints one JSON object.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/_torch_seq_gaps.py
"""

import json
import tempfile

import numpy as np
import torch

import jax.numpy as jnp

from avenir_tpu.models import hmm as JH
from avenir_tpu.models import markov as JM
from avenir_tpu.ops import scanops as JS

from avenir_tpu_torch.models import hmm as TH
from avenir_tpu_torch.models import markov as TM
from avenir_tpu_torch.ops import scanops as TS

import test_torch_hmm as HT
import test_torch_markov as MT


def odds_gaps():
    """Largest relative gap of the log odds, and the share of sums equal
    bit for bit, at sequences of up to 12, 30 and 45 states."""
    out = {}
    for max_len in (12, 30, 45):
        rows = MT._labeled(120, max_len=max_len)
        seqs, labels = [r[2:] for r in rows], [r[1] for r in rows]
        model = JM.train(seqs, MT.STATES, class_labels=labels)
        _, j = JM.classify(model, seqs, ("churn", "loyal"))
        _, t = TM.classify(model, seqs, ("churn", "loyal"), device="cpu")
        j = np.asarray(j, np.float64)
        out[f"max_len {max_len}"] = {
            "max_rel": float(np.max(np.abs(t - j) / np.abs(j))),
            "bit_identical": float(np.mean(t == j))}
    return out


def viterbi_gap():
    (jli, jlt, jle), (tli, tlt, tle) = HT._logs(
        HT._loyalty_model(JH.HmmModel))
    rows = HT._obs_rows(400)
    batch, lengths = JH._encode_padded_batch(rows, HT.TG.LOYALTY_OBSERVATIONS)
    jp, js = JS.viterbi_batch(jli, jlt, jle, jnp.asarray(batch),
                              jnp.asarray(lengths))
    tp, ts = TS.viterbi_batch(tli, tlt, tle, torch.from_numpy(batch),
                              torch.from_numpy(lengths))
    return {"paths_differ": int((tp.numpy() != np.asarray(jp)).sum()),
            "scores_max_abs": float(np.abs(ts.numpy() - np.asarray(js))
                                    .max())}


def bw_gap(j, t):
    (jm, jll), (tm, tll) = j, t
    return {"ll_max_rel": float(np.max(np.abs(tll - jll) / np.abs(jll))),
            "log_param_max_abs": max(
                float(np.abs(np.log(getattr(tm, k))
                             - np.log(getattr(jm, k))).max())
                for k in ("trans", "emit", "initial")),
            "iterations": [len(jll), len(tll)]}


def baum_welch_gaps():
    torch.set_num_threads(2)
    rows, names = HT._planted(HT.BW_SEQS)
    out = {}
    for n_states in (2, 3):
        out[f"associative, {n_states} states"] = bw_gap(
            JH.train_baum_welch(rows, names, n_states, n_iters=10, seed=1),
            TH.train_baum_welch(rows, names, n_states, n_iters=10, seed=1,
                                device="cpu"))
    with tempfile.TemporaryDirectory() as d:
        out["associative, chunked path"] = bw_gap(
            JH.train_baum_welch(rows, names, 2, n_iters=10, seed=2,
                                chunk_size=4, checkpoint_path=f"{d}/j.npz"),
            TH.train_baum_welch(rows, names, 2, n_iters=10, seed=2,
                                chunk_size=4, checkpoint_path=f"{d}/t.npz",
                                device="cpu"))
    rng = np.random.default_rng(1)
    letters = list("abcd")
    short = [[letters[i] for i in rng.integers(0, 4, rng.integers(2, 5))]
             for _ in range(32_800)]
    out["sequential, 2 states"] = bw_gap(
        JH.train_baum_welch(short, letters, 2, n_iters=10, seed=1),
        TH.train_baum_welch(short, letters, 2, n_iters=10, seed=1,
                            device="cpu"))
    return out


def main():
    print(json.dumps({"odds": odds_gaps(), "viterbi": viterbi_gap(),
                      "baum_welch": baum_welch_gaps()}))


if __name__ == "__main__":
    main()
