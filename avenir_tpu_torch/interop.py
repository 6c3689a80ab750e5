"""State carried across from numpy: a trained Naive Bayes model (tabular
or text), a staged (encoded) table, the encoded operands of the KNN
kernel sweeps, a built IVF index, and a Markov or hidden Markov model, so
the same state can drive both this port and the JAX package.

The model files are the other carrier: each package's ``load_model``
reads what the other's ``save_model`` wrote, and a decision tree crosses
over as TreeBuilder's JSON artifact (``TreeNode.to_dict`` /
``TreeNode.from_dict``), which each package's TreePredictor reads. A
random forest crosses over as its stacked artifact (``save_forest`` /
``load_forest``: the same bytes from both packages, each loader reading
the other's), and a batch bandit round as its ``group,item,count,reward``
file, which each package's four bandit verbs read into the same
selections. Neither needs a converter here. A boosted ensemble crosses
over as its artifact too, or as the artifact's JSON object through
:func:`boosted_model_from_dict`. A streaming learner's state crosses over
as its fields (a JAX ``LearnerState``'s leaves as numpy) through
:func:`learner_state_from_numpy`, so both packages can start from the
same mid-run state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.models.bandits.learners import LearnerState
from avenir_tpu_torch.models.boost import BoostedModel, model_from_payload
from avenir_tpu_torch.models.hmm import HmmModel
from avenir_tpu_torch.models.markov import MarkovModel
from avenir_tpu_torch.models.naive_bayes import BayesModel, model_from_numpy
from avenir_tpu_torch.ops.ivf import IvfIndex
from avenir_tpu_torch.text.text_bayes import TextBayesModel
from avenir_tpu_torch.utils.dataset import EncodedTable
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device
from avenir_tpu_torch.utils.schema import FeatureField


def bayes_model_from_numpy(arrays: dict, device: DeviceLike = "cuda"
                           ) -> BayesModel:
    """``arrays`` holds the six ``BayesModel`` fields (``class_counts``,
    ``post_counts``, ``prior_counts``, ``cont_count``, ``cont_sum``,
    ``cont_sumsq``) as numpy arrays."""
    return model_from_numpy(arrays, device)


def text_bayes_model_from_jax(class_values: Sequence[str],
                              vocab: Dict[str, int],
                              class_counts: np.ndarray,
                              token_counts: np.ndarray,
                              device: DeviceLike = "cuda") -> TextBayesModel:
    """The port's :class:`TextBayesModel` on ``device`` from a JAX
    ``TextBayesModel``'s fields: its class values, its vocabulary (token
    -> id) and its [C] and [C, V] count arrays as numpy (held as float64,
    as the port's model holds them)."""
    dev = resolve_device(device)
    return TextBayesModel(
        class_values=tuple(class_values), vocab=dict(vocab),
        class_counts=torch.from_numpy(
            np.asarray(class_counts, np.float64)).to(dev),
        token_counts=torch.from_numpy(
            np.asarray(token_counts, np.float64)).to(dev))


def encoded_table_from_numpy(binned: np.ndarray, numeric: np.ndarray,
                             labels: Optional[np.ndarray], ids: List[str],
                             *, feature_fields: Sequence[FeatureField],
                             bins_per_feature: Sequence[int],
                             is_continuous: Sequence[bool],
                             class_values: Sequence[str],
                             bin_labels: Sequence[Sequence[str]] = (),
                             norm_min: Sequence[float] = (),
                             norm_max: Sequence[float] = (),
                             device: DeviceLike = "cuda") -> EncodedTable:
    """The port's :class:`EncodedTable` from host arrays (binned [N, F]
    int32, numeric [N, F] f32, labels [N] int32 or None) and the table's
    metadata."""
    dev = resolve_device(device)
    return EncodedTable(
        binned=torch.tensor(np.asarray(binned, np.int32), device=dev),
        numeric=torch.tensor(np.asarray(numeric, np.float32), device=dev),
        labels=(torch.tensor(np.asarray(labels, np.int32), device=dev)
                if labels is not None else None),
        ids=list(ids),
        feature_fields=list(feature_fields),
        bins_per_feature=tuple(bins_per_feature),
        is_continuous=tuple(is_continuous),
        class_values=list(class_values),
        bin_labels=[list(b) for b in bin_labels],
        norm_min=tuple(norm_min),
        norm_max=tuple(norm_max))


def _operand_from_numpy(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # the ml_dtypes type JAX hands out
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(dev).contiguous()
    if a.dtype not in (np.int8, np.int32, np.float32):
        raise TypeError(f"sweep operands are int8, int32, bfloat16 or "
                        f"float32, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(dev)   # a writable copy


def sweep_operands_from_numpy(xa: np.ndarray, ya: np.ndarray, *, n: int,
                              scale=None, y2: Optional[np.ndarray] = None,
                              tpose: bool = False,
                              device: DeviceLike = "cuda"
                              ) -> Tuple[torch.Tensor, ...]:
    """The encoded operands a JAX sweep encoded (int8, bf16 or f32
    arrays; ``scale`` its quantization scale, ``y2`` its epilogue row) as
    the port's tensors, types kept: ``(xa, ya, scale, y2)``. The JAX
    launchers pad the train side to their tile; ``n`` is the number of real
    train rows, and what lies past it is cut (along axis 1 with ``tpose``),
    since columns past N do not exist for the port's fold kernels."""
    dev = resolve_device(device)
    ya = np.asarray(ya)
    ya = ya[:, :n] if tpose else ya[:n]
    return (_operand_from_numpy(xa, dev), _operand_from_numpy(ya, dev),
            None if scale is None else torch.tensor(
                float(np.asarray(scale, np.float32)), dtype=torch.float32,
                device=dev),
            None if y2 is None else _operand_from_numpy(
                np.asarray(y2).reshape(-1)[:n], dev))


#: the array fields of an IVF index and their types
_IVF_ARRAYS = {"centroids": np.float32, "cent_valid": np.bool_,
               "flat": np.float32, "qflat": np.int8, "gids": np.int32,
               "offsets": np.int32, "lengths": np.int32, "amax": np.float32}
_IVF_STATICS = ("nlist", "probe_pad", "n_real", "n_attrs", "n_cat_bins",
                "seed")


def ivf_index_from_numpy(fields: dict, device: DeviceLike = "cuda"
                         ) -> IvfIndex:
    """The port's :class:`IvfIndex` on ``device`` from ``fields``: the
    arrays of an index (``centroids``, ``cent_valid``, ``flat``,
    ``qflat``, ``gids``, ``offsets``, ``lengths``, ``amax``) as numpy
    arrays, and its static fields (``nlist``, ``probe_pad``, ``n_real``,
    ``n_attrs``, ``n_cat_bins``, ``seed``) as ints."""
    dev = resolve_device(device)
    arrays = {name: torch.from_numpy(
        np.array(np.asarray(fields[name]), dtype=dtype)).to(dev)
        for name, dtype in _IVF_ARRAYS.items()}
    return IvfIndex(**arrays,
                    **{name: int(fields[name]) for name in _IVF_STATICS})


def markov_model_from_numpy(states: Sequence[str], scale: int,
                            trans: Optional[np.ndarray] = None,
                            class_trans: Optional[Dict[str, np.ndarray]]
                            = None) -> MarkovModel:
    """The port's :class:`MarkovModel` from a Markov model's fields: the
    states, ``trans.prob.scale``, and the global [S, S] matrix or the
    class-conditional ones by label (numpy arrays, dtypes kept)."""
    return MarkovModel(
        states=list(states), scale=int(scale),
        trans=None if trans is None else np.array(trans),
        class_trans=None if class_trans is None else {
            label: np.array(m) for label, m in class_trans.items()})


def hmm_model_from_numpy(states: Sequence[str], observations: Sequence[str],
                         trans: np.ndarray, emit: np.ndarray,
                         initial: np.ndarray, scale: int = 1) -> HmmModel:
    """The port's :class:`HmmModel` from an HMM's fields: states,
    observations, trans [S, S], emit [S, O], initial [S] (numpy arrays,
    dtypes kept) and the scale."""
    return HmmModel(states=list(states), observations=list(observations),
                    trans=np.array(trans), emit=np.array(emit),
                    initial=np.array(initial), scale=int(scale))


def boosted_model_from_dict(payload: dict, device: DeviceLike = "cuda"
                            ) -> BoostedModel:
    """The port's :class:`BoostedModel` of a boosted artifact's JSON object
    (the dict the JAX package's ``save_boosted`` writes), refused by kind
    and format as ``load_boosted`` refuses a file. The trees live on the
    host; ``device`` is checked as every entry point checks it, and the
    model's margins run on the device of the table they are given."""
    resolve_device(device)
    return model_from_payload(payload)


def learner_state_from_numpy(fields: dict, device: DeviceLike = "cuda"
                             ) -> LearnerState:
    """A JAX ``LearnerState`` (its fields as numpy arrays, by name; the
    uint32 key words widen to the port's int64 key) as the port's
    ``models.bandits.learners.LearnerState`` on ``device``."""
    return LearnerState.from_numpy(fields, device=device)
