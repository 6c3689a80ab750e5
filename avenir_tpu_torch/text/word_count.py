"""Word counting: the reference's ``text.WordCounter`` MR on the card.

Counterpart of ``avenir_tpu/text/word_count.py`` (``count_words``,
``word_count_lines``). The reference job (WordCounter.java:54-109)
tokenizes one text column (``text.field.ordinal``; the whole line when
< 0) with a Lucene analyzer, shuffles (token -> 1) pairs and counts per
token in the reducer. Here the host encodes the tokens in first-seen
order and K1 counts the ids (one class, one feature, the vocabulary as
its bins), exact in int64. The output lines are ``token<delim>count``,
sorted by token.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.ops.histogram import class_bin_counts_exact
from avenir_tpu_torch.text.analyzer import StandardAnalyzer
from avenir_tpu_torch.utils.device import DeviceLike, resolve_device


def count_words(texts: Iterable[str],
                analyzer: Optional[StandardAnalyzer] = None,
                device: DeviceLike = "cuda") -> Dict[str, int]:
    """Token -> count over an iterable of texts: tokenization and the
    vocabulary on the host, the count on ``device``."""
    dev = resolve_device(device)
    analyzer = analyzer or StandardAnalyzer()
    vocab: Dict[str, int] = {}
    ids: List[int] = []
    for text in texts:
        for tok in analyzer.tokenize(text):
            idx = vocab.get(tok)
            if idx is None:
                idx = len(vocab)
                vocab[tok] = idx
            ids.append(idx)
    if not vocab:
        return {}
    id_t = torch.from_numpy(np.asarray(ids, np.int32)).to(dev)
    counts = class_bin_counts_exact(
        id_t, torch.zeros_like(id_t), 1, len(vocab))[0].cpu().numpy()
    return {tok: int(counts[idx]) for tok, idx in vocab.items()}


def word_count_lines(rows: Sequence[Sequence[str]],
                     text_field_ordinal: int = -1,
                     delim_out: str = ",",
                     analyzer: Optional[StandardAnalyzer] = None,
                     device: DeviceLike = "cuda") -> List[str]:
    """The job: parsed CSV rows in, sorted ``token,count`` lines out.
    ``text_field_ordinal`` selects the text column; negative means the
    whole line, its fields joined with a space, so that no two fields
    merge into one token (WordCounter.java:101-106)."""
    if text_field_ordinal >= 0:
        texts = (row[text_field_ordinal] for row in rows)
    else:
        texts = (" ".join(row) for row in rows)
    counts = count_words(texts, analyzer, device=device)
    return [f"{tok}{delim_out}{n}" for tok, n in sorted(counts.items())]
