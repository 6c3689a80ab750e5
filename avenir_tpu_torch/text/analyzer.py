"""Text analysis: tokenizer equivalent of the reference's Lucene analyzer.

A copy of ``avenir_tpu/text/analyzer.py`` (pure Python), so that the port
imports nothing of the JAX package: ``ENGLISH_STOP_WORDS``, ``_WORD_RE``,
``StandardAnalyzer``, ``tokenize``.

The reference tokenizes text through Lucene's ``StandardAnalyzer``
(WordCounter.java:94, BayesianDistribution.java:127 via chombo
``Utility.tokenize``): Unicode word segmentation, lowercasing, and removal of
the default English stop-word set. This module reproduces that contract with
a regex word splitter — no Lucene dependency — so the text-mode Bayes and
word-count paths see the same token stream shape the reference does.
"""

from __future__ import annotations

import re
from typing import List, Sequence

# Lucene's ENGLISH_STOP_WORDS_SET (StopAnalyzer), the default stop set of
# StandardAnalyzer up through Lucene 3.x.
ENGLISH_STOP_WORDS = frozenset((
    "a", "an", "and", "are", "as", "at", "be", "but", "by",
    "for", "if", "in", "into", "is", "it",
    "no", "not", "of", "on", "or", "such",
    "that", "the", "their", "then", "there", "these",
    "they", "this", "to", "was", "will", "with",
))

# word = run of letters/digits, allowing internal apostrophes and dots the
# way StandardTokenizer keeps "o'neil" / acronyms together.
_WORD_RE = re.compile(r"[0-9A-Za-z_]+(?:['.][0-9A-Za-z_]+)*")


class StandardAnalyzer:
    """Lowercasing word tokenizer with an optional stop-word set."""

    def __init__(self, stop_words: Sequence[str] = ENGLISH_STOP_WORDS,
                 min_length: int = 1):
        self.stop_words = frozenset(stop_words or ())
        self.min_length = min_length

    def tokenize(self, text: str) -> List[str]:
        out = []
        for m in _WORD_RE.finditer(text.lower()):
            tok = m.group(0).strip("'.")
            if len(tok) >= self.min_length and tok not in self.stop_words:
                out.append(tok)
        return out


def tokenize(text: str) -> List[str]:
    """Module-level convenience with the default analyzer."""
    return _DEFAULT.tokenize(text)


_DEFAULT = StandardAnalyzer()
