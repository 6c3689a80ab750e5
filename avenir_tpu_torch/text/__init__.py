"""Text analysis: tokenizer, word count, text-mode Naive Bayes.

Counterpart of ``avenir_tpu/text`` (the reference's ``org.avenir.text``
package, WordCounter.java, and the text branch of
BayesianDistribution/BayesianPredictor).
"""

from avenir_tpu_torch.text.analyzer import StandardAnalyzer, tokenize
from avenir_tpu_torch.text.word_count import count_words, word_count_lines
from avenir_tpu_torch.text import text_bayes

__all__ = ["StandardAnalyzer", "tokenize", "count_words",
           "word_count_lines", "text_bayes"]
