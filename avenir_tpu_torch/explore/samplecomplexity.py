"""PAC sample-complexity calculators.

The reference ships these as the resource/comp_learn.py helper script: given a
hypothesis-space size (or its log), a tolerable error and a confidence
threshold, how many training samples does a consistent learner need — the
Haussler/Blumer bound m >= (ln|H| + ln(1/delta)) / epsilon (comp_learn.py:11-24),
with |H| computed for conjunctive, k-term-DNF and k-CNF hypothesis spaces over
categorical features (comp_learn.py:26-78).

A copy of ``avenir_tpu/explore/samplecomplexity.py`` (pure Python): host-side
planning utilities that size the *input* to the jobs; no kernel.
DEVIATION (documented): the reference's ``numValueCombinations``
enumerates index triples/quadruples with overlapping ranges (``for i in
0..n, j in 1..n, k in 2..n`` — comp_learn.py:62-72), double counting
feature subsets; this build enumerates true k-combinations.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple


def pac_sample_bound(num_hypotheses: float, error: float,
                     prob_threshold: float) -> int:
    """m >= (ln|H| + ln(1/p)) / e — samples for a consistent learner to be
    within ``error`` with confidence 1-``prob_threshold``
    (comp_learn.py:11-16 ``numSamples``). DEVIATION (documented): the
    reference truncates (``long(m)``), returning one sample short of its own
    bound; this build rounds up so the guarantee actually holds."""
    if error <= 0 or prob_threshold <= 0 or num_hypotheses < 1:
        raise ValueError("error > 0, prob_threshold > 0, |H| >= 1 required")
    return math.ceil(math.log(num_hypotheses / prob_threshold) / error)


def pac_sample_bound_ln(ln_num_hypotheses: float, error: float,
                        prob_threshold: float) -> int:
    """Same bound when |H| is only available in log space (k-CNF spaces
    overflow |H| — comp_learn.py:18-24 ``numSamplesWithLn``; same
    round-up deviation as :func:`pac_sample_bound`)."""
    if error <= 0 or prob_threshold <= 0:
        raise ValueError("error > 0 and prob_threshold > 0 required")
    return math.ceil(
        (ln_num_hypotheses + math.log(1.0 / prob_threshold)) / error)


def sample_table(num_hypotheses: float, errors: Sequence[float],
                 prob_thresholds: Sequence[float]
                 ) -> List[Tuple[float, float, int]]:
    """The (error, threshold, m) sweep the reference script prints."""
    return [(e, p, pac_sample_bound(num_hypotheses, e, p))
            for e in errors for p in prob_thresholds]


def conjunctive_hypothesis_space(feature_cardinalities: Sequence[int],
                                 class_cardinality: int) -> int:
    """|H| for conjunctions over all features: each feature contributes its
    values plus don't-care, times the class labelings
    (comp_learn.py:26-33 ``termsHypSpace``)."""
    num = 1
    for card in feature_cardinalities:
        num *= card + 1
    return num * class_cardinality


def num_value_combinations(feature_cardinalities: Sequence[int],
                           num_vars: int) -> int:
    """Number of conjunctive terms using exactly ``num_vars`` distinct
    features (value-assignment count summed over feature k-subsets)."""
    n = len(feature_cardinalities)
    if not 0 < num_vars <= n:
        raise ValueError(f"num_vars must be in 1..{n}")
    total = 0
    for subset in itertools.combinations(feature_cardinalities, num_vars):
        total += math.prod(subset)
    return total


def k_term_dnf_hypothesis_space(feature_cardinalities: Sequence[int],
                                class_cardinality: int, term_size: int,
                                num_terms: int) -> int:
    """|H| for disjunctions of ``num_terms`` conjunctive terms of
    ``term_size`` variables: C(numTerms, terms) choices times class labelings
    (comp_learn.py:36-50 ``disjunctiveHypSpace``)."""
    terms = num_value_combinations(feature_cardinalities, term_size)
    return math.comb(terms, num_terms) * class_cardinality


def k_cnf_hypothesis_space_ln(feature_cardinalities: Sequence[int],
                              class_cardinality: int,
                              clause_size: int) -> float:
    """ln|H| for k-CNF: every subset of the possible size-``clause_size``
    clauses may be conjoined, so ln|H| = (#clauses)·ln 2 + ln(classes)
    (comp_learn.py:53-58 ``conjunctiveHypSpace``; NOTE the reference divides
    by log2(e) which equals multiplying by ln 2)."""
    clauses = num_value_combinations(feature_cardinalities, clause_size)
    return clauses * math.log(2.0) + math.log(class_cardinality)
