"""Evaluation metrics (a copy of stjep_tpu/utils/metrics.py, which imports
no JAX; tests/test_torch_data.py pins the two equal).

corpus_bleu reimplements the semantics of torchtext.data.metrics.bleu_score
(the reference's BLEU, ref: trainer/trainer_asr.py:181): corpus-level BLEU-4
with uniform weights, clipped n-gram counts against the closest-count
reference set, multiplicative brevity penalty, and 0.0 when any n-gram order
has zero matches.
"""

from __future__ import annotations

import collections
import math
from typing import List, Sequence


def _ngram_counts(tokens: Sequence[str], max_n: int):
    counts = collections.Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def corpus_bleu(
    candidate_corpus: List[List[str]],
    references_corpus: List[List[List[str]]],
    max_n: int = 4,
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
) -> float:
    """Corpus BLEU (torchtext-compatible).

    candidate_corpus: list of token lists.
    references_corpus: list of lists of reference token lists.
    """
    assert len(candidate_corpus) == len(references_corpus)
    clipped = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0

    for cand, refs in zip(candidate_corpus, references_corpus):
        cand_len += len(cand)
        # closest reference length; key-based min keeps the FIRST reference
        # on ties like torchtext
        ref_len += len(min(refs, key=lambda r: abs(len(r) - len(cand))))

        cand_counts = _ngram_counts(cand, max_n)
        max_ref = collections.Counter()
        for r in refs:
            for ng, c in _ngram_counts(r, max_n).items():
                max_ref[ng] = max(max_ref[ng], c)
        for ng, c in cand_counts.items():
            n = len(ng) - 1
            total[n] += c
            clipped[n] += min(c, max_ref.get(ng, 0))

    if min(clipped) == 0:
        return 0.0

    score = 0.0
    for n in range(max_n):
        score += weights[n] * math.log(clipped[n] / total[n])
    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
    return bp * math.exp(score)


def _edits(hyp: List[str], ref: List[str]) -> int:
    """Levenshtein distance between two token lists."""
    n, m = len(ref), len(hyp)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def word_error_rate(hyp: List[str], ref: List[str]) -> float:
    """Levenshtein WER for a single pair of token lists."""
    if not ref:
        return float(len(hyp) > 0)
    return _edits(hyp, ref) / len(ref)


def corpus_wer(hyps: List[List[str]], refs: List[List[str]]) -> float:
    """Corpus WER: total edits / total reference tokens."""
    edits = sum(_edits(h, r) for h, r in zip(hyps, refs))
    return edits / max(sum(len(r) for r in refs), 1)
