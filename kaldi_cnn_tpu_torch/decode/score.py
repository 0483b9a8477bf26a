"""WER scoring (verbatim twin of ``kaldi_cnn_tpu/decode/score.py``;
ref: src/bin/compute-wer.cc, src/util/edit-distance-inl.h)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Returns (total_errors, substitutions, insertions, deletions)."""
    m, n = len(ref), len(hyp)
    # dp over (cost, subs, ins, dels)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # backtrack for error breakdown
    i, j = m, n
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs + ins + dels, subs, ins, dels


def wer_details(refs: Dict[str, List], hyps: Dict[str, List]) -> Dict:
    """Corpus WER like compute-wer: %WER, err breakdown, counts.
    ``per_utt`` maps utt -> (errors, ref words) for paired
    significance tests across systems."""
    total_words = total_err = s = i_ = d = 0
    missing = 0
    per_utt: Dict[str, Tuple[int, int]] = {}
    for key, ref in refs.items():
        hyp = hyps.get(key, [])
        if key not in hyps:
            missing += 1
        e, subs, ins, dels = edit_distance(ref, hyp)
        per_utt[key] = (e, len(ref))
        total_words += len(ref)
        total_err += e
        s += subs
        i_ += ins
        d += dels
    wer = 100.0 * total_err / max(total_words, 1)
    return {"wer": wer, "errors": total_err, "words": total_words,
            "sub": s, "ins": i_, "del": d, "missing_utts": missing,
            "per_utt": per_utt}


def paired_sign_test(per_utt_a: Dict[str, Tuple[int, int]],
                     per_utt_b: Dict[str, Tuple[int, int]]) -> Dict:
    """Matched-pairs sign test on per-utterance error counts — the
    sclite 'matched pairs sentence segment' idea reduced to its exact
    binomial core (ref: compute-wer per-utt counts + sclite sig tests).

    Returns b = #utts where system A has fewer errors, c = where B
    does, and the two-sided exact binomial p-value of b successes in
    b+c tries at p=1/2 (ties carry no information and are dropped,
    McNemar-style)."""
    from math import comb
    b = c = 0
    for utt in per_utt_a:
        if utt not in per_utt_b:
            continue
        ea, eb = per_utt_a[utt][0], per_utt_b[utt][0]
        if ea < eb:
            b += 1
        elif eb < ea:
            c += 1
    n = b + c
    if n == 0:
        return {"a_better": 0, "b_better": 0, "p_value": 1.0}
    k = min(b, c)
    # two-sided: P(X <= k) + P(X >= n-k) for X ~ Binom(n, 1/2)
    tail = sum(comb(n, j) for j in range(0, k + 1)) / 2.0 ** n
    p = min(1.0, 2.0 * tail)
    return {"a_better": b, "b_better": c, "p_value": p}
