"""Automatic question generation by phone clustering.

Clean-room equivalent of src/bin/cluster-phones.cc +
compile-questions.cc (backed by src/tree/cluster-utils.cc
ClusterBottomUp): agglomeratively merge phones by single-Gaussian
likelihood loss; every intermediate cluster becomes a question (a set
of phones), which is how the reference builds its question sets when a
hand-written questions file is absent (utils/prepare_lang.sh path).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence

import numpy as np

from kaldi_cnn_tpu_torch.tree.event_map import KEY_PDF_CLASS
from kaldi_cnn_tpu_torch.tree.stats import EventKey, GaussStats


def per_phone_stats(stats: Dict[EventKey, GaussStats],
                    central_position: int = 1) -> Dict[int, GaussStats]:
    out: Dict[int, GaussStats] = {}
    for key, st in stats.items():
        ev = dict(key)
        phone = ev.get(central_position, 0)
        if phone == 0:
            continue
        out.setdefault(phone, GaussStats()).add(st)
    return out


def cluster_phones(phone_stats: Dict[int, GaussStats]
                   ) -> List[FrozenSet[int]]:
    """Bottom-up clustering; returns every cluster formed along the way
    (singletons included) — the question list."""
    clusters: List[FrozenSet[int]] = [frozenset([p]) for p in
                                      sorted(phone_stats)]
    cstats: List[GaussStats] = [
        GaussStats().add(phone_stats[p]) for p in sorted(phone_stats)]
    questions: List[FrozenSet[int]] = list(clusters)
    active = list(range(len(clusters)))
    while len(active) > 1:
        best = None
        # merge the pair with the smallest likelihood loss
        for ii in range(len(active)):
            for jj in range(ii + 1, len(active)):
                i, j = active[ii], active[jj]
                merged = GaussStats().add(cstats[i]).add(cstats[j])
                loss = cstats[i].objf() + cstats[j].objf() - merged.objf()
                if best is None or loss < best[0]:
                    best = (loss, ii, jj, merged)
        _, ii, jj, merged = best
        i, j = active[ii], active[jj]
        newset = clusters[i] | clusters[j]
        clusters.append(newset)
        cstats.append(merged)
        questions.append(newset)
        active = [a for a in active if a not in (i, j)]
        active.append(len(clusters) - 1)
    return questions


def questions_for_keys(
    stats: Dict[EventKey, GaussStats],
    context_width: int = 3,
    central_position: int = 1,
    max_pdf_class: int = 4,
) -> Dict[int, List[FrozenSet[int]]]:
    """Question sets per event key (ref: compile-questions: phone
    questions apply to every context position; pdf-class questions are
    the prefix sets {0}, {0,1}, ... per src/tree/build-tree.cc
    comments)."""
    pstats = per_phone_stats(stats, central_position)
    phone_qs = cluster_phones(pstats) if pstats else []
    out: Dict[int, List[FrozenSet[int]]] = {}
    for k in range(context_width):
        # boundary (phone 0) can be asked about at non-central positions
        extra = ([frozenset([0])] if k != central_position else [])
        out[k] = list(phone_qs) + extra
    out[KEY_PDF_CLASS] = [
        frozenset(range(c + 1)) for c in range(max_pdf_class)]
    return out
