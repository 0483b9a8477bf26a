"""Tree-building sufficient statistics.

Clean-room equivalent of src/tree/build-tree-utils.{h,cc}
(GaussClusterable accumulation) and src/bin/acc-tree-stats.cc: walk
aligned utterances, split alignments into phone segments, and key
single-diag-Gaussian stats by the event
{-1: pdf-class, 0: left phone, 1: central phone, 2: right phone}
(phone value 0 = out-of-utterance boundary).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.lang.transition_model import TransitionModel
from kaldi_cnn_tpu_torch.tree.event_map import KEY_PDF_CLASS, Event

EventKey = Tuple[Tuple[int, int], ...]   # sorted (key, value) items


def event_key(event: Event) -> EventKey:
    return tuple(sorted(event.items()))


@dataclass
class GaussStats:
    """Count + first/second-order diag stats with the single-Gaussian
    log-likelihood objective (ref: src/tree/clusterable-classes.h
    GaussClusterable::Objf)."""

    count: float = 0.0
    x: np.ndarray = None
    x2: np.ndarray = None

    def add_frame(self, f: np.ndarray) -> None:
        if self.x is None:
            self.x = np.zeros_like(f, np.float64)
            self.x2 = np.zeros_like(f, np.float64)
        self.count += 1.0
        self.x += f
        self.x2 += f * f

    def add(self, other: "GaussStats") -> "GaussStats":
        if other.x is None:
            return self
        if self.x is None:
            self.x = np.zeros_like(other.x)
            self.x2 = np.zeros_like(other.x2)
        self.count += other.count
        self.x += other.x
        self.x2 += other.x2
        return self

    def objf(self, var_floor: float = 0.01) -> float:
        """Total log-likelihood of the data under the ML diag Gaussian."""
        if self.count < 1e-10:
            return 0.0
        mean = self.x / self.count
        var = np.maximum(self.x2 / self.count - mean * mean, var_floor)
        return float(-0.5 * self.count
                     * np.sum(np.log(2.0 * np.pi * var) + 1.0))

    @staticmethod
    def sum_of(stats: Sequence["GaussStats"]) -> "GaussStats":
        out = GaussStats()
        for s in stats:
            out.add(s)
        return out


def split_to_phones(tm: TransitionModel,
                    tids: np.ndarray) -> List[Tuple[int, List[int]]]:
    """Alignment -> [(phone, [frame indices])] (ref: src/hmm/hmm-utils.cc
    SplitToPhones).  A frame opens a new segment iff the previous frame
    took the exit transition of its phone (last emitting state, not a
    self-loop)."""
    segs: List[Tuple[int, List[int]]] = []
    prev_exit = True
    for t, tid in enumerate(np.asarray(tids, np.int64)):
        tid = int(tid)
        phone = tm.id_to_phone(tid)
        if prev_exit:
            segs.append((phone, []))
        segs[-1][1].append(t)
        hmm_state = tm.id_to_hmm_state(tid)
        n_emit = tm.topo.entry(phone).num_emitting
        prev_exit = (hmm_state == n_emit - 1
                     and not tm.is_self_loop(tid))
    return segs


def frame_events(tm: TransitionModel, tids: np.ndarray,
                 context_width: int = 3,
                 central_position: int = 1) -> List[Event]:
    """Per-frame events for tree accumulation."""
    segs = split_to_phones(tm, tids)
    phones = [p for p, _ in segs]
    events: List[Event] = [None] * len(tids)
    for i, (phone, frames) in enumerate(segs):
        window = {}
        for k in range(context_width):
            j = i + k - central_position
            window[k] = phones[j] if 0 <= j < len(phones) else 0
        for t in frames:
            pdf_class = tm.topo.entry(phone).states[
                tm.id_to_hmm_state(int(tids[t]))].pdf_class
            ev = dict(window)
            ev[KEY_PDF_CLASS] = pdf_class
            events[t] = ev
    return events


def accumulate_tree_stats(
    tm: TransitionModel,
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    context_width: int = 3,
    central_position: int = 1,
) -> Dict[EventKey, GaussStats]:
    """(ref: src/bin/acc-tree-stats.cc AccumulateTreeStats)."""
    stats: Dict[EventKey, GaussStats] = {}
    for utt, tids in alignments.items():
        f = feats[utt]
        evs = frame_events(tm, tids, context_width, central_position)
        for t, ev in enumerate(evs):
            k = event_key(ev)
            if k not in stats:
                stats[k] = GaussStats()
            stats[k].add_frame(f[t].astype(np.float64))
    return stats
