"""Transition model: transition-id <-> (phone, hmm-state, pdf) mapping.

Clean-room equivalent of src/hmm/transition-model.{h,cc}
(TransitionModel): the 2015-era tuple structure
(phone, hmm_state, pdf), 1-based transition states and transition ids,
trainable transition log-probs with the reference's MLE update
(floor + renormalize per transition state).

``TransitionIdToPdf`` — the per-frame lookup in every decode/align
inner loop — is exported as a dense int32 numpy array
(``trans_id_to_pdf_array``) that ships to the TPU for on-device
decoding (SURVEY.md §2 disposition).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.lang.topology import HmmTopology


class ContextDependencyInterface:
    """(phone window, pdf_class) -> pdf-id (ref: src/itf/context-dep-itf.h)."""

    context_width: int = 1
    central_position: int = 0

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        raise NotImplementedError

    @property
    def num_pdfs(self) -> int:
        raise NotImplementedError

    def pdfs_for(self, phone: int, pdf_class: int):
        """All pdf-ids reachable for (central phone, pdf-class) over
        contexts (ref: ContextDependency::GetPdfInfo).  Context-free
        default: the single monophone answer."""
        return {self.compute([phone], pdf_class)}


class MonophoneContextDependency(ContextDependencyInterface):
    """Monophone 'tree': each (phone, pdf_class) gets its own pdf
    (ref: gmm-init-mono's MonophoneContextDependency)."""

    def __init__(self, topo: HmmTopology):
        self.context_width = 1
        self.central_position = 0
        self._offsets: Dict[int, int] = {}
        n = 0
        for p in topo.phones:
            self._offsets[p] = n
            n += topo.num_pdf_classes(p)
        self._num_pdfs = n

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        return self._offsets[phone_window[0]] + pdf_class

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs


class TransitionModel:
    """See module docstring.  States/ids are 1-based like the reference
    (0 is reserved: trans-id 0 never occurs; ilabel 0 is epsilon)."""

    def __init__(self, topo: HmmTopology, ctx_dep: ContextDependencyInterface):
        self.topo = topo
        self.ctx_dep = ctx_dep
        # enumerate tuples (phone, hmm_state, pdf) = transition states
        self.tuples: List[Tuple[int, int, int]] = []
        seen = set()
        for phone in topo.phones:
            entry = topo.entry(phone)
            for hmm_state, st in enumerate(entry.states):
                # every pdf the tree can emit for this (phone, state)
                # gets its own transition state (ref:
                # TransitionModel::ComputeTuples via GetPdfInfo)
                for pdf in sorted(ctx_dep.pdfs_for(phone, st.pdf_class)):
                    t = (phone, hmm_state, pdf)
                    if t not in seen:
                        seen.add(t)
                        self.tuples.append(t)
        self.tuples.sort()
        self._tuple_index = {t: i + 1 for i, t in enumerate(self.tuples)}
        # per transition state: id range start
        self._state2id = [0, 1]  # state s ids start at _state2id[s]
        for (phone, hmm_state, _pdf) in self.tuples:
            n = len(topo.entry(phone).states[hmm_state].transitions)
            self._state2id.append(self._state2id[-1] + n)
        self.num_transition_ids = self._state2id[-1] - 1
        # dense id -> (state, index, pdf, phone, is_self_loop)
        n_ids = self.num_transition_ids + 1
        self._id2state = np.zeros(n_ids, dtype=np.int32)
        self._id2pdf = np.zeros(n_ids, dtype=np.int32)
        self._id2phone = np.zeros(n_ids, dtype=np.int32)
        self._id2self = np.zeros(n_ids, dtype=bool)
        self.log_probs = np.zeros(n_ids, dtype=np.float64)
        for ts, (phone, hmm_state, pdf) in enumerate(self.tuples, start=1):
            trans = topo.entry(phone).states[hmm_state].transitions
            for i, (nxt, prob) in enumerate(trans):
                tid = self._state2id[ts] + i
                self._id2state[tid] = ts
                self._id2pdf[tid] = pdf
                self._id2phone[tid] = phone
                self._id2self[tid] = (nxt == hmm_state)
                self.log_probs[tid] = math.log(max(prob, 1e-20))

    # -- lookups (ref: TransitionModel::TransitionIdToPdf etc.) -----------
    @property
    def num_pdfs(self) -> int:
        return self.ctx_dep.num_pdfs

    @property
    def num_transition_states(self) -> int:
        return len(self.tuples)

    def tuple_to_state(self, phone: int, hmm_state: int, pdf: int) -> int:
        return self._tuple_index[(phone, hmm_state, pdf)]

    def pair_to_id(self, trans_state: int, trans_index: int) -> int:
        return self._state2id[trans_state] + trans_index

    def id_to_state(self, tid: int) -> int:
        return int(self._id2state[tid])

    def id_to_pdf(self, tid: int) -> int:
        return int(self._id2pdf[tid])

    def id_to_phone(self, tid: int) -> int:
        return int(self._id2phone[tid])

    def is_self_loop(self, tid: int) -> bool:
        return bool(self._id2self[tid])

    def id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[self.id_to_state(tid) - 1][1]

    def id_to_trans_index(self, tid: int) -> int:
        """Index of this transition within its transition state
        (ref: TransitionModel::TransitionIdToTransitionIndex)."""
        return tid - self._state2id[self.id_to_state(tid)]

    def self_loop_id(self, trans_state: int) -> int:
        """Transition id of the self-loop of this state (0 if none)."""
        phone, hmm_state, _ = self.tuples[trans_state - 1]
        trans = self.topo.entry(phone).states[hmm_state].transitions
        for i, (nxt, _p) in enumerate(trans):
            if nxt == hmm_state:
                return self.pair_to_id(trans_state, i)
        return 0

    def trans_id_to_pdf_array(self) -> np.ndarray:
        """[num_transition_ids+1] int32, entry 0 unused — the decoder's
        on-device lookup table."""
        return self._id2pdf.copy()

    def trans_id_to_logprob_array(self) -> np.ndarray:
        return self.log_probs.astype(np.float32)

    # -- MLE update (ref: TransitionModel::MleUpdate) ----------------------
    def mle_update(self, stats: np.ndarray, floor: float = 0.01) -> float:
        """stats: [num_transition_ids+1] occupancy counts. Returns
        auxiliary-function improvement per frame (approx)."""
        objf_impr = 0.0
        count = 0.0
        for ts in range(1, self.num_transition_states + 1):
            lo, hi = self._state2id[ts], self._state2id[ts + 1]
            c = stats[lo:hi].astype(np.float64)
            tot = c.sum()
            if tot < 1e-8 or hi - lo < 2:
                continue
            new_p = c / tot
            new_p = np.maximum(new_p, floor)
            new_p /= new_p.sum()
            old_lp = self.log_probs[lo:hi]
            new_lp = np.log(new_p)
            objf_impr += float(np.sum(c * (new_lp - old_lp)))
            count += tot
            self.log_probs[lo:hi] = new_lp
        return objf_impr / max(count, 1.0)
