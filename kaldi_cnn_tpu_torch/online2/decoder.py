"""Online (incremental) decoding with endpointing.

Clean-room equivalent of src/online2/online-nnet2-decoding.{h,cc}
(SingleUtteranceNnet2Decoder::AdvanceDecoding) +
online-endpoint.{h,cc}: the host Viterbi decoder's per-frame loop is
re-entrant — feed acoustic chunks as they become available, read the
current-best partial hypothesis at any time, and test endpointing rules
on the trailing-silence / utterance statistics.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.decode.decoder import _Trace, _eps_expand, _group_min, INF
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph


@configclass
class EndpointRule:
    """(ref: online-endpoint.h OnlineEndpointRule)."""
    must_contain_nonsilence: bool = True
    min_trailing_silence_sec: float = 0.5
    max_relative_cost: float = 8.0
    min_utterance_length_sec: float = 0.0


@configclass
class EndpointConfig:
    """The reference ships 5 rules OR-ed together; the two most
    load-bearing are kept (long trailing silence after speech; very
    long utterance)."""
    silence_timeout_sec: float = 5.0       # rule1: nothing decoded yet
    rule_trailing: EndpointRule = None     # type: ignore
    max_utterance_length_sec: float = 20.0

    def __post_init__(self):
        if self.rule_trailing is None:
            self.rule_trailing = EndpointRule()


class SingleUtteranceDecoder:
    """Incremental Viterbi over a CompiledGraph."""

    def __init__(self, graph: CompiledGraph, acoustic_scale: float = 0.1,
                 beam: float = 16.0, max_active: int = 7000,
                 frame_shift_sec: float = 0.01):
        self.g = graph
        self.acoustic_scale = acoustic_scale
        self.beam = beam
        self.max_active = max_active
        self.frame_shift = frame_shift_sec
        self.trace = _Trace()
        self.cost = np.full(graph.num_states, INF, np.float32)
        self.tok = np.zeros(graph.num_states, np.int64)
        self.cost[graph.start] = 0.0
        self.cost, self.tok = _eps_expand(graph, self.cost, self.tok,
                                          self.trace)
        self.num_frames = 0

    def advance(self, loglikes: np.ndarray) -> None:
        """Feed a chunk of [n, num_pdfs] acoustic log-likelihoods
        (ref: AdvanceDecoding)."""
        g = self.g
        am = -self.acoustic_scale * loglikes
        for t in range(loglikes.shape[0]):
            src_cost = self.cost[g.e_src]
            cand = src_cost + g.e_weight + am[t, g.e_pdf]
            new_cost, best_arc = _group_min(g.e_dst, cand, g.num_states)
            states = np.nonzero(np.isfinite(new_cost))[0]
            arcs = best_arc[states]
            new_tok = self.trace.push(self.tok[g.e_src[arcs]],
                                      g.e_ilabel[arcs], g.e_olabel[arcs])
            self.cost = np.full(g.num_states, INF, np.float32)
            self.tok = np.zeros(g.num_states, np.int64)
            self.cost[states] = new_cost[states]
            self.tok[states] = new_tok
            self.cost, self.tok = _eps_expand(g, self.cost, self.tok,
                                              self.trace)
            if np.isfinite(self.beam):
                self.cost[self.cost > self.cost.min() + self.beam] = INF
            if self.max_active and \
                    np.isfinite(self.cost).sum() > self.max_active:
                kth = np.partition(self.cost, self.max_active)[
                    self.max_active]
                self.cost[self.cost > kth] = INF
            self.num_frames += 1

    def best_path(self, use_final: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Current best (tids, words, cost) — partial traceback
        (ref: GetBestPath with use_final_probs)."""
        total = self.cost + (self.g.final if use_final else 0.0)
        s = int(np.argmin(total))
        c = float(total[s])
        if not np.isfinite(c):
            s = int(np.argmin(self.cost))
            c = float(self.cost[s])
            if not np.isfinite(c):
                return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                        float("inf"))
        tids, words = [], []
        i = self.tok[s]
        prev = np.asarray(self.trace.prev)
        il = np.asarray(self.trace.ilabel)
        ol = np.asarray(self.trace.olabel)
        while i > 0:
            if il[i] > 0:
                tids.append(int(il[i]))
            if ol[i] > 0:
                words.append(int(ol[i]))
            i = prev[i]
        return (np.asarray(tids[::-1], np.int32),
                np.asarray(words[::-1], np.int32), c)

    # -- endpointing -------------------------------------------------------
    def trailing_silence_frames(self, trans_model, silence_phone: int
                                ) -> int:
        tids, _, _ = self.best_path(use_final=False)
        n = 0
        for tid in tids[::-1]:
            if trans_model.id_to_phone(int(tid)) == silence_phone:
                n += 1
            else:
                break
        return n

    def endpoint_detected(self, trans_model, silence_phone: int,
                          config: Optional[EndpointConfig] = None
                          ) -> bool:
        """(ref: online-endpoint.cc EndpointDetected)."""
        config = config or EndpointConfig()
        t = self.num_frames
        if t == 0:
            return False
        utt_sec = t * self.frame_shift
        tids, words, _ = self.best_path(use_final=False)
        trailing = self.trailing_silence_frames(trans_model,
                                                silence_phone)
        trailing_sec = trailing * self.frame_shift
        said_something = len(words) > 0
        if not said_something and utt_sec >= config.silence_timeout_sec:
            return True
        r = config.rule_trailing
        if said_something or not r.must_contain_nonsilence:
            if (trailing_sec >= r.min_trailing_silence_sec
                    and utt_sec >= r.min_utterance_length_sec):
                # relative cost of being in a final state now
                total = self.cost + self.g.final
                best_final = float(np.min(total))
                best_any = float(np.min(self.cost))
                if (np.isfinite(best_final)
                        and best_final - best_any <= r.max_relative_cost):
                    return True
        if utt_sec >= config.max_utterance_length_sec:
            return True
        return False
