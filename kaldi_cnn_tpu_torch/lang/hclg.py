"""HCLG decoding-graph and training-graph compilation.

Clean-room equivalent of utils/mkgraph.sh + src/decoder/
training-graph-compiler.{h,cc} (TrainingGraphCompiler::CompileGraph):

    G  (ARPA or linear transcript, words)
    LG  = det*(L ∘ G), disambig symbols removed
    CLG = context expansion (monophone: identity; triphone: C ∘ LG)
    HCLG = per-arc HMM expansion with self-loops, transition-ids on
           ilabels, words on olabels

Design deviation from the reference, on purpose: instead of composing a
self-loop-free Ha and running AddSelfLoops after determinization
(ref: src/hmm/hmm-utils.cc GetHTransducer/AddSelfLoops), we expand each
phone arc of the already-determinized CLG directly into its HMM fragment
*including* self-loops.  This is semantically identical (same transition
ids, same path costs) and simpler; the graphs are marginally larger but
that cost lands in the decoder, which on TPU is dense/batched anyway.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from kaldi_cnn_tpu_torch.lang.arpa import ArpaLm, arpa_to_fst, parse_arpa
from kaldi_cnn_tpu_torch.lang.context import ContextWindows, compose_context
from kaldi_cnn_tpu_torch.lang.fst import EPS, Fst, compose, determinize_star, relabel
from kaldi_cnn_tpu_torch.lang.lexicon import Lexicon, make_lexicon_fst
from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable
from kaldi_cnn_tpu_torch.lang.topology import HmmTopology
from kaldi_cnn_tpu_torch.lang.transition_model import (
    ContextDependencyInterface, MonophoneContextDependency, TransitionModel)


@dataclass
class Lang:
    """The lang directory equivalent (ref: data/lang from prepare_lang.sh)."""

    lexicon: Lexicon
    phone_table: SymbolTable
    word_table: SymbolTable
    topo: HmmTopology
    ctx_dep: ContextDependencyInterface
    trans_model: TransitionModel
    num_disambig: int

    @staticmethod
    def create(lexicon: Lexicon, num_hmm_states: int = 3,
               ctx_dep: Optional[ContextDependencyInterface] = None) -> "Lang":
        phone_table, word_table, ndis = lexicon.make_symbol_tables()
        real_phones = [phone_table.id(p) for p in lexicon.phones]
        topo = HmmTopology(real_phones, default_num_states=num_hmm_states)
        if ctx_dep is None:
            ctx_dep = MonophoneContextDependency(topo)
        tm = TransitionModel(topo, ctx_dep)
        return Lang(lexicon, phone_table, word_table, topo, ctx_dep, tm, ndis)

    @property
    def disambig_phone_ids(self) -> List[int]:
        return [self.phone_table.id(f"#{k}") for k in range(self.num_disambig)
                if f"#{k}" in self.phone_table]


def _remove_disambig(lang: Lang, f: Fst) -> Fst:
    imap = {d: EPS for d in lang.disambig_phone_ids}
    omap = {}
    if "#0" in lang.word_table:
        omap[lang.word_table.id("#0")] = EPS
    return relabel(f, imap, omap)


def expand_hmm(
    lang: Lang,
    clg: Fst,
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    windows: Optional[ContextWindows] = None,
) -> Fst:
    """Replace each phone arc of CLG with its HMM fragment.

    ilabels become transition-ids (1-based; 0 stays epsilon), olabels
    are preserved on the entry arc.  Transition costs are the scaled
    -log transition probs (ref: hmm-utils.cc AddTransitionProbs
    semantics with --transition-scale/--self-loop-scale).
    """
    tm = lang.trans_model
    out = Fst()
    for _ in range(clg.num_states):
        out.add_state()
    out.start = clg.start
    for s in range(clg.num_states):
        out.final[s] = clg.final[s]
        for a in clg.arcs[s]:
            if a.ilabel == EPS:
                out.add_arc(s, EPS, a.olabel, a.weight, a.nextstate)
                continue
            if windows is not None:
                window = list(windows.window(a.ilabel))
                phone = window[windows.central_position]
            else:
                window = [a.ilabel]
                phone = a.ilabel
            entry = lang.topo.entry(phone)
            n_emit = entry.num_emitting
            # nodes for emitting states 1..n-1 are new; state 0 entered
            # via the entry arc; exits go to a.nextstate
            nodes = [out.add_state() for _ in range(n_emit)]
            out.add_arc(s, EPS, a.olabel, a.weight, nodes[0])
            for i, hmm_state in enumerate(entry.states):
                pdf = lang.ctx_dep.compute(window, hmm_state.pdf_class)
                ts = tm.tuple_to_state(phone, i, pdf)
                for idx, (nxt, _prob) in enumerate(hmm_state.transitions):
                    tid = tm.pair_to_id(ts, idx)
                    logp = tm.log_probs[tid]
                    scale = self_loop_scale if nxt == i else transition_scale
                    cost = -scale * logp
                    dest = nodes[nxt] if nxt < n_emit else a.nextstate
                    out.add_arc(nodes[i], tid, EPS, cost, dest)
    return out.connect()


def make_hclg(
    lang: Lang,
    g: Fst,
    transition_scale: float = 1.0,
    self_loop_scale: float = 0.1,
) -> Fst:
    """Full decoding graph (ref: utils/mkgraph.sh defaults:
    self-loop scale 0.1)."""
    L = make_lexicon_fst(lang.lexicon, lang.phone_table, lang.word_table)
    lg = determinize_star(compose(L, g))
    lg = _remove_disambig(lang, lg)
    return _context_and_hmm(lang, lg, transition_scale, self_loop_scale)


def make_hclg_from_arpa(lang: Lang, arpa_text: str, **kw) -> Fst:
    g = arpa_to_fst(parse_arpa(arpa_text), lang.word_table)
    return make_hclg(lang, g, **kw)


def compile_training_graph(
    lang: Lang,
    transcript: Sequence[str],
    transition_scale: float = 1.0,
    self_loop_scale: float = 0.1,
) -> Fst:
    """Per-utterance alignment graph (ref: TrainingGraphCompiler::
    CompileGraph: L ∘ linear-transcript, det, add HMMs)."""
    word_ids = [lang.word_table.id(w) for w in transcript]
    g = Fst.linear(word_ids)
    L = make_lexicon_fst(lang.lexicon, lang.phone_table, lang.word_table)
    lg = determinize_star(compose(L, g))
    lg = _remove_disambig(lang, lg)
    return _context_and_hmm(lang, lg, transition_scale, self_loop_scale)


def _context_and_hmm(lang: Lang, lg: Fst, transition_scale: float,
                     self_loop_scale: float) -> Fst:
    """Monophone: identity context; context-dependent trees go through
    CLG (ref: fstcomposecontext in utils/mkgraph.sh)."""
    if lang.ctx_dep.context_width > 1:
        clg, wins = compose_context(
            lg, lang.ctx_dep.context_width, lang.ctx_dep.central_position)
        return expand_hmm(lang, clg, transition_scale, self_loop_scale,
                          windows=wins)
    return expand_hmm(lang, lg, transition_scale, self_loop_scale)
