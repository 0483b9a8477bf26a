"""Synthetic large decoding graphs for scale tests and benchmarks.

Builds a word-loop HCLG-shaped graph directly as a CompiledGraph —
structurally faithful to a real unigram HCLG (start/loop hub with one
arc per word, per-word linear HMM chains with self-loops, word labels on
the chain-final arc back to the hub) — without paying the pure-Python
FST composition pipeline for 10^5-10^6 states.  Used to validate that
the top-K decoder's memory and step cost are independent of graph size
(ref: real WSJ/Librispeech HCLGs of 10^6-10^7 states, SURVEY.md §7
"Hard parts #1").
"""

from __future__ import annotations

import numpy as np

from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph


def make_big_graph(num_words: int, num_pdfs: int,
                   min_len: int = 3, max_len: int = 8,
                   seed: int = 0) -> CompiledGraph:
    """Word-loop graph: state 0 is the hub; each word w is a chain of
    L_w emitting states (self-loop + forward arc each, like a 1-state
    HMM per phone with self-loops), entered from the hub by an eps arc
    carrying the unigram cost and exited by an emitting arc labeled w.
    Transition-ids are 1 + pdf-id (identity mapping)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=num_words).astype(
        np.int64)
    total = int(lens.sum())
    num_states = 1 + total
    # chain states are 1..total, word w occupying [starts[w], starts[w]+L)
    starts = 1 + np.concatenate([[0], np.cumsum(lens[:-1])])
    # per chain-state arrays (vectorized: 10^6-arc graphs build in ms)
    word_of = np.repeat(np.arange(num_words, dtype=np.int64), lens)
    state = np.arange(1, num_states, dtype=np.int64)
    is_last = np.zeros(total, bool)
    is_last[np.cumsum(lens) - 1] = True
    pdfs = rng.integers(0, num_pdfs, size=total).astype(np.int32)
    # interleave (self-loop, forward) per state like the original layout
    e_src = np.repeat(state, 2)
    e_dst = np.repeat(state, 2)
    e_dst[1::2] = np.where(is_last, 0, state + 1)
    e_il = np.repeat(pdfs + 1, 2)
    e_ol = np.zeros(2 * total, np.int64)
    e_ol[1::2] = np.where(is_last, word_of + 1, 0)
    # distinct unigram costs (exact ties between word hypotheses make
    # top-K vs keep-all-ties pruning diverge, which is noise, not signal)
    lm_cost = np.log(num_words) + rng.uniform(-1.0, 1.0, size=num_words)

    g = CompiledGraph.__new__(CompiledGraph)
    g.num_states = num_states
    g.start = 0
    g.e_src = e_src.astype(np.int32)
    g.e_dst = e_dst.astype(np.int32)
    g.e_ilabel = e_il.astype(np.int32)
    g.e_olabel = e_ol.astype(np.int32)
    g.e_weight = np.full(2 * total, 0.7, np.float32)
    g.e_pdf = (g.e_ilabel - 1).astype(np.int32)
    g.n_src = np.zeros(num_words, np.int32)
    g.n_dst = starts.astype(np.int32)
    g.n_olabel = np.zeros(num_words, np.int32)
    g.n_weight = lm_cost.astype(np.float32)
    g.final = np.where(np.arange(num_states) == 0, 0.0,
                       np.inf).astype(np.float32)
    return g


def sample_loglikes(graph: CompiledGraph, num_pdfs: int, T: int,
                    seed: int = 0, peak: float = 4.0) -> np.ndarray:
    """Loglikes [T, P] with a random walk along the graph boosted, so
    decodes follow a plausible path rather than noise."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-8.0, 1.0, size=(T, num_pdfs)).astype(np.float32)
    # walk: hub -> random word chain, boosting visited pdfs
    off = np.argsort(graph.e_src, kind="stable")
    src_sorted = graph.e_src[off]
    starts = np.searchsorted(src_sorted, np.arange(graph.num_states))
    ends = np.searchsorted(src_sorted, np.arange(graph.num_states) + 1)
    n_off = np.argsort(graph.n_src, kind="stable")
    nsrc_sorted = graph.n_src[n_off]
    nstarts = np.searchsorted(nsrc_sorted, np.arange(graph.num_states))
    nends = np.searchsorted(nsrc_sorted, np.arange(graph.num_states) + 1)
    s = graph.start
    for t in range(T):
        while starts[s] == ends[s]:           # non-emitting: follow eps
            k = rng.integers(nstarts[s], nends[s])
            s = int(graph.n_dst[n_off[k]])
        k = rng.integers(starts[s], ends[s])
        a = off[k]
        ll[t, graph.e_pdf[a]] = rng.normal(-peak * 0.25, 0.3)
        s = int(graph.e_dst[a])
    return ll
