"""ARPA n-gram LM parsing and G-FST construction.

Clean-room equivalent of the reference's arpa2fst
(ref: src/lm/arpa-file-parser / arpa-lm-compiler era; utils/format_lm.sh):
states are n-gram histories, word arcs carry -log(prob) costs, backoff
arcs carry the backoff cost with ilabel #0 (the word-level disambig, so
LG stays determinizable), olabel epsilon.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kaldi_cnn_tpu_torch.lang.fst import EPS, Fst
from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable

LOG10 = math.log(10.0)


@dataclass
class ArpaLm:
    orders: List[Dict[Tuple[str, ...], Tuple[float, float]]]
    # orders[k][ngram] = (logprob10, backoff10); ngram is a tuple of words

    @property
    def max_order(self) -> int:
        return len(self.orders)


def parse_arpa(text: str) -> ArpaLm:
    orders: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
    cur: Optional[Dict] = None
    section_order = 0
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("\\") and line.endswith("-grams:"):
            section_order = int(line[1:].split("-")[0])
            while len(orders) < section_order:
                orders.append({})
            cur = orders[section_order - 1]
            continue
        if line.startswith("\\end\\") or line.startswith("\\data\\") \
                or line.startswith("ngram "):
            cur = None if line.startswith("\\end\\") else cur
            if line.startswith("\\data\\") or line.startswith("ngram "):
                cur = None
            continue
        if cur is None:
            continue
        parts = line.split()
        logp = float(parts[0])
        words = tuple(parts[1:1 + section_order])
        backoff = 0.0
        if len(parts) > 1 + section_order:
            backoff = float(parts[1 + section_order])
        cur[words] = (logp, backoff)
    return ArpaLm(orders)


def arpa_to_fst(lm: ArpaLm, word_table: SymbolTable,
                bos: str = "<s>", eos: str = "</s>") -> Fst:
    """Build G as a WFSA over word ids (ilabel == olabel == word;
    backoff arcs #0:eps)."""
    f = Fst()
    backoff_label = word_table.id("#0") if "#0" in word_table else EPS
    # history states: tuple of words (most recent last), truncated to
    # max_order-1
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        while hist and hist not in _hists:
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = f.add_state()
        return state_of[hist]

    # valid histories: all ngrams of order < max that have a continuation
    # or a backoff; plus the empty history
    _hists = {()}
    for k in range(lm.max_order - 1):
        for ng in lm.orders[k]:
            _hists.add(ng)

    start_hist = (bos,) if (bos,) in _hists else ()
    f.start = get_state(start_hist)

    for k, table in enumerate(lm.orders):
        order = k + 1
        for ng, (logp10, backoff10) in table.items():
            word = ng[-1]
            hist = ng[:-1]
            cost = -logp10 * LOG10
            src = get_state(hist)
            if word == eos:
                f.final[src] = min(f.final[src], cost)
                continue
            if word == bos:
                # <s> unigram: no arc; its backoff is handled below
                pass
            else:
                if word not in word_table:
                    continue  # OOV in lexicon; skip
                wid = word_table.id(word)
                if order < lm.max_order and ng in _hists:
                    dst = get_state(ng)
                else:
                    dst = get_state(ng[1:])
                f.add_arc(src, wid, wid, cost, dst)
            # backoff arc from the state FOR this ngram (if it's a history)
        for ng, (logp10, backoff10) in table.items():
            if order < lm.max_order and ng in _hists:
                src = get_state(ng)
                dst = get_state(ng[1:])
                bo_cost = -backoff10 * LOG10
                f.add_arc(src, backoff_label, EPS, bo_cost, dst)
    return f.connect().arcsort("ilabel")


def estimate_bigram_arpa(transcripts, discount: float = 0.5) -> str:
    """Absolute-discounted bigram LM with backoff from training
    transcripts (ref: the train_lm.sh-era Good-Turing/Kneser-Ney
    pipelines, simplified to absolute discounting — enough for the
    recipe-scale graphs)."""
    uni: Dict[str, float] = {}
    bi: Dict[tuple, float] = {}
    for words in (transcripts.values()
                  if isinstance(transcripts, dict) else transcripts):
        seq = ["<s>"] + list(words) + ["</s>"]
        for w in seq[1:]:
            uni[w] = uni.get(w, 0.0) + 1.0
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] = bi.get((a, b), 0.0) + 1.0
    uni_total = sum(uni.values())
    vocab = sorted(set(uni) | {"<s>"})
    # unigram probs (with <s> given prob ~0 as in ARPA convention)
    uprob = {w: max(uni.get(w, 0.0), 0.01) / uni_total for w in vocab}
    # bigram with absolute discounting; backoff weight per history
    hist_count: Dict[str, float] = {}
    hist_types: Dict[str, int] = {}
    for (a, b), c in bi.items():
        hist_count[a] = hist_count.get(a, 0.0) + c
        hist_types[a] = hist_types.get(a, 0) + 1
    lines = ["\\data\\", f"ngram 1={len(vocab)}",
             f"ngram 2={len(bi)}", "", "\\1-grams:"]
    for w in vocab:
        lp = -99.0 if w == "<s>" else math.log10(uprob[w])
        if w in hist_count:
            bow = (discount * hist_types[w]) / hist_count[w]
            lines.append(f"{lp:.6f} {w} {math.log10(max(bow, 1e-10)):.6f}")
        else:
            lines.append(f"{lp:.6f} {w}")
    lines += ["", "\\2-grams:"]
    for (a, b), c in sorted(bi.items()):
        p = (c - discount) / hist_count[a]
        lines.append(f"{math.log10(max(p, 1e-10)):.6f} {a} {b}")
    lines += ["", "\\end\\"]
    return "\n".join(lines)


def make_unigram_arpa(word_probs: Dict[str, float]) -> str:
    """Tiny helper to synthesize a unigram ARPA text for test recipes."""
    n = len(word_probs) + 2
    lines = ["\\data\\", f"ngram 1={n}", "", "\\1-grams:"]
    total = sum(word_probs.values())
    # reserve a little mass for </s>
    eos_p = 0.5 / (len(word_probs) + 1)
    scale = (1.0 - eos_p) / total
    lines.append(f"{math.log10(eos_p):.6f} </s>")
    lines.append("-99 <s>")
    for w, p in sorted(word_probs.items()):
        lines.append(f"{math.log10(p * scale):.6f} {w}")
    lines += ["", "\\end\\"]
    return "\n".join(lines)
