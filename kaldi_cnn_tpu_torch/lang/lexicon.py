"""Lexicon -> L transducer with disambiguation symbols and optional
silence (ref: utils/prepare_lang.sh, utils/make_lexicon_fst.pl,
utils/add_lex_disambig.pl).

L maps phone sequences (input tape) to words (output tape).  The
word-level LM-backoff disambiguator #0 passes through L via a self-loop
at the loop state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_cnn_tpu_torch.lang.fst import EPS, Fst
from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable


@dataclass
class Lexicon:
    """words -> list of (pronunciation phone list, probability)."""

    entries: Dict[str, List[Tuple[List[str], float]]]
    silence_phone: Optional[str] = "SIL"
    optional_silence_prob: float = 0.5

    @property
    def phones(self) -> List[str]:
        out = set()
        for prons in self.entries.values():
            for pron, _ in prons:
                out.update(pron)
        if self.silence_phone:
            out.add(self.silence_phone)
        return sorted(out)

    @property
    def words(self) -> List[str]:
        return sorted(self.entries)

    def make_symbol_tables(self, num_extra_disambig: int = 0
                           ) -> Tuple[SymbolTable, SymbolTable, int]:
        """Returns (phone_table, word_table, num_disambig).

        Phone table layout: real phones, then #0..#N disambig symbols.
        Word table: words, then #0 (LM backoff), then <s>, </s> are NOT
        included (they never appear on G arcs).
        """
        ndis = self._num_disambig() + 1  # +1 for #0
        ndis = max(ndis, num_extra_disambig + 1)
        phone_table = SymbolTable(self.phones)
        for k in range(ndis):
            phone_table.add(f"#{k}")
        word_table = SymbolTable(self.words)
        word_table.add("#0")
        return phone_table, word_table, ndis

    def _disambig_assignment(self) -> Dict[Tuple[str, Tuple[str, ...]], int]:
        """Assign disambig symbol index (>=1) to pronunciations needing one:
        duplicates and prons that are prefixes of other prons
        (ref: utils/add_lex_disambig.pl)."""
        pron_count: Dict[Tuple[str, ...], int] = {}
        prefixes = set()
        for word, prons in self.entries.items():
            for pron, _ in prons:
                t = tuple(pron)
                pron_count[t] = pron_count.get(t, 0) + 1
                for i in range(1, len(t)):
                    prefixes.add(t[:i])
        assignment: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        next_idx: Dict[Tuple[str, ...], int] = {}
        for word in sorted(self.entries):
            for pron, _ in self.entries[word]:
                t = tuple(pron)
                if pron_count[t] > 1 or t in prefixes:
                    # first free disambig >= 1 for this pron
                    idx = next_idx.get(t, 1)
                    assignment[(word, t)] = idx
                    next_idx[t] = idx + 1
        return assignment

    def _num_disambig(self) -> int:
        a = self._disambig_assignment()
        return max(a.values()) if a else 0


def make_lexicon_fst(
    lex: Lexicon,
    phone_table: SymbolTable,
    word_table: SymbolTable,
) -> Fst:
    """Build L with optional silence and disambig symbols
    (ref: utils/make_lexicon_fst.pl with --sil-prob)."""
    f = Fst()
    sil_prob = lex.optional_silence_prob if lex.silence_phone else 0.0
    sil_cost = -math.log(sil_prob) if sil_prob > 0 else 0.0
    no_sil_cost = -math.log(1.0 - sil_prob) if sil_prob > 0 else 0.0

    start = f.add_state()
    loop = f.add_state()
    f.start = start
    f.set_final(loop, 0.0)
    assignment = lex._disambig_assignment()

    if lex.silence_phone and sil_prob > 0:
        sil_id = phone_table.id(lex.silence_phone)
        sil_state = f.add_state()
        f.add_arc(start, EPS, EPS, no_sil_cost, loop)
        f.add_arc(start, sil_id, EPS, sil_cost, loop)
        # after-word optional silence
        f.add_arc(sil_state, sil_id, EPS, 0.0, loop)
    else:
        f.add_arc(start, EPS, EPS, 0.0, loop)
        sil_state = None

    for word in sorted(lex.entries):
        wid = word_table.id(word)
        for pron, prob in lex.entries[word]:
            pron_cost = -math.log(max(prob, 1e-10))
            labels = [phone_table.id(p) for p in pron]
            dis = assignment.get((word, tuple(pron)))
            if dis is not None:
                labels = labels + [phone_table.id(f"#{dis}")]
            cur = loop
            for i, pl in enumerate(labels):
                ol = wid if i == 0 else EPS
                w = pron_cost if i == 0 else 0.0
                if i == len(labels) - 1:
                    # last phone: branch to loop (no sil) / sil_state
                    if sil_state is not None:
                        f.add_arc(cur, pl, ol, w + no_sil_cost, loop)
                        f.add_arc(cur, pl, ol, w + sil_cost, sil_state)
                    else:
                        f.add_arc(cur, pl, ol, w, loop)
                else:
                    nxt = f.add_state()
                    f.add_arc(cur, pl, ol, w, nxt)
                    cur = nxt
    # word-level backoff disambig #0 passes through at the loop state
    if "#0" in word_table and "#0" in phone_table:
        f.add_arc(loop, phone_table.id("#0"), word_table.id("#0"), 0.0, loop)
    return f.arcsort("olabel")
