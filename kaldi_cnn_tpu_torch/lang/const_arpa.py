"""Const-ARPA language model: an immutable, array-packed n-gram LM for
fast lattice rescoring.

Clean-room equivalent of the reference's const-arpa layer
(ref: src/lm/const-arpa-lm.{h,cc} ConstArpaLm; used by
latbin/lattice-lmrescore-const-arpa.cc).  The reference packs the
n-gram trie into a flat int32 image that is mmap-able and queried
without allocation; here the same idea is realized as sorted numpy
key arrays per order, queried by binary search (``np.searchsorted``)
— immutable, compact, picklable to npz, and vectorizable.

Keys pack a word-id n-gram into one int64 (base = vocab_size + 1,
most-recent word in the lowest digit), so a whole batch of queries is
one searchsorted per order.  Probabilities are kept in natural log
(the reference converts ARPA log10 on read the same way).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.lang.arpa import LOG10, ArpaLm

_NEG_INF = float("-inf")


@dataclass
class ConstArpaLm:
    """Immutable n-gram LM over integer word ids.

    orders[k] holds three parallel arrays for (k+1)-grams sorted by
    packed key: keys (int64), logprobs (f64, natural log), backoffs
    (f64, natural log; 0 where absent).
    """

    vocab: Dict[str, int]              # word -> id (ids < base - 1)
    base: int                          # packing base (> max word id)
    keys: List[np.ndarray]             # per order, sorted int64
    logp: List[np.ndarray]             # per order, natural log prob
    bow: List[np.ndarray]              # per order, natural log backoff
    bos_id: int
    eos_id: int

    @property
    def max_order(self) -> int:
        return len(self.keys)

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_arpa(lm: ArpaLm, vocab: Optional[Dict[str, int]] = None,
                  bos: str = "<s>", eos: str = "</s>") -> "ConstArpaLm":
        """Build from a parsed ARPA table.  ``vocab`` may map words to
        existing ids (e.g. the decoding word table); missing words get
        fresh ids; OOV queries score as -inf like the reference."""
        vocab = dict(vocab or {})
        for table in lm.orders:
            for ng in table:
                for w in ng:
                    if w not in vocab:
                        vocab[w] = (max(vocab.values()) + 1) if vocab else 1
        for special in (bos, eos):
            if special not in vocab:
                vocab[special] = max(vocab.values()) + 1
        base = max(vocab.values()) + 2
        if base ** lm.max_order >= 2 ** 62:
            raise ValueError("vocab too large for int64 n-gram packing")
        keys, logp, bow = [], [], []
        for k, table in enumerate(lm.orders):
            ks = np.empty(len(table), np.int64)
            lp = np.empty(len(table), np.float64)
            bo = np.zeros(len(table), np.float64)
            for i, (ng, (logp10, backoff10)) in enumerate(table.items()):
                key = 0
                for w in ng:
                    key = key * base + vocab[w] + 1
                ks[i] = key
                lp[i] = logp10 * LOG10
                bo[i] = backoff10 * LOG10
            order = np.argsort(ks)
            keys.append(ks[order])
            logp.append(lp[order])
            bow.append(bo[order])
        return ConstArpaLm(vocab, base, keys, logp, bow,
                           vocab[bos], vocab[eos])

    # -- lookup -----------------------------------------------------------

    def _pack(self, ids: Sequence[int]) -> int:
        key = 0
        for w in ids:
            key = key * self.base + int(w) + 1
        return key

    def _find(self, order_k: int, key: int) -> int:
        """Index of key in orders[k] or -1."""
        ks = self.keys[order_k]
        i = int(np.searchsorted(ks, key))
        if i < len(ks) and ks[i] == key:
            return i
        return -1

    def log_prob(self, hist: Sequence[int], word: int) -> float:
        """Natural-log p(word | hist) with standard ARPA backoff
        (ref: const-arpa-lm.cc ConstArpaLm::GetNgramLogprob)."""
        hist = list(hist)[-(self.max_order - 1):] if self.max_order > 1 \
            else []
        while True:
            ng = hist + [word]
            i = self._find(len(ng) - 1, self._pack(ng))
            if i >= 0:
                return float(self.logp[len(ng) - 1][i])
            if not hist:
                return _NEG_INF  # true OOV
            j = self._find(len(hist) - 1, self._pack(hist))
            bo = float(self.bow[len(hist) - 1][j]) if j >= 0 else 0.0
            hist = hist[1:]
            # accumulate backoff and recurse iteratively
            p = self.log_prob(hist, word)
            return bo + p

    def sentence_logprob(self, words: Sequence[int]) -> float:
        """Natural-log probability of a sentence, bos/eos included
        (the quantity lattice rescoring distributes over arcs)."""
        hist = [self.bos_id]
        total = 0.0
        for w in list(words) + [self.eos_id]:
            total += self.log_prob(hist, w)
            hist = (hist + [w])[-(self.max_order - 1):] \
                if self.max_order > 1 else []
        return total

    def advance(self, hist: Tuple[int, ...], word: int) -> Tuple[int, ...]:
        """Next LM history after consuming ``word`` (truncated to what
        the model can use — keeps rescoring state spaces small)."""
        h = (hist + (word,))[-(self.max_order - 1):] \
            if self.max_order > 1 else ()
        # truncate to the longest history that actually exists
        while h and self._find(len(h) - 1, self._pack(h)) < 0:
            h = h[1:]
        return h

    # -- serialization (the "const image"; ref: const-arpa mmap file) ------

    def save(self, path: str) -> None:
        blobs = {"meta": np.asarray(
            [self.base, self.bos_id, self.eos_id, self.max_order],
            np.int64)}
        words = sorted(self.vocab, key=lambda w: self.vocab[w])
        blobs["words"] = np.asarray(words)
        blobs["word_ids"] = np.asarray([self.vocab[w] for w in words],
                                       np.int64)
        for k in range(self.max_order):
            blobs[f"k{k}.keys"] = self.keys[k]
            blobs[f"k{k}.logp"] = self.logp[k]
            blobs[f"k{k}.bow"] = self.bow[k]
        np.savez_compressed(path, **blobs)

    @staticmethod
    def load(path: str) -> "ConstArpaLm":
        z = np.load(path, allow_pickle=False)
        base, bos, eos, max_order = (int(v) for v in z["meta"])
        vocab = {str(w): int(i)
                 for w, i in zip(z["words"], z["word_ids"])}
        keys = [z[f"k{k}.keys"] for k in range(max_order)]
        logp = [z[f"k{k}.logp"] for k in range(max_order)]
        bow = [z[f"k{k}.bow"] for k in range(max_order)]
        return ConstArpaLm(vocab, base, keys, logp, bow, bos, eos)
