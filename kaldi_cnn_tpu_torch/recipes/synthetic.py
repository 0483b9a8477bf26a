"""Deterministic synthetic speech corpora (jax-free twin of
``kaldi_cnn_tpu/recipes/synthetic.py``: the noisy digits corpus of the
WSJ-style recipe, the speaker corpus of the Switchboard-style one, the
clean corpus and the yes/no lexicon of the RM and yesno recipes, and the
pseudo-word lexicon of the graph-scale tests; same seeds, bit-identical
waves).

Replaces the reference's downloaded corpora (egs/yesno/s5 waves etc.)
in this offline environment: each phone gets a stable formant-like
spectral signature, words are phone concatenations per the lexicon,
utterances are word sequences with silence padding.  The corpus is a
function of the seed only, so recipes and tests are exactly
reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.lang.lexicon import Lexicon
from kaldi_cnn_tpu_torch.core.rng import np_rng

SAMPLE_RATE = 8000


_FORMANT_MAPS: dict = {}


def formant_map(phones) -> dict:
    """phone -> 3 formants, assigned on a spread grid over the actual
    inventory so every pair of phones is guaranteed well separated in
    at least the first band (random draws collided: two phones within
    ~40 Hz made repeated words acoustically mergeable).  Deterministic
    in the sorted phone list only."""
    key = tuple(sorted(phones))
    if key in _FORMANT_MAPS:
        return _FORMANT_MAPS[key]
    n_levels = 7
    out = {}
    for i, p in enumerate(key):
        l1 = (5 * i) % n_levels
        l2 = (3 * (i // n_levels) + 2 * i) % n_levels
        l3 = (i // n_levels ** 2 + i) % n_levels
        out[p] = [350 + 125.0 * l1,    # 350..1100
                  1250 + 160.0 * l2,   # 1250..2210
                  2350 + 160.0 * l3]   # 2350..3310
    _FORMANT_MAPS[key] = out
    return out


def _phone_formants(phone: str, rng: np.random.Generator,
                    fmap: Optional[dict] = None) -> List[float]:
    if fmap is not None and phone in fmap:
        return fmap[phone]
    # fallback: stable hash draw (hashlib — hash() is per-process salted)
    import hashlib
    h = int.from_bytes(hashlib.sha256(phone.encode()).digest()[:4], "little")
    r = np.random.default_rng(h)
    return [300 + 800 * r.random(),
            1200 + 1100 * r.random(),
            2400 + 1100 * r.random()]


def render_phone(phone: str, dur_samples: int,
                 rng: np.random.Generator,
                 fmap: Optional[dict] = None) -> np.ndarray:
    t = np.arange(dur_samples) / SAMPLE_RATE
    if phone == "SIL":
        return rng.normal(0, 40, dur_samples).astype(np.float32)
    x = np.zeros(dur_samples)
    for i, f in enumerate(_phone_formants(phone, rng, fmap)):
        f = min(f, 0.45 * SAMPLE_RATE)
        vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 3.0 * t + rng.random())
        x += (2000.0 / (i + 1)) * np.sin(2 * np.pi * f * vibrato * t
                                         + 2 * np.pi * rng.random())
    # amplitude envelope to avoid clicks
    env = np.minimum(1.0, np.minimum(np.arange(dur_samples),
                                     dur_samples - np.arange(dur_samples))
                     / (0.01 * SAMPLE_RATE))
    x = x * env + rng.normal(0, 60, dur_samples)
    return x.astype(np.float32)


def render_utterance(words: Sequence[str], lex: Lexicon,
                     rng: np.random.Generator,
                     sil_prob: float = 0.5,
                     fmap: Optional[dict] = None) -> np.ndarray:
    if fmap is None:
        fmap = formant_map(lex.phones)
    segs = [render_phone("SIL", int(0.15 * SAMPLE_RATE), rng)]
    for w in words:
        pron = lex.entries[w][0][0]
        for p in pron:
            dur = int((0.10 + 0.08 * rng.random()) * SAMPLE_RATE)
            segs.append(render_phone(p, dur, rng, fmap))
        if rng.random() < sil_prob:
            segs.append(render_phone(
                "SIL", int((0.08 + 0.1 * rng.random()) * SAMPLE_RATE), rng))
    segs.append(render_phone("SIL", int(0.15 * SAMPLE_RATE), rng))
    return np.concatenate(segs)


@dataclass
class SyntheticCorpus:
    lexicon: Lexicon
    word_probs: Dict[str, float]
    waves: Dict[str, np.ndarray]          # utt -> waveform (int16 range)
    transcripts: Dict[str, List[str]]     # utt -> word list
    sample_rate: int = SAMPLE_RATE

    def split(self, test_fraction: float = 0.25
              ) -> Tuple["SyntheticCorpus", "SyntheticCorpus"]:
        utts = sorted(self.waves)
        n_test = max(1, int(len(utts) * test_fraction))
        test_utts = set(utts[-n_test:])
        def pick(sel):
            return SyntheticCorpus(
                self.lexicon, self.word_probs,
                {u: self.waves[u] for u in utts if (u in test_utts) == sel},
                {u: self.transcripts[u] for u in utts
                 if (u in test_utts) == sel},
                self.sample_rate)
        return pick(False), pick(True)

    def subset(self, utts) -> "SyntheticCorpus":
        keep = set(utts)
        return SyntheticCorpus(
            self.lexicon, self.word_probs,
            {u: w for u, w in self.waves.items() if u in keep},
            {u: t for u, t in self.transcripts.items() if u in keep},
            self.sample_rate)


def make_corpus(
    lexicon: Lexicon,
    word_probs: Dict[str, float],
    num_utts: int,
    min_words: int = 1,
    max_words: int = 4,
    seed: int = 17,
) -> SyntheticCorpus:
    rng = np_rng(seed, "synthetic_corpus")
    words = sorted(word_probs)
    probs = np.array([word_probs[w] for w in words])
    probs = probs / probs.sum()
    waves, trans = {}, {}
    for i in range(num_utts):
        n = int(rng.integers(min_words, max_words + 1))
        ws = [words[int(k)] for k in rng.choice(len(words), size=n, p=probs)]
        utt = f"utt{i:04d}"
        waves[utt] = render_utterance(ws, lexicon, rng)
        trans[utt] = ws
    return SyntheticCorpus(lexicon, word_probs, waves, trans)


def make_noisy_corpus(
    lexicon: Lexicon,
    word_probs: Dict[str, float],
    num_utts: int,
    min_words: int = 1,
    max_words: int = 4,
    seed: int = 17,
    noise_std: float = 250.0,
    formant_jitter: float = 0.08,
) -> SyntheticCorpus:
    """Hardened corpus for a meaningful WER ledger: per-utterance
    formant scaling (a spectral shift, the invariance the fork's CNN
    frequency pooling exists to absorb) plus additive noise.  Unlike
    make_corpus — whose clean, fixed-formant phones saturate every
    acoustic model to 0% WER — recognition here degrades smoothly with
    noise_std/formant_jitter, so WER discriminates between model
    configurations (the RESULTS-regression requirement; ref: the
    reference's egs/*/s5/RESULTS ledgers track non-trivial WERs)."""
    rng = np_rng(seed, "noisy_corpus")
    base = formant_map(lexicon.phones)
    words = sorted(word_probs)
    probs = np.array([word_probs[w] for w in words])
    probs = probs / probs.sum()
    waves, trans = {}, {}
    for i in range(num_utts):
        scale = 1.0 + formant_jitter * (2.0 * rng.random() - 1.0)
        fmap = {p: [f * scale for f in fs] for p, fs in base.items()}
        n = int(rng.integers(min_words, max_words + 1))
        ws = [words[int(k)]
              for k in rng.choice(len(words), size=n, p=probs)]
        utt = f"utt{i:04d}"
        w = render_utterance(ws, lexicon, rng, fmap=fmap)
        waves[utt] = (w + rng.normal(0, noise_std, len(w))
                      ).astype(np.float32)
        trans[utt] = ws
    return SyntheticCorpus(lexicon, word_probs, waves, trans)


def make_speaker_corpus(
    lexicon: Lexicon,
    word_probs: Dict[str, float],
    num_speakers: int,
    utts_per_speaker: int,
    min_words: int = 1,
    max_words: int = 4,
    seed: int = 17,
    vtl_spread: float = 0.12,
) -> Tuple[SyntheticCorpus, Dict[str, str]]:
    """Corpus with per-speaker formant scaling (a vocal-tract-length
    analogue) — gives speaker adaptation (fMLLR, iVectors) something
    real to model.  Returns (corpus, utt -> speaker map)."""
    rng = np_rng(seed, "speaker_corpus")
    base = formant_map(lexicon.phones)
    words = sorted(word_probs)
    probs = np.array([word_probs[w] for w in words])
    probs = probs / probs.sum()
    waves, trans, spk_of = {}, {}, {}
    for s in range(num_speakers):
        scale = 1.0 + vtl_spread * (2.0 * rng.random() - 1.0)
        fmap = {p: [f * scale for f in fs] for p, fs in base.items()}
        for j in range(utts_per_speaker):
            n = int(rng.integers(min_words, max_words + 1))
            ws = [words[int(k)]
                  for k in rng.choice(len(words), size=n, p=probs)]
            utt = f"spk{s:02d}_utt{j:03d}"
            waves[utt] = render_utterance(ws, lexicon, rng, fmap=fmap)
            trans[utt] = ws
            spk_of[utt] = f"spk{s:02d}"
    return (SyntheticCorpus(lexicon, word_probs, waves, trans), spk_of)


def large_lexicon(num_words: int = 60, seed: int = 7) -> Lexicon:
    """Pseudo-word lexicon over a 20-phone inventory for graph-scale
    tests (3-5 phones per word, unique pronunciations)."""
    phones = ["AA", "AE", "AH", "AO", "AY", "EH", "EY", "IH", "IY",
              "OW", "UW", "B", "D", "F", "K", "M", "N", "R", "S", "T"]
    rng = np_rng(seed, "large_lexicon")
    entries = {}
    seen = set()
    i = 0
    while len(entries) < num_words:
        n = int(rng.integers(3, 6))
        pron = tuple(phones[int(k)]
                     for k in rng.integers(0, len(phones), n))
        if pron in seen:
            continue
        seen.add(pron)
        entries[f"word{i:03d}"] = [(list(pron), 1.0)]
        i += 1
    return Lexicon(entries=entries, silence_phone="SIL",
                   optional_silence_prob=0.5)


def yesno_lexicon() -> Lexicon:
    return Lexicon(entries={
        "yes": [(["Y", "EH", "S"], 1.0)],
        "no": [(["N", "OW"], 1.0)],
    }, silence_phone="SIL", optional_silence_prob=0.5)


def digits_lexicon() -> Lexicon:
    """A slightly larger vocabulary for rm-style tests."""
    entries = {
        "one": [(["W", "AH", "N"], 1.0)],
        "two": [(["T", "UW"], 1.0)],
        "three": [(["TH", "R", "IY"], 1.0)],
        "four": [(["F", "AO", "R"], 1.0)],
        "five": [(["F", "AY", "V"], 1.0)],
        "six": [(["S", "IH", "K"], 1.0)],
        "seven": [(["S", "EH", "V", "AH", "N"], 1.0)],
        "eight": [(["EY", "T"], 1.0)],
        "nine": [(["N", "AY", "N"], 1.0)],
        "zero": [(["Z", "IH", "R", "OW"], 1.0)],
    }
    return Lexicon(entries=entries, silence_phone="SIL",
                   optional_silence_prob=0.5)
