"""Kaldi data-directory adapter.

The reference drives every recipe from a "data dir": a directory of
whitespace-separated key/value text maps — ``wav.scp`` (utterance ->
wave rxfilename, possibly a shell pipe), ``text`` (utterance ->
transcript), ``utt2spk``/``spk2utt``, optional ``segments``
(utterance -> recording start end), optional ``feats.scp``/``cmvn.scp``
(ref: egs/wsj/s5/run.sh data prep, utils/validate_data_dir.sh,
utils/fix_data_dir.sh, utils/split_data.sh).

This module reads/validates/splits/writes that exact format so the
moment a real corpus appears the existing recipes can be pointed at it
(``python -m kaldi_cnn_tpu_torch.recipes.wsj --data-dir <dir>``), and exports
an interop path that consumes externally produced ark alignments /
features for differential testing against the reference
(SURVEY.md §7 "Hard parts #2").
"""

from __future__ import annotations

import os
import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.io.wave import read_wave, write_wave
from kaldi_cnn_tpu_torch.lang.lexicon import Lexicon

logger = get_logger(__name__)


# ---------------------------------------------------------------- parsing

def read_key_value_file(path: str) -> Dict[str, str]:
    """Parse a Kaldi map file: one ``key rest-of-line`` entry per line,
    sorted-unique keys enforced downstream by validate()."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 1)
            key = parts[0]
            out[key] = parts[1] if len(parts) > 1 else ""
    return out


def write_key_value_file(path: str, mapping: Dict[str, str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for k in sorted(mapping):
            f.write(f"{k} {mapping[k]}\n".rstrip() + "\n")


def spk2utt_from_utt2spk(utt2spk: Dict[str, str]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for utt in sorted(utt2spk):
        out.setdefault(utt2spk[utt], []).append(utt)
    return out


@dataclass
class Segment:
    recording: str
    start: float
    end: float


# ---------------------------------------------------------------- DataDir

@dataclass
class DataDir:
    """In-memory image of a Kaldi data directory."""
    path: str
    wav_scp: Dict[str, str]                 # recording-id -> rxfilename/pipe
    text: Dict[str, List[str]]              # utt -> word list
    utt2spk: Dict[str, str]
    segments: Optional[Dict[str, Segment]] = None
    feats_scp: Optional[Dict[str, str]] = None

    # ------------------------------------------------------------ loading
    @classmethod
    def load(cls, path: str) -> "DataDir":
        def p(name):
            return os.path.join(path, name)
        if not os.path.isfile(p("wav.scp")) and not os.path.isfile(
                p("feats.scp")):
            raise FileNotFoundError(
                f"{path}: neither wav.scp nor feats.scp exists")
        wav = (read_key_value_file(p("wav.scp"))
               if os.path.isfile(p("wav.scp")) else {})
        text = {u: t.split() for u, t in
                read_key_value_file(p("text")).items()} \
            if os.path.isfile(p("text")) else {}
        utt2spk = read_key_value_file(p("utt2spk")) \
            if os.path.isfile(p("utt2spk")) else {}
        segments = None
        if os.path.isfile(p("segments")):
            segments = {}
            for utt, rest in read_key_value_file(p("segments")).items():
                reco, start, end = rest.split()
                segments[utt] = Segment(reco, float(start), float(end))
        feats = read_key_value_file(p("feats.scp")) \
            if os.path.isfile(p("feats.scp")) else None
        return cls(path=path, wav_scp=wav, text=text, utt2spk=utt2spk,
                   segments=segments, feats_scp=feats)

    # ---------------------------------------------------------- utterances
    def utts(self) -> List[str]:
        if self.segments is not None:
            return sorted(self.segments)
        if self.feats_scp:
            return sorted(self.feats_scp)
        return sorted(self.wav_scp)

    @property
    def spk2utt(self) -> Dict[str, List[str]]:
        return spk2utt_from_utt2spk(self.utt2spk)

    # ---------------------------------------------------------- validation
    def validate(self, fix: bool = False) -> List[str]:
        """utils/validate_data_dir.sh semantics: every utterance must be
        covered by all maps; with fix=True, drop utterances missing from
        any map (utils/fix_data_dir.sh) and return the messages."""
        issues: List[str] = []
        utts = set(self.utts())
        maps = {"text": set(self.text), "utt2spk": set(self.utt2spk)}
        bad_seg_utts: set = set()
        if self.segments is not None:
            missing_reco = {s.recording for s in self.segments.values()
                            } - set(self.wav_scp)
            if missing_reco:
                issues.append(
                    f"segments reference missing recordings: "
                    f"{sorted(missing_reco)[:5]}")
                bad_seg_utts = {u for u, s in self.segments.items()
                                if s.recording in missing_reco}
        for name, keys in maps.items():
            if not keys:
                continue
            only_here = sorted(utts - keys)
            only_there = sorted(keys - utts)
            if only_here:
                issues.append(f"{len(only_here)} utts missing from {name} "
                              f"(e.g. {only_here[:3]})")
            if only_there:
                issues.append(f"{len(only_there)} utts only in {name} "
                              f"(e.g. {only_there[:3]})")
        if fix and issues:
            # also drop segments whose recording is absent from wav.scp
            # (fix_data_dir.sh removes them; without this, load_wave
            # later fails with a raw KeyError on the recording id)
            keep = (utts - bad_seg_utts) & (set(self.text) or utts) & \
                (set(self.utt2spk) or utts)
            self.text = {u: w for u, w in self.text.items() if u in keep}
            self.utt2spk = {u: s for u, s in self.utt2spk.items()
                            if u in keep}
            if self.segments is not None:
                self.segments = {u: s for u, s in self.segments.items()
                                 if u in keep}
            elif self.feats_scp:
                self.feats_scp = {u: v for u, v in self.feats_scp.items()
                                  if u in keep}
            else:
                self.wav_scp = {u: v for u, v in self.wav_scp.items()
                                if u in keep}
        return issues

    # ------------------------------------------------------------ splitting
    def split(self, num_jobs: int) -> List["DataDir"]:
        """utils/split_data.sh: split by speaker so no speaker straddles
        jobs (required for per-speaker CMVN), balancing utterance count."""
        s2u = self.spk2utt
        buckets: List[List[str]] = [[] for _ in range(num_jobs)]
        counts = [0] * num_jobs
        for spk in sorted(s2u, key=lambda s: -len(s2u[s])):
            j = int(np.argmin(counts))
            buckets[j].extend(s2u[spk])
            counts[j] += len(s2u[spk])
        out = []
        for j, us in enumerate(buckets):
            uset = set(us)
            recos = ({self.segments[u].recording for u in us
                      if u in (self.segments or {})}
                     if self.segments is not None else uset)
            out.append(DataDir(
                path=os.path.join(self.path, f"split{num_jobs}", str(j + 1)),
                wav_scp={k: v for k, v in self.wav_scp.items()
                         if k in recos},
                text={u: w for u, w in self.text.items() if u in uset},
                utt2spk={u: s for u, s in self.utt2spk.items()
                         if u in uset},
                segments=(None if self.segments is None else
                          {u: s for u, s in self.segments.items()
                           if u in uset}),
                feats_scp=(None if self.feats_scp is None else
                           {u: v for u, v in self.feats_scp.items()
                            if u in uset})))
        return out

    # ------------------------------------------------------------- waves
    def load_wave(self, utt: str) -> Tuple[np.ndarray, float]:
        """Mono samples (int16 range) + rate for one utterance, applying
        segments slicing; wav.scp entries ending in '|' are pipes (the
        reference's extended rxfilename, util/kaldi-io.cc)."""
        reco = self.segments[utt].recording if self.segments else utt
        spec = self.wav_scp[reco].strip()
        if spec.endswith("|"):
            data = subprocess.run(
                spec[:-1], shell=True, check=True,
                stdout=subprocess.PIPE).stdout
            import io as _io
            import tempfile
            with tempfile.NamedTemporaryFile(suffix=".wav") as tf:
                tf.write(data)
                tf.flush()
                samples, rate = read_wave(tf.name)
        else:
            samples, rate = read_wave(spec)
        x = samples[0]  # channel 0, like the reference default
        if self.segments:
            seg = self.segments[utt]
            b = int(round(seg.start * rate))
            e = int(round(seg.end * rate)) if seg.end > 0 else len(x)
            x = x[b:e]
        return x, rate

    def load_waves(self) -> Tuple[Dict[str, np.ndarray], float]:
        waves: Dict[str, np.ndarray] = {}
        rate = 0.0
        for utt in self.utts():
            waves[utt], rate = self.load_wave(utt)
        return waves, rate

    # ------------------------------------------------------------ corpus
    def to_corpus(self, lexicon: Lexicon):
        """Bridge to the recipe API: returns a corpus object with the
        same shape as recipes.synthetic.SyntheticCorpus (waves dict,
        transcripts dict, lexicon, unigram word_probs estimated from
        the transcripts)."""
        from kaldi_cnn_tpu_torch.recipes.synthetic import SyntheticCorpus
        waves, rate = self.load_waves()
        counts: Dict[str, float] = {w: 1.0 for w in lexicon.entries}
        for words in self.text.values():
            for w in words:
                if w in counts:
                    counts[w] += 1.0
        total = sum(counts.values())
        word_probs = {w: c / total for w, c in counts.items()}
        transcripts = {u: list(self.text.get(u, [])) for u in waves}
        return SyntheticCorpus(lexicon, word_probs, waves, transcripts,
                               sample_rate=int(rate))


# ------------------------------------------------------------------ writing

def write_data_dir(path: str, waves: Dict[str, np.ndarray],
                   transcripts: Dict[str, List[str]],
                   utt2spk: Optional[Dict[str, str]] = None,
                   sample_rate: float = 8000.0) -> DataDir:
    """Materialise a corpus as an on-disk Kaldi data dir (wav files +
    wav.scp/text/utt2spk/spk2utt) — used by tests and by recipe export."""
    wav_dir = os.path.join(path, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wav_scp: Dict[str, str] = {}
    for utt in sorted(waves):
        wpath = os.path.join(wav_dir, f"{utt}.wav")
        write_wave(wpath, waves[utt], sample_rate)
        wav_scp[utt] = wpath
    if utt2spk is None:
        utt2spk = {u: f"spk_{u}" for u in waves}
    write_key_value_file(os.path.join(path, "wav.scp"), wav_scp)
    write_key_value_file(os.path.join(path, "text"),
                         {u: " ".join(t) for u, t in transcripts.items()})
    write_key_value_file(os.path.join(path, "utt2spk"), utt2spk)
    write_key_value_file(
        os.path.join(path, "spk2utt"),
        {s: " ".join(us)
         for s, us in spk2utt_from_utt2spk(utt2spk).items()})
    return DataDir(path=path, wav_scp=wav_scp,
                   text={u: list(t) for u, t in transcripts.items()},
                   utt2spk=dict(utt2spk))


# ------------------------------------------------------------------ lexicon

def read_lexicon_file(path: str, silence_phone: str = "SIL",
                      optional_silence_prob: float = 0.5) -> Lexicon:
    """data/local/dict/lexicon.txt format: ``word ph1 ph2 ...`` with
    optional probabilistic variant ``word prob ph1 ...``
    (lexiconp.txt).  The second column is treated as a pronunciation
    probability only when it parses as a float in (0, 1] — Kaldi's
    lexiconp domain — AND is not also a phone seen elsewhere in column
    >=2; lexicons with numeric phone symbols are therefore not
    misparsed."""
    raw: List[Tuple[str, List[str]]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            raw.append((parts[0], parts[1:]))
    # a token can be a lexiconp probability only if every entry's second
    # column is such a float (lexiconp files are all-or-nothing) — this
    # keeps numeric phone symbols like "1"/"2" (tone phones) intact
    def _prob_like(tok: str) -> bool:
        try:
            v = float(tok)
        except ValueError:
            return False
        return 0.0 < v <= 1.0 and tok.lower() not in ("nan", "inf")
    is_lexiconp = bool(raw) and all(
        rest and _prob_like(rest[0]) and len(rest) > 1
        for _, rest in raw)
    entries: Dict[str, List[Tuple[List[str], float]]] = {}
    for word, rest in raw:
        prob = 1.0
        if is_lexiconp:
            prob = float(rest[0])
            rest = rest[1:]
        entries.setdefault(word, []).append((rest, prob))
    return Lexicon(entries=entries, silence_phone=silence_phone,
                   optional_silence_prob=optional_silence_prob)


def write_lexicon_file(path: str, lex: Lexicon) -> None:
    """Writes lexicon.txt; when any pronunciation probability differs
    from 1.0, writes lexiconp format so a round-trip preserves them."""
    any_prob = any(prob != 1.0 for prons in lex.entries.values()
                   for _, prob in prons)
    with open(path, "w", encoding="utf-8") as f:
        for word in sorted(lex.entries):
            for pron, prob in lex.entries[word]:
                if any_prob:
                    f.write(f"{word} {prob:.6g} {' '.join(pron)}\n")
                else:
                    f.write(f"{word} {' '.join(pron)}\n")


# ------------------------------------------------------- reference interop

def load_alignments_ark(rxfilename: str) -> Dict[str, np.ndarray]:
    """Externally produced transition-id alignments (the reference's
    ali.*.gz from steps/align_*.sh) for differential training: train our
    AM from the reference's alignments to isolate AM/decoder differences
    from bootstrap differences (SURVEY.md §7 Hard parts #2)."""
    from kaldi_cnn_tpu_torch.io.kaldi_io import read_vec_int_ark
    return {utt: np.asarray(v, np.int32)
            for utt, v in read_vec_int_ark(rxfilename)}


def load_feats_scp(scp_path: str) -> Dict[str, np.ndarray]:
    from kaldi_cnn_tpu_torch.io.kaldi_io import read_scp_dict
    return read_scp_dict(scp_path)


def corpus_from_data_dir(data_dir: str, lexicon_path: Optional[str] = None):
    """One-call loader used by the recipes' --data-dir flag: returns the
    corpus bridge object. The lexicon comes from
    ``<data_dir>/../local/dict/lexicon.txt`` when not given (the
    reference layout) or a ``lexicon.txt`` inside the data dir."""
    dd = DataDir.load(data_dir)
    issues = dd.validate(fix=True)
    for msg in issues:
        logger.warning("data dir %s: %s", data_dir, msg)
    if lexicon_path is None:
        for cand in (os.path.join(data_dir, "lexicon.txt"),
                     os.path.join(data_dir, os.pardir, "local", "dict",
                                  "lexicon.txt")):
            if os.path.isfile(cand):
                lexicon_path = cand
                break
    if lexicon_path is None:
        raise FileNotFoundError(
            f"no lexicon.txt found for {data_dir}; pass lexicon_path")
    lex = read_lexicon_file(lexicon_path)
    return dd.to_corpus(lex)
