"""The serving half of the WSJ-style CNN recipe
(twin of ``kaldi_cnn_tpu/recipes/wsj.py::run``, its decode phase):

  wave -> 36-bin fbank + deltas as (t, f, c) volumes   (fbank kernel)
       -> splice +-5 -> CNN acoustic model             (conv+maxpool kernel)
       -> pseudo log-likelihoods -> top-K beam search -> words -> WER

Training and the lattice path (decode_utterances, the rescoring sweep)
are not ported yet: ``decode`` takes the best path of
``TopKDecoder.decode_batch``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.models.nnet import AmNnet

ACOUSTIC_SCALE = 0.1
CONTEXT = 5          # splice +-5 frames (wsj.py run: left = right = 5)


def compute_fbank_volumes(corpus, num_bins: int = 36, seed: int = 0,
                          device="cpu", dither: float = 1.0
                          ) -> Dict[str, np.ndarray]:
    """Per-utterance [T, num_bins, 3] volumes: static + delta + delta2
    channels over mel filterbanks (ref: conf/fbank.conf 36 bins + the
    convnet scripts' --delta-order=2)."""
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = dither
    opts.mel_opts.num_bins = num_bins
    ex = FeatureExtractor(opts, device=device, deltas_order=2)
    out = {}
    for utt, f in ex.extract_corpus(corpus.waves, seed).items():
        # deltas concatenate channel blocks [static | d1 | d2]:
        # dim index = c * num_bins + fbin -> (f, c)
        T = f.shape[0]
        v = f.reshape(T, 3, num_bins).transpose(0, 2, 1)
        out[utt] = np.ascontiguousarray(v, np.float32)
    return out


def splice_volume(v: np.ndarray, left: int, right: int) -> np.ndarray:
    T = v.shape[0]
    idx = np.clip(np.arange(T)[:, None]
                  + np.arange(-left, right + 1)[None], 0, T - 1)
    return v[idx].reshape(T, -1)


def decode(am: AmNnet, corpus, hclg: CompiledGraph, word_table,
           volumes: Optional[Dict[str, np.ndarray]] = None, seed: int = 0,
           beam: float = 60.0, max_active: int = 2000) -> Dict:
    """Score ``corpus`` (its fbank volumes are computed on the model's
    device unless given) and decode it on that device at the recipe's
    acoustic scale 0.1 and splice context +-5.  Returns ``wer_details``
    of the transcripts plus ``hyps`` (utt -> words), ``costs`` (utt ->
    best-path cost) and ``loglikes`` (utt -> [T, P])."""
    device = am.nnet.device
    if volumes is None:
        volumes = compute_fbank_volumes(corpus, seed=seed, device=device)
    lls = am.loglikes_batch({utt: splice_volume(v, CONTEXT, CONTEXT)
                             for utt, v in volumes.items()})
    dec = TopKDecoder(hclg, beam=beam, max_active=max_active,
                      acoustic_scale=ACOUSTIC_SCALE, device=device)
    utts = sorted(lls)
    hyps, costs = {}, {}
    for utt, (_, wids, cost) in zip(
            utts, dec.decode_batch([lls[u] for u in utts])):
        hyps[utt] = [word_table.sym(int(w)) for w in wids]
        costs[utt] = cost
    res = wer_details(corpus.transcripts, hyps)
    res.update(hyps=hyps, costs=costs, loglikes=lls)
    return res
