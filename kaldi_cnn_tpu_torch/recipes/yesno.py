"""The yesno recipe: the minimum end-to-end slice (twin of
``kaldi_cnn_tpu/recipes/yesno.py``; ref: egs/yesno/s5/run.sh).

wave -> MFCC+deltas (the fbank kernel on ``device``) -> flat-start mono
GMM EM (host numpy) -> HCLG (unigram LM) -> host Viterbi decode -> WER.
Expected WER: 0.0 like the reference's yesno.  ``compute_features`` is
also the MFCC stage of the WSJ, Switchboard and RM recipes.

Run on the card: ``python -m kaldi_cnn_tpu_torch.recipes.yesno``
(``--data-dir D [--lexicon L]`` for a Kaldi data directory).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.decode.decoder import viterbi_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.gmm.train import MonoTrainOptions, train_mono
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.recipes.datadir import corpus_from_data_dir

logger = get_logger(__name__)

# the dev sweep's grid (ref: local/score.sh LM-weight/WIP sweep)
SCALES = (0.05, 0.1, 0.2, 0.5)
WIPS = (-1.0, -0.5, 0.0, 0.5)


def compute_features(corpus, seed: int = 0, device="cuda"
                     ) -> Dict[str, np.ndarray]:
    """MFCC + deltas of order 2 per utterance at dither 1.0 (ref:
    steps/make_mfcc.sh + add-deltas in train_mono), extracted on
    ``device``; utterance i dithers from stage ("mfcc_dither", i) of
    ``seed``.  Returns host numpy: the GMM bootstrap consumes features on
    the host."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    ex = FeatureExtractor(opts, device=device, deltas_order=2)
    return ex.extract_corpus(corpus.waves, seed)


def decode_set(am, hclg: CompiledGraph, word_table,
               feats: Dict[str, np.ndarray], scale: float, wip: float
               ) -> Dict[str, list]:
    """utt -> words of the host ``viterbi_decode`` of the GMM's loglikes
    at acoustic ``scale`` and word insertion penalty ``wip``.  The beam is
    infinite: the synthetic tones have a much larger per-frame loglike
    dynamic range than real speech, so Kaldi's beam=16 would prune the
    correct path at word boundaries."""
    hyps = {}
    for utt, f in feats.items():
        _, word_ids, _ = viterbi_decode(
            hclg, am.loglikes(f), acoustic_scale=scale, beam=np.inf,
            max_active=0, word_ins_penalty=wip)
        hyps[utt] = [word_table.sym(w) for w in word_ids]
    return hyps


def sweep(am, hclg: CompiledGraph, word_table,
          feats: Dict[str, np.ndarray], refs
          ) -> Tuple[Tuple[float, float], float]:
    """The dev sweep over SCALES x WIPS: (the first point of least WER,
    its WER)."""
    best, best_wer = (0.1, 0.0), np.inf
    for scale in SCALES:
        for wip in WIPS:
            r = wer_details(refs, decode_set(am, hclg, word_table, feats,
                                             scale, wip))
            if r["wer"] < best_wer:
                best_wer, best = r["wer"], (scale, wip)
    return best, best_wer


def run(
    num_utts: int = 100,
    num_iters: int = 25,
    totgauss: int = 400,
    seed: int = 17,
    device="cuda",
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
) -> Dict:
    """The whole recipe, its features on ``device`` (twin of the JAX
    package's ``yesno.run``: same corpus, split, seeds and options).
    Returns ``wer_details`` on test plus ``decode_rtf``, ``point`` (the
    dev sweep's (acoustic scale, word insertion penalty)) and
    ``dev_wer``."""
    device = torch.device(device)
    torch.zeros(1, device=device)      # no card: raise before any work
    if corpus is None:
        lex = synthetic.yesno_lexicon()
        word_probs = {"yes": 0.5, "no": 0.5}
        corpus = synthetic.make_corpus(lex, word_probs, num_utts, 1, 3,
                                       seed)
    else:
        lex, word_probs = corpus.lexicon, corpus.word_probs
    traindev, test = corpus.split(0.25)
    train, dev = traindev.split(0.2)
    logger.info("corpus: %d train / %d dev / %d test utts",
                len(train.waves), len(dev.waves), len(test.waves))

    timer = Timer()
    train_feats = compute_features(train, seed, device)
    dev_feats = compute_features(dev, seed + 2, device)
    test_feats = compute_features(test, seed + 1, device)
    logger.info("features in %.1fs", timer.elapsed())

    lang = Lang.create(lex)
    timer.reset()
    am, _ = train_mono(train_feats, train.transcripts, lang,
                       MonoTrainOptions(num_iters=num_iters,
                                        totgauss=totgauss))
    logger.info("mono training in %.1fs", timer.elapsed())

    hclg = CompiledGraph(make_hclg_from_arpa(lang,
                                             make_unigram_arpa(word_probs)),
                         lang.trans_model.trans_id_to_pdf_array())
    best, best_wer = sweep(am, hclg, lang.word_table, dev_feats,
                           dev.transcripts)
    logger.info("dev sweep: best scale=%.2f wip=%.1f (dev WER %.2f%%)",
                best[0], best[1], best_wer)

    timer.reset()
    hyps = decode_set(am, hclg, lang.word_table, test_feats, *best)
    decode_t = timer.elapsed()
    result = wer_details(test.transcripts, hyps)
    audio_s = sum(len(w) for w in test.waves.values()) / corpus.sample_rate
    result.update(decode_rtf=decode_t / audio_s, point=best,
                  dev_wer=best_wer)
    logger.info("yesno WER: %.2f%% (%d err / %d words), decode RTF %.3f",
                result["wer"], result["errors"], result["words"],
                result["decode_rtf"])
    if metrics:
        metrics.write("yesno_wer",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="The yesno recipe on one device; prints the result's "
                    "numbers as one JSON line and exits 0 at WER 0.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=None,
                    help="Kaldi data dir (wav.scp/text/utt2spk); "
                         "default: synthetic corpus")
    ap.add_argument("--lexicon", default=None)
    a = ap.parse_args(argv)
    corpus = None
    if a.data_dir:
        corpus = corpus_from_data_dir(a.data_dir, a.lexicon)
    res = run(device=a.device, corpus=corpus)
    print(json.dumps({k: v for k, v in res.items() if k != "per_utt"}))
    return 0 if res["wer"] == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
