"""The WSJ-style CNN recipe's training and serving stages
(twin of ``kaldi_cnn_tpu/recipes/wsj.py::run`` from the fbank volumes on):

  wave -> 36-bin fbank + deltas as (t, f, c) volumes   (fbank kernel)
  train: volumes + alignments -> spliced egs -> CNN trained with NG-SGD
         (maxpool forward/backward kernels) -> model combination -> priors
  decode: splice +-5 -> CNN acoustic model              (conv+maxpool kernel)
       -> pseudo log-likelihoods -> top-K beam search
       -> ``decode_and_score``: lattices (``decode_utterances``: records
          on the device, assembled, pruned and determinized on the host)
          -> rescoring sweep on dev -> best path on test -> WER
       -> ``decode``: the best path of ``TopKDecoder.decode_batch`` -> WER

The GMM bootstrap that gives the recipe its alignments is not ported yet:
``train`` takes alignments from the caller.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import Timer, get_logger
from kaldi_cnn_tpu_torch.core.rng import np_rng
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import Lattice, shortest_path
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import (TopKDecoder,
                                                     decode_utterances)
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes.rm import score_sweep
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet

logger = get_logger(__name__)

ACOUSTIC_SCALE = 0.1
CONTEXT = 5          # splice +-5 frames (wsj.py run: left = right = 5)


def compute_fbank_volumes(corpus, num_bins: int = 36, seed: int = 0,
                          device="cuda", dither: float = 1.0
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


def make_cnn_egs(volumes: Dict[str, np.ndarray],
                 alignments: Dict[str, np.ndarray],
                 tid_to_pdf: np.ndarray,
                 left_context: int = 5, right_context: int = 5,
                 seed: int = 0) -> Egs:
    """Spliced (t, f, c) volumes flattened in the Conv2DComponent row
    layout: index = (t * in_f + f) * in_c + c
    (ref: nnet-get-egs + the fork's patch layout)."""
    xs, ys = [], []
    n_no_ali = n_len = 0
    for utt in sorted(volumes):
        if utt not in alignments:
            n_no_ali += 1
            continue
        v = volumes[utt]                       # [T, f, c]
        ali = np.asarray(alignments[utt])
        T = v.shape[0]
        if len(ali) != T:
            n_len += 1
            continue
        xs.append(splice_volume(v, left_context, right_context))
        ys.append(tid_to_pdf[ali])
    if n_no_ali or n_len:
        logger.warning(
            "make_cnn_egs skipped %d/%d utterances (%d missing "
            "alignment, %d feature/alignment length mismatch)",
            n_no_ali + n_len, len(volumes), n_no_ali, n_len)
    if not xs:
        raise ValueError(
            f"no usable egs: all {len(volumes)} utterances skipped "
            f"({n_no_ali} missing alignment, {n_len} length mismatch)")
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = np_rng(seed, "cnn_egs_shuffle").permutation(len(y))
    return Egs(x[perm], y[perm], np.ones(len(y), np.float32))


def split_valid(egs: Egs):
    """(train, valid): the first max(N // 20, 256) shuffled egs
    validate, as the recipe splits them."""
    n = max(len(egs) // 20, 256)
    return (Egs(egs.x[n:], egs.y[n:], egs.weights[n:]),
            Egs(egs.x[:n], egs.y[:n], egs.weights[:n]))


def model_config(num_bins: int, num_pdfs: int, num_filters: int = 64
                 ) -> ConvnetConfig:
    """The recipe's CNN: Conv2D 4x7 with num_filters -> Maxpool 2x3 ->
    2 x (Affine 1000 -> Pnorm 200 -> Normalize) -> Affine -> Softmax."""
    return ConvnetConfig(
        in_t=2 * CONTEXT + 1, in_f=num_bins, in_c=3, filt_t=4, filt_f=7,
        num_filters=num_filters, pool_t=2, pool_f=3, pool_c=1,
        num_hidden_layers=2, pnorm_input_dim=1000, pnorm_output_dim=200,
        num_pdfs=num_pdfs)


def train(volumes: Dict[str, np.ndarray],
          alignments: Dict[str, np.ndarray], tid2pdf: np.ndarray,
          num_pdfs: int, num_epochs: int = 25, num_filters: int = 64,
          seed: int = 37, device="cuda", checkpoint_dir: str = ""
          ) -> AmNnet:
    """The recipe's egs + nnet_train stages on ``device``: spliced egs,
    the valid split, ``train_nnet`` at minibatch 256 with the learning
    rate 0.08 -> 0.008, then priors from the training labels.  Returns
    the trained AmNnet, ready for ``decode``."""
    egs_train, egs_valid = split_valid(make_cnn_egs(
        volumes, alignments, tid2pdf, CONTEXT, CONTEXT, seed))
    num_bins = next(iter(volumes.values())).shape[1]
    net = make_convnet(model_config(num_bins, num_pdfs, num_filters),
                       fused=True, device=device)
    timer = Timer()
    train_nnet(net, egs_train, egs_valid,
               TrainConfig(num_epochs=num_epochs, minibatch_size=256,
                           initial_learning_rate=0.08,
                           final_learning_rate=0.008, seed=seed,
                           checkpoint_dir=checkpoint_dir))
    frames = num_epochs * len(egs_train)
    logger.info("CNN trained in %.1fs (%.0f audio-s/s)", timer.elapsed(),
                frames / 100.0 / max(timer.elapsed(), 1e-9))
    am = AmNnet(net, num_pdfs)
    am.set_priors_from_counts(np.bincount(egs_train.y, minlength=num_pdfs))
    return am


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


def nnet_decode(am: AmNnet, volumes: Dict[str, np.ndarray],
                hclg: CompiledGraph, beam: float = 60.0,
                max_active: int = 2000,
                arcs_per_frame: Optional[int] = None) -> Dict[str, Lattice]:
    """The recipe's lattice decode (wsj.py run ``nnet_decode``): one
    padded scoring stream over all utterances, then ``decode_utterances``
    on the model's device at acoustic scale 0.1 and lattice beam 8.
    Returns utt -> determinized ``Lattice``."""
    lls = am.loglikes_batch({utt: splice_volume(v, CONTEXT, CONTEXT)
                             for utt, v in volumes.items()})
    return decode_utterances(
        hclg, lls, acoustic_scale=ACOUSTIC_SCALE, beam=beam,
        lattice_beam=8.0, max_active=max_active,
        lattice_arcs_per_frame=arcs_per_frame, device=am.nnet.device)


def decode_and_score(am: AmNnet, dev, test, hclg: CompiledGraph, word_table,
                     volumes: Optional[Dict[str, np.ndarray]] = None,
                     seed: int = 0, beam: float = 60.0,
                     max_active: int = 2000,
                     arcs_per_frame: Optional[int] = None) -> Dict:
    """The recipe's scoring (wsj.py run ``decode_and_score``): lattices of
    the ``dev`` and ``test`` corpora, the rescoring sweep on dev picks the
    (acoustic scale, word insertion penalty) point, and the test
    lattices' best paths at that point give ``wer_details``, plus
    ``dev_wer``, ``point``, ``hyps`` (test utt -> words) and ``lattices``
    (utt -> Lattice, dev and test).  Fbank volumes are computed on the
    model's device unless given in ``volumes`` (utt -> volume)."""
    def lattices(corpus):
        vols = (compute_fbank_volumes(corpus, seed=seed,
                                      device=am.nnet.device)
                if volumes is None else
                {u: volumes[u] for u in corpus.waves})
        return nnet_decode(am, vols, hclg, beam, max_active, arcs_per_frame)

    dev_lats, test_lats = lattices(dev), lattices(test)
    dev_wer, pt, _ = score_sweep(dev_lats, dev.transcripts, word_table)
    logger.info("dev WER %.2f%% at %s", dev_wer, pt)
    hyps = {}
    for utt, lat in test_lats.items():
        _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
        hyps[utt] = [word_table.sym(int(w)) for w in wids]
    res = wer_details(test.transcripts, hyps)
    logger.info("test WER %.2f%% (%d err / %d words)", res["wer"],
                res["errors"], res["words"])
    res.update(dev_wer=dev_wer, point=pt, hyps=hyps,
               lattices={**dev_lats, **test_lats})
    return res
