"""The WSJ-style CNN recipe, the fork's headline configuration (twin of
``kaldi_cnn_tpu/recipes/wsj.py``; ref: BASELINE.json config "nnet2 CNN
(Conv2D + maxpool over fbank) hybrid AM (WSJ)", upstream
steps/nnet2/train_convnet_accel2.sh driven from egs/wsj/s5/run.sh).

``run`` drives every stage on one device:

  MFCC + deltas (fbank kernel, then the DCT and lifter)  -> GMM bootstrap
      on the host (mono -> triphone deltas)              for alignments
  wave -> 36-bin fbank + deltas as (t, f, c) volumes      (fbank kernel)
  train: volumes + alignments -> spliced egs -> CNN trained with NG-SGD
         (maxpool forward/backward kernels) -> model combination -> priors
  decode: splice +-5 -> CNN acoustic model               (conv+maxpool kernel)
       -> pseudo log-likelihoods -> top-K beam search on the triphone HCLG
       -> ``decode_and_score``: lattices (``decode_utterances``: records
          on the device, assembled, pruned and determinized on the host)
          -> rescoring sweep on dev -> best path on test -> WER
       -> ``decode``: the best path of ``TopKDecoder.decode_batch`` -> WER
  optionally the matched p-norm DNN on the same egs, and the paired sign
  test of the two systems' per-utterance errors.

The stages are also callable one by one (``compute_fbank_volumes``,
``train``, ``decode``, ``decode_and_score``).

Run on the card: ``python -m kaldi_cnn_tpu_torch.recipes.wsj``; with
``--data-dir D --lexicon L`` it trains and decodes a Kaldi data
directory instead of the synthetic corpus, and ``--ali-ark A --ali-mdl
M`` trains the CNN from external alignments.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.core.rng import np_rng
from kaldi_cnn_tpu_torch.core.stages import auto_stage, make_runner
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import Lattice, shortest_path
from kaldi_cnn_tpu_torch.decode.score import paired_sign_test, wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import (TopKDecoder,
                                                     decode_utterances)
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.gmm.train import (
    DeltasTrainOptions, MonoTrainOptions, train_deltas, train_mono)
from kaldi_cnn_tpu_torch.io.kaldi_model import read_gmm_model
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.factory import (
    ConvnetConfig, PnormDnnConfig, make_convnet, make_pnorm_dnn)
from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.recipes.datadir import (corpus_from_data_dir,
                                                 load_alignments_ark)
from kaldi_cnn_tpu_torch.recipes.rm import score_sweep
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
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


def write_cnn_egs_sharded(out_dir: str, volumes: Dict[str, np.ndarray],
                          alignments: Dict[str, np.ndarray],
                          tid_to_pdf: np.ndarray,
                          left_context: int = 5, right_context: int = 5,
                          num_shards: int = 8, seed: int = 0):
    """Streaming variant of make_cnn_egs: per-utterance spliced blocks
    go straight to an on-disk sharded store — peak memory is one
    utterance + one shard, never the corpus (ref: steps/nnet2/get_egs.sh
    sharding + nnet-shuffle-egs; the scalable path for the 960h-style
    config)."""
    from kaldi_cnn_tpu_torch.train.sharded_egs import ShardedEgsWriter
    w = ShardedEgsWriter(out_dir, num_shards, seed)
    for utt in sorted(volumes):
        if utt not in alignments:
            continue
        v = volumes[utt]
        ali = np.asarray(alignments[utt])
        if len(ali) != v.shape[0]:
            continue
        T = v.shape[0]
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-left_context,
                                  right_context + 1)[None], 0, T - 1)
        w.add(v[idx].reshape(T, -1), tid_to_pdf[ali])
    return w.finalize()


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


def fit(net: Nnet, egs_train: Egs, egs_valid: Egs, num_epochs: int,
        seed: int, checkpoint_dir: str = "") -> None:
    """The recipe's ``train_nnet`` call: minibatch 256, learning rate
    0.08 -> 0.008; leaves the trained parameters in ``net``."""
    timer = Timer()
    train_nnet(net, egs_train, egs_valid,
               TrainConfig(num_epochs=num_epochs, minibatch_size=256,
                           initial_learning_rate=0.08,
                           final_learning_rate=0.008, seed=seed,
                           checkpoint_dir=checkpoint_dir))
    secs = max(timer.elapsed(), 1e-9)
    logger.info("trained in %.1fs (%.0f audio-s/s)", secs,
                num_epochs * len(egs_train) / 100.0 / secs)


def acoustic_model(net: Nnet, egs_train: Egs, num_pdfs: int) -> AmNnet:
    """``net`` with priors from the training labels."""
    am = AmNnet(net, num_pdfs)
    am.set_priors_from_counts(np.bincount(egs_train.y, minlength=num_pdfs))
    return am


def train(volumes: Dict[str, np.ndarray],
          alignments: Dict[str, np.ndarray], tid2pdf: np.ndarray,
          num_pdfs: int, num_epochs: int = 25, num_filters: int = 64,
          seed: int = 37, device="cuda", checkpoint_dir: str = ""
          ) -> AmNnet:
    """The recipe's egs + nnet_train stages on ``device``: spliced egs,
    the valid split, ``fit``, then priors from the training labels.
    Returns the trained AmNnet, ready for ``decode``."""
    egs_train, egs_valid = split_valid(make_cnn_egs(
        volumes, alignments, tid2pdf, CONTEXT, CONTEXT, seed))
    num_bins = next(iter(volumes.values())).shape[1]
    net = make_convnet(model_config(num_bins, num_pdfs, num_filters),
                       fused=True, device=device)
    fit(net, egs_train, egs_valid, num_epochs, seed, checkpoint_dir)
    return acoustic_model(net, egs_train, num_pdfs)


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
                arcs_per_frame: Optional[int] = None,
                batched: bool = True) -> Dict[str, Lattice]:
    """The recipe's lattice decode (wsj.py run ``nnet_decode``): one
    padded scoring stream over all utterances, then ``decode_utterances``
    on the model's device at acoustic scale 0.1 and lattice beam 8, or,
    with ``batched=False``, the host ``lattice_decode`` one utterance at
    a time.  Returns utt -> determinized ``Lattice``."""
    lls = am.loglikes_batch({utt: splice_volume(v, CONTEXT, CONTEXT)
                             for utt, v in volumes.items()})
    if not batched:
        return {utt: lattice_decode(hclg, ll, acoustic_scale=ACOUSTIC_SCALE,
                                    beam=beam, lattice_beam=8.0,
                                    max_active=max_active)
                for utt, ll in lls.items()}
    return decode_utterances(
        hclg, lls, acoustic_scale=ACOUSTIC_SCALE, beam=beam,
        lattice_beam=8.0, max_active=max_active,
        lattice_arcs_per_frame=arcs_per_frame, device=am.nnet.device)


def decode_and_score(am: AmNnet, dev, test, hclg: CompiledGraph, word_table,
                     volumes: Optional[Dict[str, np.ndarray]] = None,
                     seed: int = 0, beam: float = 60.0,
                     max_active: int = 2000,
                     arcs_per_frame: Optional[int] = None,
                     batched: bool = True) -> Dict:
    """The recipe's scoring (wsj.py run ``decode_and_score``): lattices of
    the ``dev`` and ``test`` corpora, the rescoring sweep on dev picks the
    (acoustic scale, word insertion penalty) point, and the test
    lattices' best paths at that point give ``wer_details``, plus
    ``dev_wer``, ``point``, ``hyps`` (test utt -> words) and ``lattices``
    (utt -> Lattice, dev and test).  Fbank volumes are taken from
    ``volumes`` (utt -> volume) where given, else computed on the model's
    device with dither seeds ``seed + 1`` (dev) and ``seed + 2`` (test),
    as ``run`` computes them."""
    def lattices(corpus, vol_seed):
        vols = (compute_fbank_volumes(corpus, seed=vol_seed,
                                      device=am.nnet.device)
                if volumes is None else
                {u: volumes[u] for u in corpus.waves})
        return nnet_decode(am, vols, hclg, beam, max_active, arcs_per_frame,
                           batched)

    dev_lats, test_lats = lattices(dev, seed + 1), lattices(test, seed + 2)
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


def _audio_seconds(volumes: Dict[str, np.ndarray]) -> float:
    return sum(v.shape[0] for v in volumes.values()) / 100.0


def make_corpus(num_utts: int = 160, seed: int = 37,
                noise_std: float = 250.0, formant_jitter: float = 0.08):
    """``run``'s default corpus: ``num_utts`` synthetic digit strings of
    2-5 words at uniform word probabilities, hardened by ``noise_std``
    (additive noise) and ``formant_jitter`` (per-utterance spectral
    shift) so that test WER is non-zero."""
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    return synthetic.make_noisy_corpus(
        lex, wp, num_utts, 2, 5, seed, noise_std=noise_std,
        formant_jitter=formant_jitter)


def split_corpus(corpus):
    """``run``'s (train, dev, test) split of a corpus without an eval
    corpus: 20 % test, then 15 % of the rest dev."""
    traindev, test = corpus.split(0.2)
    train, dev = traindev.split(0.15)
    return train, dev, test


def run(
    num_utts: int = 160,
    seed: int = 37,
    nnet_epochs: int = 25,
    num_filters: int = 64,
    device="cuda",
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
    ext_alignments: Optional[Dict[str, np.ndarray]] = None,
    ext_ali_mdl: Optional[str] = None,
    batched_decode: bool = True,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    noise_std: float = 250.0,
    formant_jitter: float = 0.08,
    eval_dnn: bool = False,
    decode_beam: float = 60.0,
    decode_max_active: int = 2000,
    # None: derive the lattice record capacity from max_active
    # (TopKDecoder._derive_lattice_arcs)
    decode_arcs_per_frame: Optional[int] = None,
    # >0: dev/test come from a dedicated synthetic eval corpus of this
    # many utterances (same lexicon and noise hardening, disjoint seed)
    # and the whole main corpus trains; 0 keeps the 80/20 split
    eval_utts: int = 0,
) -> Dict:
    """The whole recipe on ``device`` (twin of the JAX package's
    ``wsj.run``, same stages, stage names and result keys).

    corpus: any object with the SyntheticCorpus shape; defaults to
    ``make_corpus(num_utts, seed, noise_std, formant_jitter)``, and
    ``split_corpus`` splits it unless ``eval_utts > 0``, which needs the
    default corpus and raises with a given one.
    ext_alignments: transition-id alignments used instead of the GMM
    bootstrap's; they must come from this run's transition model
    (checked by the largest id) unless ``ext_ali_mdl`` names the GMM
    .mdl that produced them, whose transition model then maps their ids
    to pdfs and sets the pdf count.  batched_decode: dev/test lattices from
    the batched top-K search on the device (``decode_utterances``);
    False takes the host ``lattice_decode``.  exp_dir/stage:
    stage-guarded execution, artifacts (host numpy, loadable on any
    device) under exp_dir, and ``stage=K`` loads the first K stages that
    have one.  eval_dnn: also train the matched p-norm DNN on the same
    egs, decode it, and compare the systems with ``paired_sign_test``.

    Returns the CNN's ``wer_details`` on test plus ``dev_wer``,
    ``point``, ``valid_logprob``, ``train_audio_ss``, ``decode_rtf``,
    ``seconds`` (stage -> wall seconds), ``tree_leaves``,
    ``graph_states`` and, with eval_dnn, ``dnn_wer``, ``dnn_dev_wer``,
    ``dnn_errors``, ``dnn_valid_logprob``, ``cnn_better_utts``,
    ``dnn_better_utts`` and ``cnn_vs_dnn_p``."""
    device = torch.device(device)
    torch.zeros(1, device=device)      # no card: raise before any work
    if corpus is None:
        corpus = make_corpus(num_utts, seed, noise_std, formant_jitter)
    elif eval_utts > 0:
        raise ValueError("eval_utts draws a synthetic eval corpus; it "
                         "cannot be combined with a given corpus")
    lex, wp = corpus.lexicon, corpus.word_probs
    if eval_utts > 0:
        eval_corpus = synthetic.make_noisy_corpus(
            lex, wp, eval_utts, 2, 5, seed + 9001,
            noise_std=noise_std, formant_jitter=formant_jitter)
        dev, test = eval_corpus.split(0.5)
        train = corpus
    else:
        train, dev, test = split_corpus(corpus)
    logger.info("corpus: %d train / %d dev / %d test",
                len(train.waves), len(dev.waves), len(test.waves))

    sr = make_runner(exp_dir, stage)
    secs: Dict[str, float] = {}
    timer = Timer()

    def timed(name, compute):
        timer.reset()
        value = sr.stage(name, compute)
        secs[name] = timer.elapsed()
        logger.info("%s in %.1fs", name, secs[name])
        return value

    mfcc_tr = timed("mfcc", lambda: compute_features(train, seed=seed,
                                                     device=device))
    # GMM bootstrap for alignments (ref: wsj tri2 alignments feed the
    # convnet's egs); a fresh Lang, since training updates its
    # transition model in place
    lang = Lang.create(lex)

    def _bootstrap():
        am0, ali0 = train_mono(
            mfcc_tr, train.transcripts, lang,
            MonoTrainOptions(num_iters=18, totgauss=300))
        return train_deltas(
            mfcc_tr, train.transcripts, lang, ali0, lang.trans_model,
            DeltasTrainOptions(num_iters=12, totgauss=700, max_leaves=250))

    am1, ali1, tri = timed("gmm_bootstrap", _bootstrap)

    num_bins = 36
    vol_tr, vol_dev, vol_te = timed("fbank", lambda: (
        compute_fbank_volumes(train, num_bins, seed, device),
        compute_fbank_volumes(dev, num_bins, seed + 1, device),
        compute_fbank_volumes(test, num_bins, seed + 2, device)))

    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    if ext_alignments is not None:
        # differential mode: external (reference-produced) alignments
        # replace the bootstrap's (ref: steps/nnet2/get_egs.sh --alidir,
        # which pairs the ali dir with the model that produced it)
        if ext_ali_mdl is not None:
            ext_tm, _ = read_gmm_model(ext_ali_mdl)
            tid2pdf = ext_tm.trans_id_to_pdf_array()
            num_pdfs = ext_tm.num_pdfs
        max_tid = max((int(np.max(a)) for a in ext_alignments.values()
                       if len(a)), default=0)
        if max_tid >= len(tid2pdf):
            raise ValueError(
                f"external alignment transition-id {max_tid} out of "
                f"range for the {'supplied' if ext_ali_mdl else 'bootstrap'}"
                f" transition model ({len(tid2pdf)} ids); pass the .mdl "
                f"that produced the ark via --ali-mdl")
        ali1 = ext_alignments
        logger.info("using %d external alignments", len(ali1))
    egs_train, egs_valid = split_valid(timed("egs", lambda: make_cnn_egs(
        vol_tr, ali1, tid2pdf, CONTEXT, CONTEXT, seed)))
    logger.info("egs: %d train / %d valid, dim %d",
                len(egs_train), len(egs_valid), egs_train.x.shape[1])
    frames = nnet_epochs * len(egs_train)

    def trained(name, net, checkpoint_dir=""):
        """Stage ``name``: train ``net`` (its parameters pickled as numpy)
        or load them onto its device."""
        def fitted():
            fit(net, egs_train, egs_valid, nnet_epochs, seed,
                checkpoint_dir)
            return params_to_numpy(net)

        params_from_jax(net, timed(name, fitted))
        return acoustic_model(net, egs_train, num_pdfs)

    net = make_convnet(model_config(num_bins, num_pdfs, num_filters),
                       fused=True, device=device)
    assert net.input_dim == egs_train.x.shape[1]
    am_nnet = trained("nnet_train", net, sr.exp_dir or "")
    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(wp)),
                         tid2pdf)
    logger.info("triphone HCLG: %d leaves, %d states", num_pdfs,
                hclg.num_states)
    eval_vols = {**vol_dev, **vol_te}
    eval_audio_s = _audio_seconds(eval_vols)

    def scored(am, tag):
        timer.reset()
        res = decode_and_score(
            am, dev, test, hclg, tri.word_table, volumes=eval_vols,
            seed=seed, beam=decode_beam, max_active=decode_max_active,
            arcs_per_frame=decode_arcs_per_frame, batched=batched_decode)
        secs[tag] = timer.elapsed()
        del res["lattices"]
        logger.info("%s: dev WER %.2f%%, test WER %.2f%% in %.1fs", tag,
                    res["dev_wer"], res["wer"], secs[tag])
        return res

    def valid_lp(net_):
        n = min(len(egs_valid), 4096)
        return float(net_.objf(
            torch.as_tensor(egs_valid.x[:n], device=device),
            torch.as_tensor(egs_valid.y[:n], device=device)))

    result = scored(am_nnet, "decode")
    result.update(valid_logprob=valid_lp(net),
                  train_audio_ss=frames / 100.0 / max(secs["nnet_train"],
                                                      1e-9),
                  decode_rtf=secs["decode"] / eval_audio_s,
                  tree_leaves=num_pdfs, graph_states=hclg.num_states,
                  seconds=secs)

    if eval_dnn:
        # matched-size p-norm DNN on the SAME egs (ref: the fork's
        # convnet-vs-pnorm RESULTS comparison on identical features and
        # alignments)
        dnn = make_pnorm_dnn(PnormDnnConfig(
            input_dim=egs_train.x.shape[1], num_hidden_layers=2,
            pnorm_input_dim=1000, pnorm_output_dim=200,
            num_pdfs=num_pdfs), device=device)
        dres = scored(trained("dnn_train", dnn), "dnn_decode")
        result.update(dnn_wer=dres["wer"], dnn_dev_wer=dres["dev_wer"],
                      dnn_errors=dres["errors"],
                      dnn_valid_logprob=valid_lp(dnn))
        # matched-pairs significance of the CNN-vs-DNN delta on the
        # shared test set (ref: sclite sig-test discipline)
        sig = paired_sign_test(result["per_utt"], dres["per_utt"])
        result.update(cnn_better_utts=sig["a_better"],
                      dnn_better_utts=sig["b_better"],
                      cnn_vs_dnn_p=sig["p_value"])
        logger.info(
            "CNN vs DNN matched pairs: CNN better on %d utts, DNN on "
            "%d, two-sided sign-test p=%.4g", sig["a_better"],
            sig["b_better"], sig["p_value"])
    if metrics:
        metrics.write("wsj_cnn_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="The WSJ-style CNN recipe on one device; prints the "
                    "result's numbers as one JSON line.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=None,
                    help="Kaldi data dir (wav.scp/text/utt2spk); "
                         "default: synthetic corpus")
    ap.add_argument("--lexicon", default=None)
    ap.add_argument("--ali-ark", default=None,
                    help="external transition-id alignments ark")
    ap.add_argument("--ali-mdl", default=None,
                    help=".mdl that produced --ali-ark (its transition "
                         "model maps the ark's tids to pdfs)")
    ap.add_argument("--exp-dir", default=None,
                    help="experiment dir for per-stage artifacts "
                         "(enables --stage resume)")
    ap.add_argument("--eval-utts", type=int, default=0,
                    help="dedicated eval corpus size (ledger runs: 1200)")
    ap.add_argument("--eval-dnn", action="store_true",
                    help="also train/decode the matched p-norm DNN")
    ap.add_argument("--stage", default="0",
                    help="resume from this stage index; 'auto' resumes "
                         "after the last completed stage")
    a = ap.parse_args(argv)
    corpus = None
    if a.data_dir:
        corpus = corpus_from_data_dir(a.data_dir, a.lexicon)
    ext = load_alignments_ark(a.ali_ark) if a.ali_ark else None
    stage = 0
    if a.exp_dir:
        stage = (auto_stage(a.exp_dir) if a.stage == "auto"
                 else int(a.stage))
    res = run(device=a.device, corpus=corpus, ext_alignments=ext,
              ext_ali_mdl=a.ali_mdl, exp_dir=a.exp_dir, stage=stage,
              eval_utts=a.eval_utts, eval_dnn=a.eval_dnn)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("per_utt", "hyps")}))
    return 0 if res["wer"] < 10.0 else 1


if __name__ == "__main__":
    sys.exit(main())
