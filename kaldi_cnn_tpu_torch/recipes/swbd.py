"""The Switchboard-style recipe: CNN acoustic model + speaker iVectors
(twin of ``kaldi_cnn_tpu/recipes/swbd.py``; ref: BASELINE.json config
"CNN + online iVector speaker adaptation (Switchboard)"; upstream
egs/swbd/s5b local/online convnet scripts).

The synthetic corpus gets real per-speaker variation (vocal-tract-
length formant scaling), a diag UBM + total-variability extractor
produces per-utterance iVectors, and the CNN consumes
[fbank (t, f, c) volume | iVector] through SliceParallelComponent.
``run`` drives every stage on one device:

  MFCC + deltas (fbank kernel)          -> GMM bootstrap on the host
  MFCC statics -> UBM + iVector extractor (host numpy) -> iVectors
  wave -> 36-bin fbank + deltas volumes (fbank kernel)
  train: [spliced volume | aux] egs -> the CNN + iVector net with NG-SGD
         (maxpool forward/backward kernels inside the slices)
  decode: loglikes (the conv+maxpool kernel through the pair of slices)
       -> ``decode_utterances`` lattices -> rescoring sweep on dev
       -> best paths on test -> WER

With ``use_pitch`` the processed Kaldi-pitch stream joins the aux rows.
Pitch runs at the corpus's sample rate, one row per fbank frame (the
JAX recipe computes it at the 16 kHz default on the 8 kHz corpus and
pads the half-length track at its edge).

Run on the card: ``python -m kaldi_cnn_tpu_torch.recipes.swbd``
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
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import Lattice, shortest_path
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
from kaldi_cnn_tpu_torch.features.pitch import (PitchOptions,
                                                compute_and_process_pitch)
from kaldi_cnn_tpu_torch.gmm.train import (
    DeltasTrainOptions, MonoTrainOptions, train_deltas, train_mono)
from kaldi_cnn_tpu_torch.ivector import (IvectorExtractor, length_normalize,
                                         train_ubm)
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.factory import (ConvnetConfig,
                                                make_convnet_ivector)
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.recipes.rm import score_sweep
from kaldi_cnn_tpu_torch.recipes.wsj import (
    ACOUSTIC_SCALE, acoustic_model, compute_fbank_volumes, fit,
    make_cnn_egs, split_valid, splice_volume)
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
from kaldi_cnn_tpu_torch.train.egs import Egs

logger = get_logger(__name__)

NUM_BINS = 36
CONTEXT = 5          # splice +-5 frames (swbd.py run: left = right = 5)


def make_corpus(num_speakers: int = 24, utts_per_speaker: int = 7,
                seed: int = 43, eval_utts_per_speaker: int = 0):
    """``run``'s corpus and its (train, dev, test) split.  With
    ``eval_utts_per_speaker > 0`` every speaker gets that many extra
    utterances, split evenly into dev and test, and the rest train;
    otherwise 20 % test, then 15 % of the rest dev."""
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus, _ = synthetic.make_speaker_corpus(
        lex, wp, num_speakers, utts_per_speaker + eval_utts_per_speaker, 1,
        4, seed)
    if eval_utts_per_speaker > 0:
        def _j(u):
            return int(u.rsplit("_utt", 1)[1])
        train = corpus.subset(
            [u for u in corpus.waves if _j(u) < utts_per_speaker])
        evalc = [u for u in corpus.waves if _j(u) >= utts_per_speaker]
        dev = corpus.subset([u for u in evalc if _j(u) % 2 == 0])
        test = corpus.subset([u for u in evalc if _j(u) % 2 == 1])
    else:
        train, test = corpus.split(0.2)
        train, dev = train.split(0.15)
    return train, dev, test


def ivector_system(mfcc: Dict[str, np.ndarray], ivector_dim: int,
                   seed: int):
    """(UBM, extractor): a 16-Gaussian diag UBM and the total-variability
    extractor trained on the 13 MFCC statics (ref:
    steps/online/nnet2/train_diag_ubm.sh + train_ivector_extractor.sh)."""
    raw13 = [f[:, :13] for f in mfcc.values()]
    ubm = train_ubm(raw13, 16, num_iters=4, seed=seed)
    ext = IvectorExtractor(ubm, ivector_dim, seed=seed)
    ext.train(raw13, num_iters=4)
    return ubm, ext


def ivectors(ext: IvectorExtractor, mfcc: Dict[str, np.ndarray]
             ) -> Dict[str, np.ndarray]:
    """utt -> its length-normalized iVector from the MFCC statics."""
    return {u: length_normalize(ext.extract(f[:, :13])).astype(np.float32)
            for u, f in mfcc.items()}


def aux_rows(corpus_set, vols: Dict[str, np.ndarray],
             ivs: Dict[str, np.ndarray], use_pitch: bool = False
             ) -> Dict[str, np.ndarray]:
    """Per-utterance [T, aux_dim] auxiliary rows: the utterance iVector
    repeated per frame (the online pipeline appends the current iVector
    estimate per chunk) and, with ``use_pitch``, the processed pitch
    stream at the corpus's sample rate, whose frames are the fbank
    volume's (it raises where they are not)."""
    out = {}
    opts = PitchOptions(samp_freq=float(corpus_set.sample_rate))
    for utt, v in vols.items():
        T = v.shape[0]
        a = np.repeat(ivs[utt][None, :], T, axis=0)
        if use_pitch:
            pf = compute_and_process_pitch(
                np.asarray(corpus_set.waves[utt], np.float64), opts)
            if len(pf) != T:
                raise ValueError(f"{utt}: {len(pf)} pitch frames for {T} "
                                 "fbank frames")
            a = np.concatenate([a, pf], axis=1)
        out[utt] = a.astype(np.float32)
    return out


def make_egs(vols: Dict[str, np.ndarray], aux: Dict[str, np.ndarray],
             alignments: Dict[str, np.ndarray], tid_to_pdf: np.ndarray,
             seed: int) -> Egs:
    """[spliced volume | aux] egs: ``make_cnn_egs``'s volumes, their aux
    rows in the same utterance order and under the same shuffle."""
    egs_vol = make_cnn_egs(vols, alignments, tid_to_pdf, CONTEXT, CONTEXT,
                           seed)
    rows = np.concatenate([
        aux[u] for u in sorted(vols) if u in alignments
        and len(alignments[u]) == vols[u].shape[0]])
    perm = np_rng(seed, "cnn_egs_shuffle").permutation(len(egs_vol.y))
    return Egs(np.concatenate([egs_vol.x, rows[perm]], axis=1), egs_vol.y,
               egs_vol.weights)


def model_config(num_pdfs: int, num_filters: int = 48) -> ConvnetConfig:
    """The recipe's CNN: Conv2D 4x7 with num_filters -> Maxpool 2x3 ->
    2 x (Affine 800 -> Pnorm 160 -> Normalize) -> Affine -> Softmax."""
    return ConvnetConfig(
        in_t=2 * CONTEXT + 1, in_f=NUM_BINS, in_c=3, filt_t=4, filt_f=7,
        num_filters=num_filters, pool_t=2, pool_f=3, pool_c=1,
        num_hidden_layers=2, pnorm_input_dim=800, pnorm_output_dim=160,
        num_pdfs=num_pdfs)


def decode_rows(vols: Dict[str, np.ndarray], aux: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
    """utt -> the net's input rows: the spliced volume and its aux row."""
    out = {}
    for utt, v in vols.items():
        x = splice_volume(v, CONTEXT, CONTEXT)
        out[utt] = np.concatenate([x, aux[utt][:x.shape[0]]], axis=1)
    return out


def nnet_decode(am: AmNnet, rows: Dict[str, np.ndarray],
                hclg: CompiledGraph) -> Dict[str, Lattice]:
    """The recipe's lattice decode: one padded scoring stream, then
    ``decode_utterances`` on the model's device at acoustic scale 0.1,
    beam 60, lattice beam 8 and max_active 2000.  Returns utt ->
    determinized ``Lattice``."""
    lls = am.loglikes_batch(rows)
    return decode_utterances(hclg, lls, acoustic_scale=ACOUSTIC_SCALE,
                             beam=60.0, lattice_beam=8.0, max_active=2000,
                             lattice_arcs_per_frame=None,
                             device=am.nnet.device)


def run(
    num_speakers: int = 24,
    utts_per_speaker: int = 7,
    seed: int = 43,
    nnet_epochs: int = 25,
    num_filters: int = 48,
    ivector_dim: int = 12,
    device="cuda",
    metrics: Optional[MetricsWriter] = None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts_per_speaker: int = 0,
    use_pitch: bool = False,
) -> Dict:
    """The whole recipe on ``device`` (twin of the JAX package's
    ``swbd.run``: same stages, stage names, seeds and result keys).

    exp_dir/stage: stage-guarded execution ("mfcc", "gmm_bootstrap",
    "ivector_extractor", "nnet_train"; host numpy artifacts) as in
    ``wsj.run``.  eval_utts_per_speaker > 0: each speaker contributes
    that many extra utterances, used only for dev/test.  use_pitch:
    append the processed 3-column pitch stream to every aux row.

    Returns ``wer_details`` on test plus ``dev_wer``, ``use_pitch``,
    ``point``, ``tree_leaves``, ``graph_states`` and ``seconds`` (stage
    -> wall seconds)."""
    device = torch.device(device)
    torch.zeros(1, device=device)      # no card: raise before any work
    sr = make_runner(exp_dir, stage)
    train, dev, test = make_corpus(num_speakers, utts_per_speaker, seed,
                                   eval_utts_per_speaker)
    logger.info("corpus: %d train / %d dev / %d test over %d speakers",
                len(train.waves), len(dev.waves), len(test.waves),
                num_speakers)
    secs: Dict[str, float] = {}
    timer = Timer()

    def timed(name, compute, staged=True):
        timer.reset()
        value = sr.stage(name, compute) if staged else compute()
        secs[name] = timer.elapsed()
        logger.info("%s in %.1fs", name, secs[name])
        return value

    mfcc_tr = timed("mfcc", lambda: compute_features(train, seed=seed,
                                                     device=device))
    lang = Lang.create(train.lexicon)

    def _bootstrap():
        am0, ali0 = train_mono(
            mfcc_tr, train.transcripts, lang,
            MonoTrainOptions(num_iters=18, totgauss=300))
        return train_deltas(
            mfcc_tr, train.transcripts, lang, ali0, lang.trans_model,
            DeltasTrainOptions(num_iters=12, totgauss=700, max_leaves=250))

    am1, ali1, tri = timed("gmm_bootstrap", _bootstrap)

    # --- iVector system (ref: steps/online/nnet2/train_diag_ubm.sh +
    # train_ivector_extractor.sh + extract_ivectors_online.sh) --------
    _, ext = timed("ivector_extractor",
                     lambda: ivector_system(mfcc_tr, ivector_dim, seed))
    iv_tr, iv_dev, iv_te = timed("ivectors", lambda: (
        ivectors(ext, mfcc_tr),
        ivectors(ext, compute_features(dev, seed=seed + 101, device=device)),
        ivectors(ext, compute_features(test, seed=seed + 102,
                                       device=device))), staged=False)

    vol_tr, vol_dev, vol_te = timed("fbank", lambda: (
        compute_fbank_volumes(train, NUM_BINS, seed, device),
        compute_fbank_volumes(dev, NUM_BINS, seed + 1, device),
        compute_fbank_volumes(test, NUM_BINS, seed + 2, device)),
        staged=False)
    aux_dim = ivector_dim + (3 if use_pitch else 0)
    aux_tr = aux_rows(train, vol_tr, iv_tr, use_pitch)
    aux_dev = aux_rows(dev, vol_dev, iv_dev, use_pitch)
    aux_te = aux_rows(test, vol_te, iv_te, use_pitch)

    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    egs_train, egs_valid = split_valid(
        make_egs(vol_tr, aux_tr, ali1, tid2pdf, seed))

    net = make_convnet_ivector(model_config(num_pdfs, num_filters),
                               ivector_dim=aux_dim, fused=True,
                               device=device)
    assert net.input_dim == egs_train.x.shape[1]

    def fitted():
        fit(net, egs_train, egs_valid, nnet_epochs, seed)
        return params_to_numpy(net)

    params_from_jax(net, timed("nnet_train", fitted))
    am_nnet = acoustic_model(net, egs_train, num_pdfs)
    hclg = CompiledGraph(make_hclg_from_arpa(
        tri, make_unigram_arpa(train.word_probs)), tid2pdf)
    logger.info("triphone HCLG: %d leaves, %d states", num_pdfs,
                hclg.num_states)

    def decoded():
        dev_lats = nnet_decode(am_nnet, decode_rows(vol_dev, aux_dev), hclg)
        dev_wer, pt, _ = score_sweep(dev_lats, dev.transcripts,
                                     tri.word_table)
        logger.info("CNN+ivec dev WER %.2f%% at %s", dev_wer, pt)
        test_lats = nnet_decode(am_nnet, decode_rows(vol_te, aux_te), hclg)
        hyps = {}
        for utt, lat in test_lats.items():
            _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
            hyps[utt] = [tri.word_table.sym(int(w)) for w in wids]
        res = wer_details(test.transcripts, hyps)
        res.update(dev_wer=dev_wer, point=pt)
        return res

    result = timed("decode", decoded, staged=False)
    result.update(use_pitch=use_pitch, tree_leaves=num_pdfs,
                  graph_states=hclg.num_states, seconds=secs)
    logger.info("swbd CNN+ivec test WER %.2f%% (%d err / %d words)",
                result["wer"], result["errors"], result["words"])
    if metrics:
        metrics.write("swbd_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="The Switchboard-style CNN + iVector recipe on one "
                    "device; prints the result's numbers as one JSON line.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-utts-per-speaker", type=int, default=0,
                    help="extra eval utts per speaker (ledger runs: 34)")
    ap.add_argument("--pitch", action="store_true",
                    help="append the processed Kaldi-pitch stream")
    ap.add_argument("--exp-dir", default=None,
                    help="experiment dir for per-stage artifacts "
                         "(enables --stage resume)")
    ap.add_argument("--stage", default="0",
                    help="resume from this stage index; 'auto' resumes "
                         "after the last completed stage")
    a = ap.parse_args(argv)
    stage = 0
    if a.exp_dir:
        stage = (auto_stage(a.exp_dir) if a.stage == "auto"
                 else int(a.stage))
    res = run(device=a.device, exp_dir=a.exp_dir, stage=stage,
              eval_utts_per_speaker=a.eval_utts_per_speaker,
              use_pitch=a.pitch)
    print(json.dumps({k: v for k, v in res.items() if k != "per_utt"}))
    return 0 if res["wer"] < 20.0 else 1


if __name__ == "__main__":
    sys.exit(main())
