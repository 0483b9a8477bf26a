"""The RM-style recipe: the whole GMM bootstrap chain + a p-norm DNN on
fMLLR features (twin of ``kaldi_cnn_tpu/recipes/rm.py``; ref:
egs/rm/s5/run.sh -> local/nnet2/run_5c-ish p-norm config; BASELINE.json
config "nnet2 p-norm DNN hybrid on fMLLR feats").

Stages (mirroring steps/*):
  features MFCC + deltas (fbank kernel)          (steps/make_mfcc.sh)
  mono     train_mono on MFCC+deltas             (steps/train_mono.sh)
  tri1     train_deltas on a triphone tree       (steps/train_deltas.sh)
  tri2b    LDA+MLLT on the 13 statics            (steps/train_lda_mllt.sh)
  tri3b    SAT / per-speaker fMLLR               (steps/train_sat.sh)
  nnet     p-norm DNN on fMLLR feats + NG-SGD    (steps/nnet2/train_pnorm_simple.sh)
  decode   two-pass fMLLR GMM decode (host ``lattice_decode``), then the
           DNN on the first pass's fMLLR features through
           ``decode_utterances``                 (steps/decode_fmllr.sh)
  score    lattice rescoring sweep               (local/score.sh)

The GMM chain, its transforms and the GMM decode are numpy on the host,
as in the JAX package; the features and the DNN run on ``device``.

Run on the card: ``python -m kaldi_cnn_tpu_torch.recipes.rm``
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import Lattice, shortest_path
from kaldi_cnn_tpu_torch.decode.score import wer_details
from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
from kaldi_cnn_tpu_torch.features.functional import splice_frames
from kaldi_cnn_tpu_torch.lang.hclg import Lang
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.transform import FmllrAccs, apply_affine

logger = get_logger(__name__)

ACOUSTIC_SCALE = 0.1
SPLICE = (3, 3)      # LDA's context (LdaMlltTrainOptions splice_left/right)
CONTEXT = 4          # the DNN's splice +-4 (EgsConfig's default)


def score_sweep(lats: Dict[str, "object"], refs, word_table,
                scales=(0.02, 0.05, 0.1, 0.2),
                wips=(-2.0, -1.0, -0.5, 0.0, 0.5)
                ) -> Tuple[float, Tuple[float, float], Dict]:
    """Lattice rescoring sweep (ref: local/score.sh LMWT x WIP grid):
    decode once, rescore the lattices per operating point."""
    best = (np.inf, (0.1, 0.0), None)
    for s in scales:
        for wip in wips:
            hyps = {}
            for utt, lat in lats.items():
                _, wids, _ = shortest_path(lat, 1.0, s, wip)
                hyps[utt] = [word_table.sym(int(w)) for w in wids]
            r = wer_details(refs, hyps)
            if r["wer"] < best[0]:
                best = (r["wer"], (s, wip), r)
    return best


def fmllr_feats(raw: Dict[str, np.ndarray], transform: np.ndarray,
                spk_transforms: Dict[str, np.ndarray],
                spk_of_utt: Dict[str, str],
                splice: Tuple[int, int] = (3, 3)
                ) -> Dict[str, np.ndarray]:
    """splice -> LDA+MLLT -> per-speaker fMLLR
    (ref: the final feature pipeline of steps/train_sat.sh)."""
    out = {}
    for utt, f in raw.items():
        g = apply_affine(np.asarray(splice_frames(f, *splice)), transform)
        W = spk_transforms.get(spk_of_utt.get(utt, utt))
        if W is not None:
            g = g @ W[:, :-1].T + W[:, -1]
        out[utt] = g.astype(np.float32)
    return out


def estimate_test_fmllr(am, hclg: CompiledGraph, lang: Lang,
                        feats: Dict[str, np.ndarray],
                        acoustic_scale: float = 0.1,
                        silence_weight: float = 0.01,
                        min_count: float = 50.0
                        ) -> Dict[str, np.ndarray]:
    """Unsupervised per-utterance fMLLR from a first-pass decode
    (ref: steps/decode_fmllr.sh: si decode -> weight-silence-post ->
    gmm-est-fmllr)."""
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()
    sil_id = lang.phone_table.id(lang.lexicon.silence_phone)
    out = {}
    for utt, f in feats.items():
        lat = lattice_decode(hclg, am.loglikes(f),
                             acoustic_scale=acoustic_scale,
                             beam=60.0, lattice_beam=8.0, max_active=2000)
        tids, _, _ = shortest_path(lat, 1.0, acoustic_scale)
        if len(tids) != f.shape[0]:
            continue
        w = np.ones(len(tids), np.float32)
        phones = np.asarray([tm.id_to_phone(int(t)) for t in tids])
        w[phones == sil_id] = silence_weight
        acc = FmllrAccs(f.shape[1])
        acc.accumulate_am(am, f, tid2pdf[tids], frame_weights=w)
        W = acc.update(min_count=min_count)
        if W is not None:
            out[utt] = W.astype(np.float32)
    return out


def lda_feats(raw: Dict[str, np.ndarray], transform: np.ndarray
              ) -> Dict[str, np.ndarray]:
    """utt -> its 13 statics spliced +-3 through the LDA+MLLT transform."""
    return {u: apply_affine(np.asarray(splice_frames(f, *SPLICE)),
                            transform).astype(np.float32)
            for u, f in raw.items()}


def gmm_decode(raw_set: Dict[str, np.ndarray], transform: np.ndarray,
               am_si, am_sat, hclg: CompiledGraph, lang: Lang
               ) -> Tuple[Dict[str, Lattice], Dict[str, np.ndarray]]:
    """The GMM-SAT decode with two-pass fMLLR (JAX rm.run's
    ``gmm_decode``): the LDA+MLLT features, a first pass with the
    speaker-independent ``am_si`` giving each utterance's fMLLR
    (``estimate_test_fmllr``; an utterance without one stays
    untransformed), then the host ``lattice_decode`` with the SAT model
    ``am_sat`` at acoustic scale 0.1, beam 60, lattice beam 8 and
    max_active 2000.  Returns (utt -> Lattice, utt -> the fMLLR'd
    features the DNN decodes)."""
    lda_f = lda_feats(raw_set, transform)
    xf = estimate_test_fmllr(am_si, hclg, lang, lda_f)
    lats, feats = {}, {}
    for utt, f in lda_f.items():
        W = xf.get(utt)
        g = f if W is None else (f @ W[:, :-1].T + W[:, -1])
        lats[utt] = lattice_decode(
            hclg, am_sat.loglikes(g), acoustic_scale=ACOUSTIC_SCALE,
            beam=60.0, lattice_beam=8.0, max_active=2000)
        feats[utt] = f if W is None else g.astype(np.float32)
    return lats, feats


def nnet_decode(am, fmllr_set: Dict[str, np.ndarray],
                hclg: CompiledGraph) -> Dict[str, Lattice]:
    """The DNN's lattice decode (JAX rm.run's ``nnet_decode``): the
    fMLLR features spliced +-4, one padded scoring stream on the model's
    device (``AmNnet.loglikes_batch``; the rows are scored
    independently, so this equals JAX's per-utterance ``loglikes``),
    then ``decode_utterances`` on that device at acoustic scale 0.1,
    beam 60, lattice beam 8 and max_active 2000."""
    lls = am.loglikes_batch({
        utt: np.asarray(splice_frames(g, CONTEXT, CONTEXT))
        for utt, g in fmllr_set.items()})
    return decode_utterances(hclg, lls, acoustic_scale=ACOUSTIC_SCALE,
                             beam=60.0, lattice_beam=8.0, max_active=2000,
                             lattice_arcs_per_frame=None,
                             device=am.nnet.device)


def best_hyps(lats: Dict[str, Lattice], point: Tuple[float, float],
              word_table) -> Dict[str, list]:
    """utt -> the words of its lattice's best path at ``point``
    (acoustic scale, word insertion penalty)."""
    hyps = {}
    for utt, lat in lats.items():
        _, wids, _ = shortest_path(lat, 1.0, point[0], point[1])
        hyps[utt] = [word_table.sym(int(w)) for w in wids]
    return hyps


def make_corpus(num_utts: int = 140, seed: int = 29, eval_utts: int = 0,
                corpus=None):
    """``run``'s (train, dev, test).  Without a corpus: ``num_utts``
    synthetic digit strings of 1-4 words at uniform word probabilities.
    With ``eval_utts > 0`` a synthetic eval corpus of that many
    utterances (seed + 9001) is halved into dev and test and the whole
    corpus trains (it raises with a given corpus); otherwise 20 % test,
    then 15 % of the rest dev."""
    if corpus is None:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_corpus(lex, wp, num_utts, 1, 4, seed)
    elif eval_utts > 0:
        raise ValueError("eval_utts draws a synthetic eval corpus; it "
                         "cannot be combined with a given corpus")
    if eval_utts > 0:
        eval_corpus = synthetic.make_corpus(
            corpus.lexicon, corpus.word_probs, eval_utts, 1, 4, seed + 9001)
        dev, test = eval_corpus.split(0.5)
        return corpus, dev, test
    traindev, test = corpus.split(0.2)
    train, dev = traindev.split(0.15)
    return train, dev, test


def run(
    num_utts: int = 140,
    seed: int = 29,
    nnet_epochs: int = 25,
    metrics: Optional[MetricsWriter] = None,
    device="cuda",
    corpus=None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts: int = 0,
) -> Dict:
    """The whole recipe on ``device`` (twin of the JAX package's
    ``rm.run``: same stages, stage names, seeds, options and result
    keys).

    exp_dir/stage: stage-guarded execution ("features", "mono", "tri1",
    "tri2b", "tri3b_sat", "dnn_train"; host numpy artifacts) as in
    ``wsj.run``.  "tri3b_sat" also keeps the tri2b Lang, whose
    transition model SAT training updates and the decode graph reads, so
    that a resumed run decodes on the fresh run's graph.
    eval_utts > 0: dev/test come from a dedicated eval corpus of that
    many utterances (disjoint seed) and the whole main corpus trains.

    Returns ``wer_details`` of the DNN on test plus ``gmm_dev_wer``,
    ``dnn_dev_wer``, ``gmm_test_wer`` (the SAT GMM at its dev point),
    ``gmm_point``, ``dnn_point``, ``tree_leaves``, ``graph_states`` and
    ``seconds`` (stage -> wall seconds)."""
    from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
    from kaldi_cnn_tpu_torch.core.stages import make_runner
    from kaldi_cnn_tpu_torch.gmm.train import (
        DeltasTrainOptions, LdaMlltTrainOptions, MonoTrainOptions,
        SatTrainOptions, train_deltas, train_lda_mllt, train_mono,
        train_sat)
    from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
    from kaldi_cnn_tpu_torch.lang.hclg import make_hclg_from_arpa
    from kaldi_cnn_tpu_torch.models.factory import (PnormDnnConfig,
                                                    make_pnorm_dnn)
    from kaldi_cnn_tpu_torch.recipes.wsj import (acoustic_model, fit,
                                                 split_valid)
    from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
    from kaldi_cnn_tpu_torch.train.egs import EgsConfig, make_egs

    device = torch.device(device)
    torch.zeros(1, device=device)      # no card: raise before any work
    sr = make_runner(exp_dir, stage)
    train, dev, test = make_corpus(num_utts, seed, eval_utts, corpus)
    logger.info("corpus: %d train / %d dev / %d test",
                len(train.waves), len(dev.waves), len(test.waves))
    secs: Dict[str, float] = {}
    timer = Timer()

    def timed(name, compute, staged=True):
        timer.reset()
        value = sr.stage(name, compute) if staged else compute()
        secs[name] = timer.elapsed()
        logger.info("%s in %.1fs", name, secs[name])
        return value

    feats_tr, feats_dev, feats_te = timed("features", lambda: (
        compute_features(train, seed, device),
        compute_features(dev, seed + 1, device),
        compute_features(test, seed + 2, device)))
    raw_tr = {u: f[:, :13] for u, f in feats_tr.items()}
    raw_dev = {u: f[:, :13] for u, f in feats_dev.items()}
    raw_te = {u: f[:, :13] for u, f in feats_te.items()}

    # --- GMM bootstrap chain ---------------------------------------------
    lang = Lang.create(train.lexicon)
    am0, ali0 = timed("mono", lambda: train_mono(
        feats_tr, train.transcripts, lang,
        MonoTrainOptions(num_iters=20, totgauss=300)))
    am1, ali1, tri1 = timed("tri1", lambda: train_deltas(
        feats_tr, train.transcripts, lang, ali0, lang.trans_model,
        DeltasTrainOptions(num_iters=15, totgauss=600, max_leaves=200)))
    am2, ali2, tri2, lda_mllt = timed("tri2b", lambda: train_lda_mllt(
        raw_tr, train.transcripts, lang, ali1, tri1.trans_model,
        LdaMlltTrainOptions(num_iters=15, totgauss=800, max_leaves=250,
                            lda_dim=20)))
    lda_tr = lda_feats(raw_tr, lda_mllt)

    def _sat():
        am3_, ali3_, xforms = train_sat(
            lda_tr, train.transcripts, tri2, ali2,
            opts=SatTrainOptions(num_iters=12, totgauss=900,
                                 fmllr_min_count=50.0))
        return am3_, ali3_, xforms, tri2

    am3, ali3, spk_xforms, tri2 = timed("tri3b_sat", _sat)

    tid2pdf = tri2.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri2.trans_model.num_pdfs
    hclg2 = CompiledGraph(make_hclg_from_arpa(
        tri2, make_unigram_arpa(train.word_probs)), tid2pdf)
    logger.info("tri2b HCLG: %d leaves, %d states", num_pdfs,
                hclg2.num_states)

    # GMM-SAT decode on dev (two-pass fMLLR) for the baseline number
    dev_lats, dev_fmllr = timed("gmm_decode_dev", lambda: gmm_decode(
        raw_dev, lda_mllt, am2, am3, hclg2, tri2), staged=False)
    gmm_wer, gmm_pt, _ = score_sweep(dev_lats, dev.transcripts,
                                     tri2.word_table)
    logger.info("tri3b dev WER %.2f%% at %s", gmm_wer, gmm_pt)

    # --- p-norm DNN on fMLLR feats ---------------------------------------
    train_fmllr = fmllr_feats(raw_tr, lda_mllt, spk_xforms,
                              {u: u for u in raw_tr})
    egs_train, egs_valid = split_valid(make_egs(
        train_fmllr, ali3, tid2pdf,
        EgsConfig(left_context=CONTEXT, right_context=CONTEXT)))
    net = make_pnorm_dnn(PnormDnnConfig(
        input_dim=egs_train.x.shape[1], num_hidden_layers=2,
        pnorm_input_dim=800, pnorm_output_dim=160, num_pdfs=num_pdfs),
        device=device)

    def fitted():
        fit(net, egs_train, egs_valid, nnet_epochs, seed)
        return params_to_numpy(net)

    params_from_jax(net, timed("dnn_train", fitted))
    am_nnet = acoustic_model(net, egs_train, num_pdfs)

    # --- DNN decode (features: fMLLR from the GMM first pass) ------------
    dev_nlats = timed("dnn_decode_dev", lambda: nnet_decode(
        am_nnet, dev_fmllr, hclg2), staged=False)
    dnn_dev_wer, dnn_pt, _ = score_sweep(dev_nlats, dev.transcripts,
                                         tri2.word_table)
    logger.info("DNN dev WER %.2f%% at %s", dnn_dev_wer, dnn_pt)

    test_lats, test_fmllr = timed("gmm_decode_test", lambda: gmm_decode(
        raw_te, lda_mllt, am2, am3, hclg2, tri2), staged=False)
    test_nlats = timed("dnn_decode_test", lambda: nnet_decode(
        am_nnet, test_fmllr, hclg2), staged=False)
    result = wer_details(test.transcripts,
                         best_hyps(test_nlats, dnn_pt, tri2.word_table))
    gmm_test = wer_details(test.transcripts,
                           best_hyps(test_lats, gmm_pt, tri2.word_table))
    result.update(gmm_dev_wer=gmm_wer, dnn_dev_wer=dnn_dev_wer,
                  gmm_test_wer=gmm_test["wer"], gmm_point=gmm_pt,
                  dnn_point=dnn_pt, tree_leaves=num_pdfs,
                  graph_states=hclg2.num_states, seconds=secs)
    logger.info("RM results: tri3b test WER %.2f%%, DNN test WER %.2f%% "
                "(%d err / %d words)", gmm_test["wer"], result["wer"],
                result["errors"], result["words"])
    if metrics:
        metrics.write("rm_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


def main(argv=None) -> int:
    import argparse
    from kaldi_cnn_tpu_torch.core.stages import auto_stage
    ap = argparse.ArgumentParser(
        description="The RM-style GMM chain + p-norm DNN on fMLLR recipe "
                    "on one device; prints the result's numbers as one "
                    "JSON line.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-utts", type=int, default=0,
                    help="dedicated eval corpus size (ledger runs: 900)")
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
              eval_utts=a.eval_utts)
    print(json.dumps({k: v for k, v in res.items() if k != "per_utt"}))
    return 0 if res["wer"] <= max(res["gmm_test_wer"], 2.0) else 1


if __name__ == "__main__":
    sys.exit(main())
