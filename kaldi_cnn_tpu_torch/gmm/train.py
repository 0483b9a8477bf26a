"""Monophone, triphone, LDA+MLLT and SAT GMM training (twin of
``kaldi_cnn_tpu/gmm/train.py``, verbatim but for the imports; ref:
steps/train_{mono,deltas,lda_mllt,sat}.sh orchestration of
gmm-init-mono, compile-train-graphs, align-equal-compiled,
gmm-align-compiled, gmm-acc-stats-ali, gmm-est, build-tree,
convert-ali, est-lda, est-mllt and gmm-est-fmllr).

The reference runs these as N parallel jobs reducing through ark files
per iteration; here the whole EM loop is one process, with scoring
batched per utterance (the map step) and numpy accumulators (the
reduce step).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.decode.decoder import viterbi_align
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm, AmDiagGmmAccs
from kaldi_cnn_tpu_torch.lang.hclg import Lang, compile_training_graph
from kaldi_cnn_tpu_torch.lang.transition_model import TransitionModel

logger = get_logger(__name__)


@configclass
class MonoTrainOptions:
    num_iters: int = 30
    totgauss: int = 300
    max_iter_inc: int = 20
    beam: float = 20.0
    acoustic_scale: float = 1.0
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    seed: int = 0


def align_equal(graph: CompiledGraph, num_frames: int) -> Optional[np.ndarray]:
    """Uniform first-pass alignment (ref: align-equal-compiled): Viterbi
    with flat acoustics, so only graph/transition costs decide."""
    flat = np.zeros((num_frames, int(graph.e_pdf.max()) + 1), np.float32)
    return viterbi_align(graph, flat, acoustic_scale=0.0)


def convert_alignment(old_tm, new_lang: Lang,
                      tids: np.ndarray) -> np.ndarray:
    """Remap an alignment to a new tree's transition ids, keeping the
    phone segmentation and HMM paths (ref: src/bin/convert-ali.cc
    ConvertAlignment, same-topology case)."""
    from kaldi_cnn_tpu_torch.tree.stats import split_to_phones
    new_tm = new_lang.trans_model
    ctx = new_lang.ctx_dep
    segs = split_to_phones(old_tm, tids)
    phones = [p for p, _ in segs]
    out = np.zeros_like(np.asarray(tids, np.int64))
    for i, (phone, frames) in enumerate(segs):
        window = []
        for k in range(ctx.context_width):
            j = i + k - ctx.central_position
            window.append(phones[j] if 0 <= j < len(phones) else 0)
        for t in frames:
            tid = int(tids[t])
            hmm_state = old_tm.id_to_hmm_state(tid)
            trans_index = old_tm.id_to_trans_index(tid)
            pdf_class = new_lang.topo.entry(phone).states[
                hmm_state].pdf_class
            pdf = ctx.compute(window, pdf_class)
            ts = new_tm.tuple_to_state(phone, hmm_state, pdf)
            out[t] = new_tm.pair_to_id(ts, trans_index)
    return out.astype(np.int64)


@configclass
class DeltasTrainOptions:
    num_iters: int = 25
    totgauss: int = 1000
    max_iter_inc: int = 15
    max_leaves: int = 500
    beam: float = 20.0
    acoustic_scale: float = 1.0
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    seed: int = 0


def build_tree_lang(
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    mono_lang: Lang,
    max_leaves: int = 500,
    context_width: int = 3,
    central_position: int = 1,
    ali_tm=None,
) -> Lang:
    """Accumulate tree stats on aligned data and build a triphone-tree
    Lang (ref: steps/train_deltas.sh stages acc-tree-stats,
    cluster-phones, compile-questions, build-tree).  ``ali_tm`` is the
    transition model the alignments were produced with (defaults to
    mono_lang's)."""
    from kaldi_cnn_tpu_torch.tree import (
        accumulate_tree_stats, build_tree, questions_for_keys)
    tm = ali_tm if ali_tm is not None else mono_lang.trans_model
    stats = accumulate_tree_stats(tm, feats, alignments,
                                  context_width, central_position)
    max_pdf_class = max(
        st.pdf_class for p in mono_lang.topo.phones
        for st in mono_lang.topo.entry(p).states) + 1
    questions = questions_for_keys(stats, context_width, central_position,
                                   max_pdf_class=max_pdf_class)
    ctx = build_tree(stats, questions, mono_lang.topo,
                     context_width, central_position,
                     max_leaves=max_leaves)
    return Lang(mono_lang.lexicon, mono_lang.phone_table,
                mono_lang.word_table, mono_lang.topo, ctx,
                TransitionModel(mono_lang.topo, ctx),
                mono_lang.num_disambig)


def train_deltas(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, Sequence[str]],
    lang: Lang,
    prev_alignments: Dict[str, np.ndarray],
    prev_tm,
    opts: DeltasTrainOptions = None,
) -> Tuple[AmDiagGmm, Dict[str, np.ndarray], Lang]:
    """Context-dependent GMM training on (typically delta) features
    (ref: steps/train_deltas.sh): build tree on prev alignments, convert
    alignments, then EM with realignment + mixture-up.  ``lang`` is the
    monophone Lang of the previous system; returns the new tree Lang."""
    opts = opts or DeltasTrainOptions()
    tri_lang = build_tree_lang(feats, prev_alignments, lang,
                               max_leaves=opts.max_leaves)
    alignments = {
        utt: convert_alignment(prev_tm, tri_lang, ali)
        for utt, ali in prev_alignments.items()
    }
    am, alignments = _train_em(feats, transcripts, tri_lang, alignments,
                               num_iters=opts.num_iters,
                               totgauss=opts.totgauss,
                               max_iter_inc=opts.max_iter_inc,
                               beam=opts.beam,
                               acoustic_scale=opts.acoustic_scale,
                               self_loop_scale=opts.self_loop_scale,
                               transition_scale=opts.transition_scale,
                               seed=opts.seed)
    return am, alignments, tri_lang


def _train_em(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, Sequence[str]],
    lang: Lang,
    alignments: Dict[str, np.ndarray],
    num_iters: int,
    totgauss: int,
    max_iter_inc: int,
    beam: float,
    acoustic_scale: float,
    self_loop_scale: float,
    transition_scale: float,
    seed: int,
    transforms: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[AmDiagGmm, Dict[str, np.ndarray]]:
    """Shared EM loop: init from given alignments, realign on the
    reference's schedule, accumulate/update, mixture-up (the
    accumulate->sum->update map-reduce of §3.2 in one process).
    ``transforms`` optionally applies per-utterance fMLLR."""
    rng = np.random.default_rng(seed)
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()

    def xf(utt, f):
        if transforms is None or utt not in transforms:
            return f
        A = transforms[utt]
        return f @ A[:, :-1].T + A[:, -1]

    all_feats = np.concatenate([xf(u, f) for u, f in feats.items()])
    am = AmDiagGmm.flat_start(
        tm.num_pdfs, all_feats.mean(axis=0), all_feats.var(axis=0))
    logger.info("compiling %d training graphs", len(feats))
    graphs = {
        utt: CompiledGraph(
            compile_training_graph(
                lang, transcripts[utt],
                transition_scale=transition_scale,
                self_loop_scale=self_loop_scale),
            tid2pdf)
        for utt in feats
    }
    gauss_inc = max(1, (totgauss - am.total_gauss()) // max(max_iter_inc, 1))
    realign_iters = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 20,
                     23, 26, 29, 32, 35, 38}
    for it in range(num_iters):
        if it > 0 and it in realign_iters:
            for utt, f in feats.items():
                ll = am.loglikes(xf(utt, f))
                ali = viterbi_align(graphs[utt], ll,
                                    acoustic_scale=acoustic_scale,
                                    beam=beam)
                if ali is not None:
                    alignments[utt] = ali
        accs = AmDiagGmmAccs(am)
        tstats = np.zeros(tm.num_transition_ids + 1)
        tot_like, tot_frames = 0.0, 0
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            g = xf(utt, f)
            tids = alignments[utt]
            pdf_ali = tid2pdf[tids]
            accs.accumulate(am, g, pdf_ali)
            np.add.at(tstats, tids, 1.0)
            ll = am.loglikes(g)
            tot_like += float(ll[np.arange(len(pdf_ali)), pdf_ali].sum())
            tot_frames += g.shape[0]
        am = accs.update(am)
        tm.mle_update(tstats)
        if it < max_iter_inc:
            am.split_to_total(
                min(totgauss, am.total_gauss() + gauss_inc),
                accs.pdf_occs(), rng)
        if it % 5 == 0 or it == num_iters - 1:
            logger.info("iter %d: avg loglike/frame %.3f, %d gauss",
                        it, tot_like / max(tot_frames, 1), am.total_gauss())
    return am, alignments


@configclass
class LdaMlltTrainOptions:
    num_iters: int = 25
    totgauss: int = 1200
    max_iter_inc: int = 15
    max_leaves: int = 600
    lda_dim: int = 40
    splice_left: int = 3
    splice_right: int = 3
    mllt_iters: Tuple[int, ...] = (2, 4, 6, 12)
    beam: float = 20.0
    acoustic_scale: float = 1.0
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    seed: int = 0


def train_lda_mllt(
    raw_feats: Dict[str, np.ndarray],
    transcripts: Dict[str, Sequence[str]],
    lang: Lang,
    prev_alignments: Dict[str, np.ndarray],
    prev_tm,
    opts: LdaMlltTrainOptions = None,
):
    """LDA + MLLT system (ref: steps/train_lda_mllt.sh): splice raw
    features, estimate LDA on prev-system pdf classes, build a tree on
    LDA feats, then EM with periodic MLLT (semi-tied covariance)
    updates composed into the global transform.

    Returns (am, alignments, tri_lang, transform [lda_dim, spliced+1]).
    """
    from kaldi_cnn_tpu_torch.features.functional import splice_frames
    from kaldi_cnn_tpu_torch.transform import (
        LdaEstimate, MlltAccs, apply_affine, compose_affine)
    opts = opts or LdaMlltTrainOptions()
    rng = np.random.default_rng(opts.seed)
    prev_tid2pdf = prev_tm.trans_id_to_pdf_array()

    spliced = {
        utt: np.asarray(splice_frames(f, opts.splice_left,
                                      opts.splice_right))
        for utt, f in raw_feats.items()
    }
    lda = LdaEstimate(prev_tm.num_pdfs,
                      next(iter(spliced.values())).shape[1])
    for utt, ali in prev_alignments.items():
        lda.accumulate(spliced[utt], prev_tid2pdf[ali])
    transform, _ = lda.estimate(opts.lda_dim)

    feats = {u: apply_affine(f, transform).astype(np.float32)
             for u, f in spliced.items()}
    tri_lang = build_tree_lang(feats, prev_alignments, lang,
                               max_leaves=opts.max_leaves,
                               ali_tm=prev_tm)
    alignments = {
        utt: convert_alignment(prev_tm, tri_lang, ali)
        for utt, ali in prev_alignments.items()
    }
    tm = tri_lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()
    all_f = np.concatenate(list(feats.values()))
    am = AmDiagGmm.flat_start(tm.num_pdfs, all_f.mean(axis=0),
                              all_f.var(axis=0))
    logger.info("compiling %d training graphs", len(feats))
    graphs = {
        utt: CompiledGraph(
            compile_training_graph(
                tri_lang, transcripts[utt],
                transition_scale=opts.transition_scale,
                self_loop_scale=opts.self_loop_scale),
            tid2pdf)
        for utt in feats
    }
    gauss_inc = max(1, (opts.totgauss - am.total_gauss())
                    // max(opts.max_iter_inc, 1))
    realign_iters = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 20}
    for it in range(opts.num_iters):
        if it > 0 and it in realign_iters:
            for utt, f in feats.items():
                ll = am.loglikes(f)
                ali = viterbi_align(graphs[utt], ll,
                                    acoustic_scale=opts.acoustic_scale,
                                    beam=opts.beam)
                if ali is not None:
                    alignments[utt] = ali
        if it in opts.mllt_iters:
            # MLLT update: accumulate over aligned pdfs' posteriors
            macc = MlltAccs(opts.lda_dim)
            for utt, f in feats.items():
                if utt not in alignments:
                    continue
                pdf_ali = tid2pdf[alignments[utt]]
                for pdf in np.unique(pdf_ali):
                    gmm = am.gmms[int(pdf)]
                    sel = pdf_ali == pdf
                    macc.accumulate(f[sel], gmm.means,
                                    1.0 / gmm.vars,
                                    gmm.posteriors(f[sel]))
            M = macc.update()
            # compose into the global transform; rotate model means
            ext = np.concatenate([M, np.zeros((opts.lda_dim, 1))], axis=1)
            transform = compose_affine(ext, transform)
            for gmm in am.gmms:
                gmm.means = gmm.means @ M.T
            feats = {u: apply_affine(f, transform).astype(np.float32)
                     for u, f in spliced.items()}
        accs = AmDiagGmmAccs(am)
        tstats = np.zeros(tm.num_transition_ids + 1)
        tot_like, tot_frames = 0.0, 0
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            tids = alignments[utt]
            pdf_ali = tid2pdf[tids]
            accs.accumulate(am, f, pdf_ali)
            np.add.at(tstats, tids, 1.0)
            ll = am.loglikes(f)
            tot_like += float(ll[np.arange(len(pdf_ali)), pdf_ali].sum())
            tot_frames += f.shape[0]
        am = accs.update(am)
        tm.mle_update(tstats)
        if it < opts.max_iter_inc:
            am.split_to_total(min(opts.totgauss,
                                  am.total_gauss() + gauss_inc),
                              accs.pdf_occs(), rng)
        if it % 5 == 0 or it == opts.num_iters - 1:
            logger.info("iter %d: avg loglike/frame %.3f, %d gauss",
                        it, tot_like / max(tot_frames, 1),
                        am.total_gauss())
    return am, alignments, tri_lang, transform


@configclass
class SatTrainOptions:
    num_iters: int = 20
    totgauss: int = 1500
    max_iter_inc: int = 12
    fmllr_iters: Tuple[int, ...] = (2, 4, 6, 12)
    fmllr_min_count: float = 100.0
    beam: float = 20.0
    acoustic_scale: float = 1.0
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    seed: int = 0


def train_sat(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, Sequence[str]],
    lang: Lang,
    init_alignments: Dict[str, np.ndarray],
    spk_of_utt: Optional[Dict[str, str]] = None,
    opts: SatTrainOptions = None,
):
    """Speaker-adapted training with per-speaker fMLLR
    (ref: steps/train_sat.sh).  Returns (am, alignments, transforms:
    spk -> W [D, D+1])."""
    from kaldi_cnn_tpu_torch.transform.fmllr import FmllrAccs
    opts = opts or SatTrainOptions()
    rng = np.random.default_rng(opts.seed)
    if spk_of_utt is None:
        spk_of_utt = {u: u for u in feats}   # per-utterance adaptation
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()
    alignments = dict(init_alignments)
    transforms: Dict[str, np.ndarray] = {}

    def xf(utt, f):
        W = transforms.get(spk_of_utt[utt])
        if W is None:
            return f
        return (f @ W[:, :-1].T + W[:, -1]).astype(np.float32)

    all_f = np.concatenate(list(feats.values()))
    am = AmDiagGmm.flat_start(tm.num_pdfs, all_f.mean(axis=0),
                              all_f.var(axis=0))
    logger.info("compiling %d training graphs", len(feats))
    graphs = {
        utt: CompiledGraph(
            compile_training_graph(
                lang, transcripts[utt],
                transition_scale=opts.transition_scale,
                self_loop_scale=opts.self_loop_scale),
            tid2pdf)
        for utt in feats
    }
    gauss_inc = max(1, (opts.totgauss - am.total_gauss())
                    // max(opts.max_iter_inc, 1))
    realign_iters = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18}
    for it in range(opts.num_iters):
        if it > 0 and it in realign_iters:
            for utt, f in feats.items():
                ll = am.loglikes(xf(utt, f))
                ali = viterbi_align(graphs[utt], ll,
                                    acoustic_scale=opts.acoustic_scale,
                                    beam=opts.beam)
                if ali is not None:
                    alignments[utt] = ali
        if it in opts.fmllr_iters:
            by_spk: Dict[str, FmllrAccs] = {}
            for utt, f in feats.items():
                if utt not in alignments:
                    continue
                spk = spk_of_utt[utt]
                acc = by_spk.setdefault(spk, FmllrAccs(f.shape[1]))
                # stats on RAW features: W replaces, not composes
                acc.accumulate_am(am, f, tid2pdf[alignments[utt]])
            for spk, acc in by_spk.items():
                W = acc.update(min_count=opts.fmllr_min_count)
                if W is not None:
                    transforms[spk] = W.astype(np.float32)
            logger.info("iter %d: estimated %d fMLLR transforms",
                        it, len(transforms))
        accs = AmDiagGmmAccs(am)
        tstats = np.zeros(tm.num_transition_ids + 1)
        tot_like, tot_frames = 0.0, 0
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            g = xf(utt, f)
            tids = alignments[utt]
            pdf_ali = tid2pdf[tids]
            accs.accumulate(am, g, pdf_ali)
            np.add.at(tstats, tids, 1.0)
            ll = am.loglikes(g)
            tot_like += float(ll[np.arange(len(pdf_ali)), pdf_ali].sum())
            tot_frames += g.shape[0]
        am = accs.update(am)
        tm.mle_update(tstats)
        if it < opts.max_iter_inc:
            am.split_to_total(min(opts.totgauss,
                                  am.total_gauss() + gauss_inc),
                              accs.pdf_occs(), rng)
        if it % 5 == 0 or it == opts.num_iters - 1:
            logger.info("iter %d: avg loglike/frame %.3f, %d gauss",
                        it, tot_like / max(tot_frames, 1),
                        am.total_gauss())
    return am, alignments, transforms


def train_mono(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, Sequence[str]],
    lang: Lang,
    opts: MonoTrainOptions = None,
) -> Tuple[AmDiagGmm, Dict[str, np.ndarray]]:
    """Returns (trained AmDiagGmm, final per-utterance tid alignments)."""
    opts = opts or MonoTrainOptions()
    rng = np.random.default_rng(opts.seed)
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()

    # flat start from global stats (ref: gmm-init-mono)
    all_feats = np.concatenate(list(feats.values()))
    am = AmDiagGmm.flat_start(
        tm.num_pdfs, all_feats.mean(axis=0), all_feats.var(axis=0))

    logger.info("compiling %d training graphs", len(feats))
    graphs = {
        utt: CompiledGraph(
            compile_training_graph(
                lang, transcripts[utt],
                transition_scale=opts.transition_scale,
                self_loop_scale=opts.self_loop_scale),
            tid2pdf)
        for utt in feats
    }

    alignments: Dict[str, np.ndarray] = {}
    # iteration 0: equal alignment
    for utt, f in feats.items():
        ali = align_equal(graphs[utt], f.shape[0])
        if ali is None:
            logger.warning("equal-align failed for %s", utt)
            continue
        alignments[utt] = ali

    gauss_inc = max(1, (opts.totgauss - am.total_gauss())
                    // max(opts.max_iter_inc, 1))
    realign_iters = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 20,
                     23, 26, 29, 32, 35, 38}

    for it in range(opts.num_iters):
        if it > 0 and it in realign_iters:
            for utt, f in feats.items():
                ll = am.loglikes(f)
                ali = viterbi_align(graphs[utt], ll,
                                    acoustic_scale=opts.acoustic_scale,
                                    beam=opts.beam)
                if ali is not None:
                    alignments[utt] = ali
        accs = AmDiagGmmAccs(am)
        tstats = np.zeros(tm.num_transition_ids + 1)
        tot_like, tot_frames = 0.0, 0
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            tids = alignments[utt]
            pdf_ali = tid2pdf[tids]
            accs.accumulate(am, f, pdf_ali)
            np.add.at(tstats, tids, 1.0)
            ll = am.loglikes(f)
            tot_like += float(ll[np.arange(len(pdf_ali)), pdf_ali].sum())
            tot_frames += f.shape[0]
        am = accs.update(am)
        tm.mle_update(tstats)
        if it < opts.max_iter_inc:
            am.split_to_total(
                min(opts.totgauss,
                    am.total_gauss() + gauss_inc),
                accs.pdf_occs(), rng)
        if it % 5 == 0 or it == opts.num_iters - 1:
            logger.info("iter %d: avg loglike/frame %.3f, %d gauss",
                        it, tot_like / max(tot_frames, 1), am.total_gauss())
    return am, alignments
