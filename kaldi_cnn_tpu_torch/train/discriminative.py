"""Sequence-discriminative (MMI) training over lattices (twin of
``kaldi_cnn_tpu/train/discriminative.py``).

Clean-room equivalent of the reference's nnet2 discriminative pipeline
(ref: nnet2/nnet-example-functions.cc discriminative egs,
nnet2/nnet-compute-discriminative.{h,cc}, steps/nnet2/train_discriminative.sh)
and the GMM path (gmm-rescore-lattice | lattice-to-post |
gmm-acc-stats2 + gmm-est-gaussians-ebw):

  numerator  = forced alignment under the current model (hard occupancy)
  denominator= lattice over a weak LM decoded with the current model,
               per-(frame, pdf) occupancies from LatticeForwardBackward
  update     = boosted gradient (num - den) at the softmax output
               (models/nnet.py discriminative_step) or EBW (gmm/ebw.py)

``lattice_pdf_posteriors`` and ``mmi_train_gmm`` are the JAX package's,
verbatim but for the imports (host numpy).  ``mmi_train_nnet`` scores
each utterance with ``Nnet.predict`` on ``device`` (the fused
conv+maxpool kernel on the card for a CNN), decodes the denominator
lattice with the host ``lattice_decode`` and takes
``Nnet.discriminative_step`` on the device (on the card a replay of its
CUDA graph for the utterance's length and the step's NG gates, on the
CPU the eager step).  It pins the NG-SGD update
period to at most 4 for the phase, as the JAX function does, and gives
the net its own period back when it returns (the JAX function leaves
the net changed).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import Lattice, arc_posteriors

logger = get_logger(__name__)


def lattice_pdf_posteriors(lat: Lattice, tid2pdf: np.ndarray,
                           num_pdfs: int, num_frames: int,
                           lm_scale: float = 1.0,
                           acoustic_scale: float = 0.1) -> np.ndarray:
    """[T, num_pdfs] denominator occupancies
    (ref: lattice-to-post + post-to-pdf-post)."""
    post = arc_posteriors(lat, lm_scale, acoustic_scale)
    emit = lat.arc_ilabel > 0
    t = lat.state_time[lat.arc_src[emit]]
    pdf = tid2pdf[lat.arc_ilabel[emit]]
    out = np.zeros((num_frames, num_pdfs))
    np.add.at(out, (t, pdf), post[emit])
    return out.astype(np.float32)


def mmi_train_nnet(
    net,
    opt,
    utts: List[Tuple[np.ndarray, np.ndarray]],
    den_graph: CompiledGraph,
    tid2pdf: np.ndarray,
    am_priors: np.ndarray,
    num_iters: int = 4,
    learning_rate: float = 0.002,
    acoustic_scale: float = 0.1,
    beam: float = 60.0,
    lattice_beam: float = 8.0,
    device="cuda",
):
    """utts: [(spliced feats [T, D], numerator pdf alignment [T])]; the
    parameters in ``net`` (on ``device``) change in place.  Returns
    (opt, per-iter MMI objf list).  The denominator lattice is
    regenerated each iteration with the CURRENT model (exact MMI; the
    reference regenerates lattices once per pass too in
    train_discriminative.sh --num-epochs style)."""
    num_pdfs = len(am_priors)
    log_priors = np.log(np.maximum(am_priors, 1e-20))
    # discriminative fine-tunes run tens of steps, not thousands: the
    # throughput-motivated ng_update_period=16 default would leave the
    # Fisher states nearly frozen for the whole phase, so pin the
    # reference's period (nnet-precondition-online.cc default 4) for
    # the phase, and restore the net's own period after it
    periods = [(ng, ng.update_period) for ng in (net.ng_in, net.ng_out)]
    for ng, p in periods:
        ng.update_period = min(p, 4)
    history = []
    try:
        for it in range(num_iters):
            tot_objf, tot_frames = 0.0, 0
            for x, num_ali in utts:
                T = x.shape[0]
                x = np.asarray(x, np.float32)
                post = net.predict(torch.as_tensor(
                    x, device=device)).float().cpu().numpy()
                ll = (np.log(np.maximum(post, 1e-20))
                      - log_priors[None, :]).astype(np.float32)
                lat = lattice_decode(den_graph, ll,
                                     acoustic_scale=acoustic_scale,
                                     beam=beam, lattice_beam=lattice_beam,
                                     max_active=2000)
                den = lattice_pdf_posteriors(lat, tid2pdf, num_pdfs, T,
                                             1.0, acoustic_scale)
                num = np.zeros((T, num_pdfs), np.float32)
                num[np.arange(T), num_ali] = 1.0
                # host arrays: on the card the step's graph takes them
                # in one copy from its pinned buffer
                opt, objf = net.discriminative_step(opt, x, num, den,
                                                    learning_rate)
                tot_objf += float(objf) * T
                tot_frames += T
            history.append(tot_objf / max(tot_frames, 1))
            logger.info("MMI iter %d: objf/frame %.4f", it, history[-1])
    finally:
        for ng, p in periods:
            ng.update_period = p
    return opt, history


def mmi_train_gmm(
    am,
    lang,
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    den_graph: CompiledGraph,
    num_iters: int = 4,
    acoustic_scale: float = 0.1,
    e: float = 2.0,
):
    """GMM-MMI with EBW updates (ref: steps/train_mmi.sh).  Returns
    (updated am, per-iter objf)."""
    from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmmAccs
    from kaldi_cnn_tpu_torch.gmm.ebw import (
        accumulate_post, ebw_update_am, mmi_objf)
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()
    history = []
    for it in range(num_iters):
        num_accs = AmDiagGmmAccs(am)
        den_accs = AmDiagGmmAccs(am)
        tot, cnt = 0.0, 0
        for utt, f in feats.items():
            if utt not in alignments:
                continue
            num_ali = tid2pdf[alignments[utt]]
            ll = am.loglikes(f)
            lat = lattice_decode(den_graph, ll,
                                 acoustic_scale=acoustic_scale,
                                 beam=60.0, lattice_beam=8.0,
                                 max_active=2000)
            den_post = lattice_pdf_posteriors(
                lat, tid2pdf, tm.num_pdfs, f.shape[0], 1.0,
                acoustic_scale)
            num_accs.accumulate(am, f, num_ali)
            accumulate_post(den_accs, am, f, den_post)
            tot += mmi_objf(am, f, num_ali, den_post) * f.shape[0]
            cnt += f.shape[0]
        am = ebw_update_am(am, num_accs, den_accs, e=e)
        history.append(tot / max(cnt, 1))
        logger.info("GMM-MMI iter %d: objf/frame %.4f", it, history[-1])
    return am, history
