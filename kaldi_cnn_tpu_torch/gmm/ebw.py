"""Extended Baum-Welch (MMI) updates for diagonal GMMs.

Clean-room equivalent of src/gmm/ebw-diag-gmm.{h,cc}
(UpdateEbwDiagGmm / UpdateEbwAmDiagGmm, Povey's thesis): numerator and
denominator accumulators combine with a per-Gaussian smoothing constant
D = max(E * den_occ, smallest D making the new variance positive,
doubled until valid):

  mu'  = (num_x  - den_x  + D mu ) / (num_occ - den_occ + D)
  var' = (num_x2 - den_x2 + D (var + mu^2)) / (num_occ - den_occ + D)
         - mu'^2
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm, AmDiagGmmAccs
from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm, DiagGmmAccs

logger = get_logger(__name__)


def accumulate_post(accs: AmDiagGmmAccs, am: AmDiagGmm,
                    feats: np.ndarray, pdf_post: np.ndarray,
                    min_post: float = 1e-3) -> None:
    """Soft-occupancy accumulation from per-frame pdf posteriors
    [T, num_pdfs] (ref: gmm-acc-stats from lattice posteriors via
    lattice-to-post | gmm-acc-stats)."""
    for p in range(pdf_post.shape[1]):
        w = pdf_post[:, p]
        sel = w > min_post
        if not sel.any():
            continue
        accs.accs[p].accumulate(am.gmms[p], feats[sel], w[sel])


def ebw_update_gmm(gmm: DiagGmm, num: DiagGmmAccs, den: DiagGmmAccs,
                   e: float = 2.0, var_floor: float = 1e-3,
                   min_num_occ: float = 1e-2) -> Tuple[DiagGmm, float]:
    """Returns (updated gmm, auxf count).  Weights stay fixed (the
    reference updates weights with a separate iteration; MMI weight
    updates are fragile and off by default in many recipes)."""
    w = gmm.weights.copy()
    m = gmm.means.copy()
    v = gmm.vars.copy()
    n_updated = 0
    for k in range(gmm.num_gauss):
        num_occ = float(num.occ[k])
        den_occ = float(den.occ[k])
        if num_occ < min_num_occ:
            continue
        D = e * den_occ
        for _ in range(20):   # double D until variance positive
            denom = num_occ - den_occ + D
            if denom > 1e-8:
                mu = (num.sum_x[k] - den.sum_x[k] + D * m[k]) / denom
                var = ((num.sum_x2[k] - den.sum_x2[k]
                        + D * (v[k] + m[k] ** 2)) / denom - mu ** 2)
                if (var > var_floor).all():
                    m[k] = mu
                    v[k] = np.maximum(var, var_floor)
                    n_updated += 1
                    break
            D = max(D * 2.0, 1.0)
    return DiagGmm(w, m, v), n_updated


def ebw_update_am(am: AmDiagGmm, num: AmDiagGmmAccs, den: AmDiagGmmAccs,
                  e: float = 2.0, var_floor: float = 1e-3) -> AmDiagGmm:
    """(ref: gmm-est-gaussians-ebw over all pdfs)."""
    out = []
    updated = 0
    for g, na, da in zip(am.gmms, num.accs, den.accs):
        ng, n = ebw_update_gmm(g, na, da, e, var_floor)
        out.append(ng)
        updated += n
    logger.info("EBW: updated %d Gaussians", updated)
    return AmDiagGmm(out)


def mmi_objf(am: AmDiagGmm, feats: np.ndarray, num_ali: np.ndarray,
             den_post: np.ndarray) -> float:
    """Per-frame MMI auxiliary diagnostic: num loglike minus
    den-posterior-weighted loglike."""
    ll = am.loglikes(feats)
    num_part = float(ll[np.arange(len(num_ali)), num_ali].sum())
    den_part = float((ll * den_post).sum())
    return (num_part - den_part) / max(len(num_ali), 1)
