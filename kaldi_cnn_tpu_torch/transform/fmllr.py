"""fMLLR (CMLLR) estimation for diagonal GMMs.

Clean-room equivalent of src/transform/fmllr-diag-gmm.{h,cc}
(FmllrDiagGmmAccs::AccumulateForGmm, ComputeFmllrTransform): global
affine feature transform W = [A; b] maximizing

  beta*log|det A| - 1/2 sum_i w_i^T G_i w_i + sum_i w_i^T k_i

with sufficient stats over extended features x+ = [x; 1]:
  k_i = sum_t gamma(t) mu_i/sigma^2_i x+^T   (row i of K)
  G_i = sum_t gamma(t)/sigma^2_i x+ x+^T

optimized row-wise (Gales 1998): w_i = G_i^{-1}(nu p_i + k_i) with p_i
the extended cofactor row and nu the positive root of
a nu^2 + b nu - beta = 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm

logger = get_logger(__name__)


class FmllrAccs:
    def __init__(self, dim: int):
        self.dim = dim
        self.beta = 0.0
        self.K = np.zeros((dim, dim + 1), np.float64)
        self.G = np.zeros((dim, dim + 1, dim + 1), np.float64)

    def accumulate_gmm(self, feats: np.ndarray, means: np.ndarray,
                       inv_vars: np.ndarray,
                       posteriors: np.ndarray) -> None:
        """feats [T,D]; means/inv_vars [M,D]; posteriors [T,M]."""
        f = np.asarray(feats, np.float64)
        ext = np.concatenate([f, np.ones((len(f), 1))], axis=1)
        post = np.asarray(posteriors, np.float64)
        self.beta += float(post.sum())
        # K += sum_m (mu_m * invvar_m) outer sum_t post x+
        mi = means * inv_vars                              # [M, D]
        weighted = post.T @ ext                            # [M, D+1]
        self.K += mi.T @ weighted
        # G_i += sum_m invvar_{m,i} * sum_t post_{t,m} x+ x+^T
        for m in range(means.shape[0]):
            w = post[:, m]
            sel = w > 1e-8
            if not sel.any():
                continue
            e = ext[sel]
            S = (e * w[sel, None]).T @ e
            self.G += inv_vars[m][:, None, None] * S[None, :, :]

    def accumulate_am(self, am: AmDiagGmm, feats: np.ndarray,
                      pdf_ali: np.ndarray,
                      frame_weights: Optional[np.ndarray] = None) -> None:
        """Viterbi-alignment accumulation: per frame, posteriors over
        the aligned pdf's Gaussians (ref: AccumulateForGmm per state;
        frame_weights = the weight-silence-post step of
        steps/decode_fmllr.sh)."""
        f = np.asarray(feats, np.float64)
        for pdf in np.unique(pdf_ali):
            gmm = am.gmms[int(pdf)]
            sel = pdf_ali == pdf
            post = gmm.posteriors(f[sel])
            if frame_weights is not None:
                post = post * frame_weights[sel][:, None]
            self.accumulate_gmm(f[sel], gmm.means,
                                1.0 / np.maximum(gmm.vars, 1e-10), post)

    def update(self, num_iters: int = 20,
               min_count: float = 100.0) -> Optional[np.ndarray]:
        """Returns W [D, D+1] or None if below min-count
        (ref: ComputeFmllrTransform; --fmllr-min-count)."""
        if self.beta < min_count:
            return None
        d = self.dim
        W = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
        Ginv = np.stack([np.linalg.inv(
            self.G[i] + 1e-6 * (np.trace(self.G[i]) + 1.0) / (d + 1)
            * np.eye(d + 1)) for i in range(d)])
        for _ in range(num_iters):
            for i in range(d):
                A = W[:, :d]
                cof = np.linalg.inv(A).T * np.linalg.det(A)
                p = np.concatenate([cof[i], [0.0]])
                gp = Ginv[i] @ p
                gk = Ginv[i] @ self.K[i]
                a = float(p @ gp)
                b = float(p @ gk)
                if a <= 0:
                    continue
                nu = (-b + np.sqrt(b * b + 4 * a * self.beta)) / (2 * a)
                W[i] = nu * gp + gk
        return W

    def auxf(self, W: np.ndarray) -> float:
        d = self.dim
        sign, logdet = np.linalg.slogdet(W[:, :d])
        return float(self.beta * logdet
                     - 0.5 * sum(W[i] @ self.G[i] @ W[i] for i in range(d))
                     + sum(W[i] @ self.K[i] for i in range(d)))


def estimate_fmllr_per_spk(
    am: AmDiagGmm,
    feats_by_spk,
    pdf_ali_by_spk,
    min_count: float = 100.0,
) -> dict:
    """Per-speaker fMLLR transforms from aligned data (ref:
    gmm-est-fmllr + spk2utt mode in steps/align_fmllr.sh)."""
    out = {}
    for spk, utt_feats in feats_by_spk.items():
        acc = FmllrAccs(next(iter(utt_feats.values())).shape[1])
        for utt, f in utt_feats.items():
            acc.accumulate_am(am, f, pdf_ali_by_spk[spk][utt])
        W = acc.update(min_count=min_count)
        if W is not None:
            out[spk] = W.astype(np.float32)
    return out
