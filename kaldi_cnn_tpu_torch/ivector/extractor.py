"""iVector extractor: total-variability modeling over a diag UBM.

Clean-room equivalent of src/ivector/ivector-extractor.{h,cc}
(IvectorExtractor, IvectorExtractorStats): each UBM Gaussian k has mean
m_k shifted by a low-rank speaker/channel subspace,
x ~ N(m_k + M_k w, Sigma_k), with the iVector w given a N(0, I) prior.
Training is the standard EM over utterance-level sufficient stats
(gamma_k, X_k); extraction is the posterior mean of w.

Everything is batched numpy over Gaussians (the per-utterance E-step is
a [K, D, R] tensor contraction), matching the "jnp iVector extractor"
disposition of SURVEY.md §2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm, DiagGmmAccs

logger = get_logger(__name__)


def train_ubm(feats: List[np.ndarray], num_gauss: int,
              num_iters: int = 8, seed: int = 0) -> DiagGmm:
    """Diagonal UBM via EM with binary splitting
    (ref: gmm-global-init-from-feats + gmm-global-est)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate(feats)
    gmm = DiagGmm.from_stats(x.mean(axis=0), x.var(axis=0))
    while gmm.num_gauss < num_gauss:
        gmm = gmm.split(min(num_gauss, gmm.num_gauss * 2), rng)
        for _ in range(num_iters // 2 + 1):
            accs = DiagGmmAccs(gmm.num_gauss, gmm.dim)
            accs.accumulate(gmm, x, np.ones(len(x)))
            gmm = accs.update(gmm)
    for _ in range(num_iters):
        accs = DiagGmmAccs(gmm.num_gauss, gmm.dim)
        accs.accumulate(gmm, x, np.ones(len(x)))
        gmm = accs.update(gmm)
    return gmm


def utt_stats(ubm: DiagGmm, feats: np.ndarray,
              min_post: float = 0.025) -> Tuple[np.ndarray, np.ndarray]:
    """Zeroth/first-order stats (gamma [K], X [K, D]) with posterior
    flooring (ref: scale-post / --min-post in extract_ivectors.sh)."""
    post = ubm.posteriors(feats)
    post = np.where(post < min_post, 0.0, post)
    s = post.sum(axis=1, keepdims=True)
    post = post / np.maximum(s, 1e-10)
    gamma = post.sum(axis=0)
    X = post.T @ feats
    return gamma, X


class IvectorExtractor:
    def __init__(self, ubm: DiagGmm, ivector_dim: int, seed: int = 0):
        self.ubm = ubm
        self.dim = ubm.dim
        self.R = ivector_dim
        rng = np.random.default_rng(seed)
        # M [K, D, R], Sigma = ubm vars (diag) [K, D]
        self.M = 0.1 * rng.standard_normal(
            (ubm.num_gauss, self.dim, self.R))
        self.inv_var = 1.0 / np.maximum(ubm.vars, 1e-10)   # [K, D]
        self.means = ubm.means.copy()

    # -- E-step core -------------------------------------------------------
    def posterior_params(self, gamma: np.ndarray, X: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior precision L [R, R] and linear term b [R] of w."""
        MS = self.M * self.inv_var[:, :, None]              # [K, D, R]
        # L = I + sum_k gamma_k M_k^T Sigma_k^-1 M_k
        L = np.eye(self.R) + np.einsum(
            "k,kdr,kds->rs", gamma, MS, self.M, optimize=True)
        diff = X - gamma[:, None] * self.means              # [K, D]
        b = np.einsum("kdr,kd->r", MS, diff, optimize=True)
        return L, b

    def extract(self, feats: np.ndarray,
                min_post: float = 0.025) -> np.ndarray:
        """[T, D] -> iVector [R] (posterior mean; ref:
        IvectorExtractor::GetIvectorDistribution)."""
        gamma, X = utt_stats(self.ubm, feats, min_post)
        L, b = self.posterior_params(gamma, X)
        return np.linalg.solve(L, b)

    # -- training ----------------------------------------------------------
    def train(self, feats_list: List[np.ndarray], num_iters: int = 5,
              min_post: float = 0.025) -> None:
        """EM on the M matrices (ref: IvectorExtractorStats::
        AccStatsForUtterance + Update; variances stay the UBM's)."""
        stats = [utt_stats(self.ubm, f, min_post) for f in feats_list]
        for it in range(num_iters):
            # accumulators per gaussian: A_k = sum_u gamma_uk E[w w^T],
            # B_k = sum_u (X_uk - gamma_uk m_k) E[w]^T
            A = np.zeros((self.ubm.num_gauss, self.R, self.R))
            B = np.zeros((self.ubm.num_gauss, self.dim, self.R))
            tot_auxf = 0.0
            for gamma, X in stats:
                L, b = self.posterior_params(gamma, X)
                Linv = np.linalg.inv(L)
                w = Linv @ b
                Eww = Linv + np.outer(w, w)
                A += gamma[:, None, None] * Eww[None]
                diff = X - gamma[:, None] * self.means
                B += diff[:, :, None] * w[None, None, :]
                tot_auxf += float(b @ w - 0.5 * w @ L @ w)
            # per-gaussian, per-dim row solve:
            # M_k row d solves A_k m = B_k[d] (inv_var cancels row-wise)
            for k in range(self.ubm.num_gauss):
                Ak = A[k] + 1e-6 * np.eye(self.R)
                self.M[k] = np.linalg.solve(Ak, B[k].T).T
            logger.info("ivector EM iter %d: auxf %.3f", it, tot_auxf)


def length_normalize(ivec: np.ndarray) -> np.ndarray:
    """(ref: ivector-normalize-length.cc)."""
    n = np.linalg.norm(ivec)
    return ivec * (np.sqrt(len(ivec)) / max(n, 1e-10))
