"""PLDA: probabilistic LDA over iVectors for speaker scoring.

Clean-room equivalent of src/ivector/plda.{h,cc} (Plda,
PldaEstimator): the two-covariance model
  speaker ~ N(mu, Phi_b),  ivector | speaker ~ N(speaker, Phi_w)
estimated by EM from speaker-labeled iVectors; scoring is the
log-likelihood ratio same-speaker vs different-speaker in the
simultaneously-diagonalized basis.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class Plda:
    def __init__(self, mean: np.ndarray, transform: np.ndarray,
                 psi: np.ndarray):
        """transform simultaneously diagonalizes: within-cov -> I,
        between-cov -> diag(psi)."""
        self.mean = mean
        self.transform = transform
        self.psi = psi

    def project(self, ivec: np.ndarray) -> np.ndarray:
        return self.transform @ (ivec - self.mean)

    def llr(self, enroll: np.ndarray, test: np.ndarray,
            n_enroll: int = 1) -> float:
        """Same/different-speaker log-likelihood ratio
        (ref: Plda::LogLikelihoodRatio)."""
        u = self.project(enroll)
        v = self.project(test)
        n = n_enroll
        # posterior of speaker mean given n enrollment utts
        prec = n * self.psi / (n * self.psi + 1.0)
        mean_given = prec * u
        var_given = 1.0 + self.psi / (n * self.psi + 1.0)
        logp_same = -0.5 * (np.log(2 * np.pi * var_given)
                            + (v - mean_given) ** 2 / var_given).sum()
        var_diff = 1.0 + self.psi
        logp_diff = -0.5 * (np.log(2 * np.pi * var_diff)
                            + v ** 2 / var_diff).sum()
        return float(logp_same - logp_diff)


def estimate_plda(ivectors_by_spk: Dict[str, List[np.ndarray]],
                  num_iters: int = 10) -> Plda:
    """Two-covariance EM (ref: PldaEstimator::Estimate)."""
    dim = len(next(iter(ivectors_by_spk.values()))[0])
    all_iv = np.concatenate([np.stack(v)
                             for v in ivectors_by_spk.values()])
    mean = all_iv.mean(axis=0)
    # init: within/between from class stats
    Sw = np.zeros((dim, dim))
    Sb = np.zeros((dim, dim))
    n_tot = 0
    for spk, ivs in ivectors_by_spk.items():
        X = np.stack(ivs) - mean
        mu = X.mean(axis=0)
        Sb += len(ivs) * np.outer(mu, mu)
        Xc = X - mu
        Sw += Xc.T @ Xc
        n_tot += len(ivs)
    Sw /= max(n_tot, 1)
    Sb /= max(n_tot, 1)
    Sw += 1e-6 * np.eye(dim)
    Sb += 1e-6 * np.eye(dim)
    for _ in range(num_iters):
        # EM refinement of the two-covariance model
        Sw_new = np.zeros((dim, dim))
        Sb_new = np.zeros((dim, dim))
        Swi = np.linalg.inv(Sw)
        Sbi = np.linalg.inv(Sb)
        n_spk = 0
        for spk, ivs in ivectors_by_spk.items():
            X = np.stack(ivs) - mean
            n = len(ivs)
            prec = Sbi + n * Swi
            cov = np.linalg.inv(prec)
            mu = cov @ Swi @ X.sum(axis=0)
            Sb_new += cov + np.outer(mu, mu)
            d = X - mu
            Sw_new += d.T @ d + n * cov
            n_spk += 1
        Sw = Sw_new / max(n_tot, 1) + 1e-8 * np.eye(dim)
        Sb = Sb_new / max(n_spk, 1) + 1e-8 * np.eye(dim)
    # simultaneous diagonalization: whiten Sw, eigendecompose Sb
    evals_w, evecs_w = np.linalg.eigh(Sw)
    wh = evecs_w @ np.diag(np.maximum(evals_w, 1e-10) ** -0.5) @ evecs_w.T
    Bw = wh @ Sb @ wh.T
    psi, U = np.linalg.eigh(Bw)
    order = np.argsort(psi)[::-1]
    transform = U[:, order].T @ wh
    psi = np.maximum(psi[order], 0.0)
    logger.info("PLDA: top psi %s", np.round(psi[:5], 3))
    return Plda(mean, transform, psi)
