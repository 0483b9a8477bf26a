"""LDA estimation over class-labeled acoustic frames.

Clean-room equivalent of src/transform/lda-estimate.{h,cc}
(LdaEstimate): accumulate per-class (pdf) first-order stats + global
second-order stats, solve the generalized eigenproblem on
between-class vs within-class scatter, and return a projecting affine
transform [dim_out x (dim_in+1)] whose last column recenters the data
(the reference's default --remove-offset=true behavior in
steps/train_lda_mllt.sh via est-lda).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class LdaEstimate:
    def __init__(self, num_classes: int, dim: int):
        self.zero_acc = np.zeros(num_classes, np.float64)
        self.first_acc = np.zeros((num_classes, dim), np.float64)
        self.total_second_acc = np.zeros((dim, dim), np.float64)

    @property
    def dim(self) -> int:
        return self.first_acc.shape[1]

    def accumulate(self, feats: np.ndarray, classes: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> None:
        """feats [T, D], classes [T] int — one class (pdf) per frame."""
        f = np.asarray(feats, np.float64)
        w = (np.ones(len(f)) if weights is None
             else np.asarray(weights, np.float64))
        np.add.at(self.zero_acc, classes, w)
        np.add.at(self.first_acc, classes, f * w[:, None])
        self.total_second_acc += (f * w[:, None]).T @ f

    def estimate(self, target_dim: int,
                 within_class_factor: float = 1.0
                 ) -> Tuple[np.ndarray, float]:
        """Returns (transform [target_dim, dim+1], objf = sum of kept
        eigenvalues).  Algorithm as in LdaEstimate::Estimate: total
        covar T, between-class covar B, solve B v = λ (T - B) v via
        whitening."""
        count = self.zero_acc.sum()
        assert count > 0, "no stats"
        d = self.dim
        total_mean = self.first_acc.sum(axis=0) / count
        # total covariance
        T = self.total_second_acc / count - np.outer(total_mean, total_mean)
        # between-class covariance
        B = np.zeros((d, d), np.float64)
        for c in range(len(self.zero_acc)):
            n = self.zero_acc[c]
            if n <= 0:
                continue
            mu = self.first_acc[c] / n
            diff = mu - total_mean
            B += (n / count) * np.outer(diff, diff)
        W = T - B                       # within-class
        # regularize + whiten W
        W += 1e-6 * np.trace(W) / d * np.eye(d)
        evals_w, evecs_w = np.linalg.eigh(W)
        evals_w = np.maximum(evals_w, 1e-10)
        wh = evecs_w @ np.diag(evals_w ** -0.5) @ evecs_w.T
        Bw = wh @ B @ wh.T
        evals, evecs = np.linalg.eigh(Bw)
        order = np.argsort(evals)[::-1][:target_dim]
        proj = (evecs[:, order].T @ wh) * within_class_factor
        objf = float(evals[order].sum())
        offset = -proj @ total_mean
        logger.info("LDA: kept %d/%d dims, sum of eigs %.3f",
                    target_dim, d, objf)
        return np.concatenate([proj, offset[:, None]], axis=1), objf


def apply_affine(feats: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """x -> A x + b for transform [out, in+1] (ref: transform-feats)."""
    return feats @ transform[:, :-1].T + transform[:, -1]


def compose_affine(second: np.ndarray, first: np.ndarray) -> np.ndarray:
    """(second ∘ first) as one [out, in+1] affine
    (ref: compose-transforms)."""
    A2, b2 = second[:, :-1], second[:, -1]
    A1, b1 = first[:, :-1], first[:, -1]
    return np.concatenate([A2 @ A1, (A2 @ b1 + b2)[:, None]], axis=1)
