"""MLLT (global semi-tied covariance) estimation.

Clean-room equivalent of src/transform/mllt.{h,cc} (MlltAccs): the
square feature-space transform M maximizing the diagonal-covariance
auxiliary  beta*log|det M| - 1/2 sum_i m_i^T G_i m_i,  where
G_i = sum_{t,m} gamma_m(t)/sigma^2_{m,i} (x_t - mu_m)(x_t - mu_m)^T,
optimized by Gales' row-wise closed-form iteration.
"""

from __future__ import annotations

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class MlltAccs:
    def __init__(self, dim: int):
        self.beta = 0.0
        self.G = np.zeros((dim, dim, dim), np.float64)

    @property
    def dim(self) -> int:
        return self.G.shape[0]

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   inv_vars: np.ndarray, posteriors: np.ndarray) -> None:
        """feats [T,D]; means/inv_vars [M,D] for the Gaussians;
        posteriors [T,M] (ref: MlltAccs::AccumulateFromPosteriors)."""
        f = np.asarray(feats, np.float64)
        post = np.asarray(posteriors, np.float64)
        self.beta += float(post.sum())
        for m in range(means.shape[0]):
            w = post[:, m]
            sel = w > 1e-8
            if not sel.any():
                continue
            d = f[sel] - means[m]
            wd = d * w[sel, None]
            # per-dim scatter, scaled by that dim's inverse variance
            S = wd.T @ d
            self.G += inv_vars[m][:, None, None] * S[None, :, :]

    def update(self, num_iters: int = 10) -> np.ndarray:
        """Returns the square transform M [D, D]
        (ref: MlltAccs::Update)."""
        d = self.dim
        M = np.eye(d)
        Ginv = np.stack([np.linalg.inv(
            self.G[i] + 1e-6 * np.trace(self.G[i]) / d * np.eye(d))
            for i in range(d)])
        for _ in range(num_iters):
            for i in range(d):
                # cofactor row: row i of det(M) * inv(M)^T
                c = np.linalg.inv(M).T[i] * np.linalg.det(M)
                gc = Ginv[i] @ c
                denom = float(c @ gc)
                if denom <= 0:
                    continue
                M[i] = gc * np.sqrt(self.beta / denom)
        sign, logdet = np.linalg.slogdet(M)
        assert sign > 0 or logdet != -np.inf, "MLLT became singular"
        objf = self.beta * logdet - 0.5 * sum(
            M[i] @ self.G[i] @ M[i] for i in range(d))
        logger.info("MLLT: logdet %.4f, auxf/frame %.4f", logdet,
                    objf / max(self.beta, 1.0))
        return M

    def objf(self, M: np.ndarray) -> float:
        _, logdet = np.linalg.slogdet(M)
        return float(self.beta * logdet - 0.5 * sum(
            M[i] @ self.G[i] @ M[i] for i in range(self.dim)))
