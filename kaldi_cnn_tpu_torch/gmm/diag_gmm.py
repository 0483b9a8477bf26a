"""Diagonal-covariance GMM (ref: src/gmm/diag-gmm.{h,cc} DiagGmm).

Stored in natural parameters like the reference: per-component weights,
means, inverse variances; log-likelihood uses the precomputed
``gconsts`` trick so scoring is an affine map of [x, x^2]:

    logN(x; m, v) = gconst + sum_d (m_d/v_d) x_d - 0.5 sum_d x_d^2 / v_d

which batches into one matmul for a whole utterance.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


class DiagGmm:
    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 variances: np.ndarray):
        """weights [K], means [K, D], variances [K, D] (diagonal)."""
        self.weights = np.asarray(weights, np.float64)
        self.means = np.asarray(means, np.float64)
        self.vars = np.maximum(np.asarray(variances, np.float64), 1e-10)

    @property
    def num_gauss(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @staticmethod
    def from_stats(mean: np.ndarray, var: np.ndarray) -> "DiagGmm":
        return DiagGmm(np.ones(1), mean[None, :], var[None, :])

    def gconsts(self) -> np.ndarray:
        """[K] log(w) - 0.5 * (D log(2pi) + sum log v + sum m^2/v)."""
        return (np.log(np.maximum(self.weights, 1e-30))
                - 0.5 * (self.dim * math.log(2 * math.pi)
                         + np.sum(np.log(self.vars), axis=1)
                         + np.sum(self.means ** 2 / self.vars, axis=1)))

    def component_loglikes(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T, K] per-component log-likelihoods."""
        inv = 1.0 / self.vars
        lin = feats @ (self.means * inv).T              # [T, K]
        quad = (feats ** 2) @ (0.5 * inv).T             # [T, K]
        return self.gconsts()[None, :] + lin - quad

    def loglikes(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T] total log-likelihood (logsumexp over comps)."""
        c = self.component_loglikes(feats)
        m = c.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(c - m).sum(axis=1)))

    def posteriors(self, feats: np.ndarray) -> np.ndarray:
        c = self.component_loglikes(feats)
        c -= c.max(axis=1, keepdims=True)
        p = np.exp(c)
        return p / p.sum(axis=1, keepdims=True)

    def split(self, target: int, rng: np.random.Generator,
              perturb: float = 0.01) -> "DiagGmm":
        """Mixture-up by splitting heaviest components
        (ref: diag-gmm.cc DiagGmm::Split)."""
        w, m, v = list(self.weights), list(self.means), list(self.vars)
        while len(w) < target:
            i = int(np.argmax(w))
            d = perturb * np.sqrt(v[i]) * rng.standard_normal(self.dim)
            w_i = w[i] / 2
            w[i] = w_i
            w.append(w_i)
            m.append(m[i] + d)
            m[i] = m[i] - d
            v.append(v[i].copy())
        return DiagGmm(np.array(w), np.array(m), np.array(v))


class DiagGmmAccs:
    """ML accumulators (ref: src/gmm/mle-diag-gmm.{h,cc} AccumDiagGmm)."""

    def __init__(self, num_gauss: int, dim: int):
        self.occ = np.zeros(num_gauss)
        self.sum_x = np.zeros((num_gauss, dim))
        self.sum_x2 = np.zeros((num_gauss, dim))

    def accumulate(self, gmm: DiagGmm, feats: np.ndarray,
                   weights: np.ndarray) -> None:
        """feats [T, D], weights [T] frame posteriors/occupancies."""
        post = gmm.posteriors(feats) * weights[:, None]   # [T, K]
        self.occ += post.sum(axis=0)
        self.sum_x += post.T @ feats
        self.sum_x2 += post.T @ (feats ** 2)

    def update(self, gmm: DiagGmm, min_occ: float = 3.0,
               var_floor: float = 1e-3) -> DiagGmm:
        """(ref: mle-diag-gmm.cc MleDiagGmmUpdate: skip low-occupancy
        components, floor variances)."""
        tot = self.occ.sum()
        w = gmm.weights.copy()
        m = gmm.means.copy()
        v = gmm.vars.copy()
        for k in range(gmm.num_gauss):
            if self.occ[k] < min_occ:
                continue
            w[k] = self.occ[k] / max(tot, 1e-10)
            m[k] = self.sum_x[k] / self.occ[k]
            v[k] = np.maximum(
                self.sum_x2[k] / self.occ[k] - m[k] ** 2, var_floor)
        w = w / w.sum()
        return DiagGmm(w, m, v)
