"""Online iVectors: per-chunk updates of the utterance iVector.

Clean-room equivalent of src/online2/online-ivector-feature.{h,cc}
(OnlineIvectorFeature): UBM stats accumulate as frames arrive
(optionally decayed to ``max_count``); the served iVector at frame t is
the posterior mean given the stats so far, recomputed every
``ivector_period`` frames — appended to each acoustic frame by the
feature pipeline (the Switchboard CNN + online-iVector config).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.ivector.extractor import IvectorExtractor


@configclass
class OnlineIvectorOptions:
    ivector_period: int = 10
    max_count: float = 0.0       # 0 = no decay
    min_post: float = 0.025


class OnlineIvectorFeature:
    def __init__(self, extractor: IvectorExtractor,
                 opts: Optional[OnlineIvectorOptions] = None):
        self.ext = extractor
        self.opts = opts or OnlineIvectorOptions()
        K, D = extractor.ubm.num_gauss, extractor.dim
        self.gamma = np.zeros(K)
        self.X = np.zeros((K, D))
        self._frames_seen = 0
        self._current = np.zeros(extractor.R)
        self._since_update = 0

    def accept_frames(self, feats: np.ndarray) -> None:
        """feats [n, D] raw (non-spliced) frames."""
        post = self.ext.ubm.posteriors(feats)
        post = np.where(post < self.opts.min_post, 0.0, post)
        post = post / np.maximum(post.sum(axis=1, keepdims=True), 1e-10)
        self.gamma += post.sum(axis=0)
        self.X += post.T @ feats
        self._frames_seen += feats.shape[0]
        self._since_update += feats.shape[0]
        if self.opts.max_count > 0 and \
                self.gamma.sum() > self.opts.max_count:
            scale = self.opts.max_count / self.gamma.sum()
            self.gamma *= scale
            self.X *= scale
        if self._since_update >= self.opts.ivector_period:
            self._refresh()

    def _refresh(self) -> None:
        L, b = self.ext.posterior_params(self.gamma, self.X)
        self._current = np.linalg.solve(L, b)
        self._since_update = 0

    def ivector(self) -> np.ndarray:
        return self._current.copy()
