"""Training examples (egs): spliced frame rows + pdf labels, and the
static-shape minibatch server.

Twin of ``Egs`` and ``EgsBatcher`` in ``kaldi_cnn_tpu/train/egs.py``
(ref: nnet-example.{h,cc}, nnet-shuffle-egs), importable without jax:
the JAX module's import chain reaches jax through ``core/rng``.  The
shuffles come from the same numpy streams, so the batches are the JAX
package's, trailing zero-weight padding included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.rng import np_rng


@dataclass
class Egs:
    """All examples as dense arrays."""

    x: np.ndarray        # [N, spliced_dim] float32
    y: np.ndarray        # [N] int32 pdf labels
    weights: np.ndarray  # [N] float32

    def __len__(self):
        return len(self.y)


class EgsBatcher:
    """Static-shape minibatches with per-epoch reshuffle
    (ref: nnet-shuffle-egs + --minibatch-size).  The trailing partial
    minibatch is padded with repeated examples at zero weight."""

    def __init__(self, egs: Egs, minibatch_size: int = 512, seed: int = 0):
        self.egs = egs
        self.minibatch_size = minibatch_size
        self.seed = seed

    def num_batches(self) -> int:
        return -(-len(self.egs) // self.minibatch_size)

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]]:
        rng = np_rng(self.seed, "egs_epoch", epoch_idx)
        perm = rng.permutation(len(self.egs))
        mb = self.minibatch_size
        for i in range(0, len(perm), mb):
            sel = perm[i:i + mb]
            w = np.ones(len(sel), np.float32)
            if len(sel) < mb:
                pad = rng.integers(0, len(self.egs), mb - len(sel))
                sel = np.concatenate([sel, pad])
                w = np.concatenate([w, np.zeros(mb - len(w), np.float32)])
            yield (self.egs.x[sel], self.egs.y[sel], w)
