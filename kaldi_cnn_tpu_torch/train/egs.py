"""Training examples (egs): spliced frame rows + pdf labels, and the
static-shape minibatch server.

Twin of ``kaldi_cnn_tpu/train/egs.py`` (ref: nnet-example.{h,cc},
nnet-get-egs, nnet-shuffle-egs): ``EgsConfig``, ``make_egs``, ``Egs``
and ``EgsBatcher``.  The shuffles come from the same numpy streams, so
the egs and the batches are the JAX package's, trailing zero-weight
padding included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.core.rng import np_rng
from kaldi_cnn_tpu_torch.features.functional import splice_frames


@configclass
class EgsConfig:
    left_context: int = 4
    right_context: int = 4
    seed: int = 0


@dataclass
class Egs:
    """All examples as dense arrays (fits memory for our corpora; the
    ark-sharded variant writes/loads npz shards)."""

    x: np.ndarray        # [N, spliced_dim] float32
    y: np.ndarray        # [N] int32 pdf labels
    weights: np.ndarray  # [N] float32

    def __len__(self):
        return len(self.y)

    def save(self, path: str) -> None:
        np.savez_compressed(path, x=self.x, y=self.y, weights=self.weights)

    @staticmethod
    def load(path: str) -> "Egs":
        z = np.load(path)
        return Egs(z["x"], z["y"], z["weights"])


def make_egs(
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    tid_to_pdf: np.ndarray,
    config: Optional[EgsConfig] = None,
) -> Egs:
    """feats[utt] [T, D]; alignments[utt] [T] transition-ids."""
    config = config or EgsConfig()
    xs, ys = [], []
    for utt in sorted(feats):
        if utt not in alignments:
            continue
        f = np.asarray(feats[utt], np.float32)
        ali = np.asarray(alignments[utt])
        if len(ali) != f.shape[0]:
            continue
        spliced = np.asarray(splice_frames(
            f, config.left_context, config.right_context))
        xs.append(spliced)
        ys.append(tid_to_pdf[ali])
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    rng = np_rng(config.seed, "egs_shuffle")
    perm = rng.permutation(len(y))
    return Egs(x[perm], y[perm], np.ones(len(y), np.float32))


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
