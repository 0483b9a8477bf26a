"""Nnet = ordered component list; AmNnet = Nnet + pdf priors.

Twin of ``kaldi_cnn_tpu/models/nnet.py`` for inference: ``Nnet.forward``
(eval only), ``Nnet.predict`` with the fused conv+maxpool pair, and
``AmNnet`` with ``loglikes``/``loglikes_batch``
(ref: src/nnet2/nnet-nnet.cc, am-nnet.cc, decodable-am-nnet.cc).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from kaldi_cnn_tpu_torch.models.components import (
    Conv2DComponent, Maxpooling3DComponent)
from kaldi_cnn_tpu_torch.ops.common import round_up
from kaldi_cnn_tpu_torch.ops.conv import conv2d_maxpool


def _fusable(c, nxt) -> bool:
    return (isinstance(c, Conv2DComponent) and c.fused
            and isinstance(nxt, Maxpooling3DComponent)
            and nxt.pool_c == 1
            and c.stride_t == 1 and c.stride_f == 1
            and nxt.in_t == c.out_t and nxt.in_f == c.out_f
            and nxt.in_c == c.num_filters
            and c.out_t % nxt.pool_t == 0
            and c.out_f % nxt.pool_f == 0)


class Nnet(nn.Module):
    def __init__(self, components: Sequence[nn.Module]):
        super().__init__()
        self.components = nn.ModuleList(components)

    @property
    def input_dim(self) -> int:
        for c in self.components:
            d = getattr(c, "input_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    @property
    def output_dim(self) -> int:
        for c in reversed(self.components):
            d = getattr(c, "output_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Nnet":
        for c in self.components:
            c.init(generator)
        return self

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Unfused eval forward through every component."""
        for c in self.components:
            x = c(x)
        return x

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Inference forward.  Adjacent Conv2D(fused=True) +
        Maxpooling3D(pool_c=1) pairs run as ONE fused conv+maxpool kernel
        (ops.conv.conv2d_maxpool, bf16 operands with f32 accumulation as
        in the Pallas default); everything else runs unfused."""
        comps = self.components
        i = 0
        while i < len(comps):
            c = comps[i]
            nxt = comps[i + 1] if i + 1 < len(comps) else None
            if _fusable(c, nxt):
                x = conv2d_maxpool(x, c.w, c.b, c, nxt.pool_t, nxt.pool_f)
                i += 2
                continue
            x = c(x)
            i += 1
        return x


class AmNnet:
    """Nnet + pdf priors.  Decoding uses pseudo log-likelihoods
    log p(pdf|x) - log prior(pdf) (ref: decodable-am-nnet.cc)."""

    def __init__(self, nnet: Nnet, num_pdfs: Optional[int] = None):
        self.nnet = nnet
        self.num_pdfs = num_pdfs or nnet.output_dim
        self.priors = np.full(self.num_pdfs, 1.0 / self.num_pdfs,
                              np.float64)

    def set_priors_from_counts(self, counts: np.ndarray,
                               smooth: float = 0.5) -> None:
        c = np.asarray(counts, np.float64) + smooth
        self.priors = c / c.sum()

    def _posteriors(self, X: np.ndarray, batch_size: int) -> np.ndarray:
        """predict over [T, D] in zero-padded batch_size slices."""
        T = X.shape[0]
        padded = round_up(T, batch_size)
        x = torch.zeros((padded, X.shape[1]), dtype=torch.float32,
                        device=self.nnet.device)
        x[:T] = torch.as_tensor(X, device=x.device)
        outs = [self.nnet.predict(x[i:i + batch_size])
                for i in range(0, padded, batch_size)]
        return torch.cat(outs)[:T].cpu().numpy()

    def _loglikes(self, post: np.ndarray) -> np.ndarray:
        return (np.log(np.maximum(post, 1e-20))
                - np.log(self.priors)[None, :]).astype(np.float32)

    def loglikes(self, feats: np.ndarray, batch_size: int = 512
                 ) -> np.ndarray:
        """[T, D] -> [T, num_pdfs] pseudo log-likelihoods."""
        return self._loglikes(self._posteriors(
            np.asarray(feats, np.float32), batch_size))

    def loglikes_batch(self, feats: Dict[str, np.ndarray],
                       batch_size: int = 4096) -> Dict[str, np.ndarray]:
        """Pseudo log-likelihoods for a keyed utterance set in ONE padded
        stream: frames of all utterances concatenate into [total, D], run
        through predict in batch_size slices, and split back."""
        keys = list(feats)
        if not keys:
            return {}
        lens = [int(feats[u].shape[0]) for u in keys]
        X = np.concatenate([np.asarray(feats[u], np.float32) for u in keys])
        ll = self._loglikes(self._posteriors(X, batch_size))
        out, off = {}, 0
        for u, n in zip(keys, lens):
            out[u] = ll[off:off + n]
            off += n
        return out
