"""Per-utterance fbank and MFCC extraction (twin of
``kaldi_cnn_tpu/features/extractor.py``).

PyTorch runs eagerly, so the JAX package's per-length jit buckets have
no counterpart: each waveform goes through ``ops.fbank.fbank`` or
``ops.fbank.mfcc`` (the CUDA kernel on a CUDA device, its plain version
on the CPU) at its own length, and deltas are taken over its true
frames.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.ops.fbank import fbank, mfcc


class FeatureExtractor:
    """The options' type picks the kind: ``F.MfccOptions`` gives MFCC,
    ``F.FbankOptions`` (the default) fbank."""

    def __init__(self, opts=None, device="cuda", deltas_order: int = 0):
        self.opts = opts or F.FbankOptions()
        self.kind = ("mfcc" if isinstance(self.opts, F.MfccOptions)
                     else "fbank")
        self.device = torch.device(device)
        self.deltas_order = deltas_order
        self._fn = mfcc if self.kind == "mfcc" else fbank

    @torch.no_grad()
    def __call__(self, wave: np.ndarray,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        x = torch.as_tensor(np.asarray(wave, np.float32).reshape(-1),
                            device=self.device)
        feats = self._fn(x, self.opts, generator)
        if self.deltas_order > 0:
            feats = F.compute_deltas(feats, self.deltas_order)
        return feats.cpu().numpy()

    def extract_corpus(self, waves: Dict[str, np.ndarray], seed: int = 0
                       ) -> Dict[str, np.ndarray]:
        """Utterances in sorted order; utterance i dithers from its own
        generator, stage ("<kind>_dither", i) of ``seed``."""
        stage = f"{self.kind}_dither"
        return {utt: self(wave, torch_generator(seed, stage, i))
                for i, (utt, wave) in enumerate(sorted(waves.items()))}
