"""The yesno recipe's feature stage (twin of
``kaldi_cnn_tpu/recipes/yesno.py::compute_features``), which the WSJ
recipe's GMM bootstrap shares.  The rest of the yesno recipe is not
ported yet."""

from __future__ import annotations

from typing import Dict

import numpy as np

from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor


def compute_features(corpus, seed: int = 0, device="cuda"
                     ) -> Dict[str, np.ndarray]:
    """MFCC + deltas of order 2 per utterance at dither 1.0 (ref:
    steps/make_mfcc.sh + add-deltas in train_mono), extracted on
    ``device``; utterance i dithers from stage ("mfcc_dither", i) of
    ``seed``.  Returns host numpy: the GMM bootstrap consumes features on
    the host."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    ex = FeatureExtractor(opts, device=device, deltas_order=2)
    return ex.extract_corpus(corpus.waves, seed)
