"""Equal alignment for a flat start: twin of ``align_equal`` in
``kaldi_cnn_tpu/gmm/train.py`` (the port imports nothing of the JAX
package).  The rest of the GMM bootstrap is not ported yet."""

from __future__ import annotations

from typing import Optional

import numpy as np

from kaldi_cnn_tpu_torch.decode.decoder import viterbi_align
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph


def align_equal(graph: CompiledGraph, num_frames: int) -> Optional[np.ndarray]:
    """Uniform first-pass alignment (ref: align-equal-compiled): Viterbi
    with flat acoustics, so only graph/transition costs decide."""
    flat = np.zeros((num_frames, int(graph.e_pdf.max()) + 1), np.float32)
    return viterbi_align(graph, flat, acoustic_scale=0.0)
