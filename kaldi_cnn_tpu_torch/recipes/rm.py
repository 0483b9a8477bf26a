"""The RM-style recipe (twin of ``kaldi_cnn_tpu/recipes/rm.py``).  Only the
lattice rescoring sweep is ported so far; the WSJ recipe's
``decode_and_score`` picks its operating point with it.  The GMM chain,
the fMLLR features and the p-norm DNN are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.decode.lattice import shortest_path
from kaldi_cnn_tpu_torch.decode.score import wer_details


def score_sweep(lats: Dict[str, "object"], refs, word_table,
                scales=(0.02, 0.05, 0.1, 0.2),
                wips=(-2.0, -1.0, -0.5, 0.0, 0.5)
                ) -> Tuple[float, Tuple[float, float], Dict]:
    """Lattice rescoring sweep (ref: local/score.sh LMWT x WIP grid):
    decode once, rescore the lattices per operating point."""
    best = (np.inf, (0.1, 0.0), None)
    for s in scales:
        for wip in wips:
            hyps = {}
            for utt, lat in lats.items():
                _, wids, _ = shortest_path(lat, 1.0, s, wip)
                hyps[utt] = [word_table.sym(int(w)) for w in wids]
            r = wer_details(refs, hyps)
            if r["wer"] < best[0]:
                best = (r["wer"], (s, wip), r)
    return best
