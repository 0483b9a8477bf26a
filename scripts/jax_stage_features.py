#!/usr/bin/env python3
"""The JAX package's RM feature stage, written where the port's recipe
resumes from it: the first step of ROADMAP 3.14's stage bisection.

    JAX_PLATFORMS=cpu python3 scripts/jax_stage_features.py D --seeds 29 30
    python3 scripts/rm_diagnose.py --exp-dir D --stage 1 --seeds 29 30

For each seed, computes ``rm.run``'s "features" stage with the JAX
package (MFCC + deltas of train / dev / test at seeds N / N + 1 / N + 2,
the JAX dither draws, on the CPU) and pickles it as the stage runner
does, into ``D/seed<N>``, so that ``rm_diagnose.py --stage 1`` runs the
port's GMM chain, DNN and decode on the JAX package's features.

``--port-deltas`` keeps the JAX package's static MFCC (its dither draws)
and takes the deltas again as the port does, over each utterance's true
frames with edge replication, where the JAX extractor takes them over
the zero-padded length bucket (ROADMAP 3.6): the run from those
features tells the delta convention's share from the draws'.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def port_deltas(feats):
    """[T, 39] MFCC + deltas -> the statics with the port's deltas."""
    import torch
    from kaldi_cnn_tpu_torch.features import functional as TF
    return TF.compute_deltas(torch.as_tensor(np.array(feats[:, :13])),
                             2).numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--seeds", type=int, nargs="+", default=[29])
    ap.add_argument("--num-utts", type=int, default=140)
    ap.add_argument("--port-deltas", action="store_true")
    a = ap.parse_args(argv)
    from kaldi_cnn_tpu.core.stages import StageRunner
    from kaldi_cnn_tpu.recipes import synthetic
    from kaldi_cnn_tpu.recipes.yesno import compute_features
    for seed in a.seeds:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_corpus(lex, wp, a.num_utts, 1, 4, seed)
        traindev, test = corpus.split(0.2)
        train, dev = traindev.split(0.15)
        value = (compute_features(train, False, seed),
                 compute_features(dev, False, seed + 1),
                 compute_features(test, False, seed + 2))
        if a.port_deltas:
            value = tuple({u: port_deltas(f) for u, f in s.items()}
                          for s in value)
        d = os.path.join(a.out, f"seed{seed}")
        runner = StageRunner(d, 0)
        runner.stage("features", lambda: value)
        print(f"seed {seed}: {sorted(os.listdir(d))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
