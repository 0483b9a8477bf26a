#!/usr/bin/env python3
"""Streaming with one recognizer piece a chunk against two, on the card.

    python3 scripts/stream_pieces.py

``OnlineRecognizer`` hands its decoder pieces of ``chunk_frames`` frames
(default 10).  At 0.2 s chunks (20 frames) that splits every chunk in
two: two AM calls, each padded to 512 rows, two CMVN + deltas passes over
the stream and two decoder advances.  ``chip_smoke.py`` and the
``online2-wav-latgen`` verb set ``chunk_frames`` to the chunk's frame
count.  This script measures what the split costs, in one process on one
card: it trains the model of ``chip_smoke.py``'s phase 8 (``wsj.run`` on
RECIPE_UTTS utterances, RECIPE_EPOCHS epochs, without the DNN), serves
its test split once to capture the block graphs, then at ``chunk_frames``
10, 20, 20, 10 (each pass ``chip_smoke.stream_utterance`` over every
test utterance), and prints for each pass the RTF, the median and p95 ms
of an ``accept_waveform`` call, the seconds of base features, CMVN +
deltas, AM and search, and the conv kernel's launches.  Prints the GPU's
name and power limit first.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from kaldi_cnn_tpu_torch.ops import common  # noqa: E402
from kaldi_cnn_tpu_torch.ops.conv import conv2d_maxpool  # noqa: E402
from kaldi_cnn_tpu_torch.recipes import wsj  # noqa: E402

ORDER = (10, 20, 20, 10)


def serve(test, am, stream, chunk_frames):
    secs = dict.fromkeys(("base features", "cmvn + deltas", "am", "search"),
                         0.0)
    conv2d_maxpool.launches = 0
    call_ms = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for u in sorted(test.waves):
        call_ms += cs.stream_utterance(test.waves[u], test.sample_rate, am,
                                       stream, secs, chunk_frames)[4]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    audio_s = sum(len(w) for w in test.waves.values()) / test.sample_rate
    return {"chunk_frames": chunk_frames, "wall_s": wall,
            "rtf": wall / audio_s, "median_ms": float(np.median(call_ms)),
            "p95_ms": float(np.percentile(call_ms, 95)),
            "conv_launches": conv2d_maxpool.launches,
            **{k + "_s": v for k, v in secs.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_pieces: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"gpu: {cs.gpu_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    common.build()
    common.library()
    dev = torch.device("cuda")
    corpus = wsj.make_corpus(cs.RECIPE_UTTS, cs.SEED)
    test = wsj.split_corpus(corpus)[2]
    tmp = tempfile.mkdtemp(prefix="stream_pieces_")
    try:
        exp = os.path.join(tmp, "wsj")
        wsj.run(corpus=corpus, nnet_epochs=cs.RECIPE_EPOCHS, seed=cs.SEED,
                device=dev, exp_dir=exp)
        *_, am, stream = cs.streaming_model(dev, exp, test)
        serve(test, am, stream, None)           # captures the graphs
        rows = [serve(test, am, stream, n) for n in ORDER]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in rows:
        print(json.dumps(r))
    for n in sorted(set(ORDER)):
        mine = [r for r in rows if r["chunk_frames"] == n]
        print(f"chunk_frames {n}: RTF "
              + ", ".join(f"{r['rtf']:.4f}" for r in mine) + "; median ms "
              + ", ".join(f"{r['median_ms']:.2f}" for r in mine)
              + "; cmvn + deltas s "
              + ", ".join(f"{r['cmvn + deltas_s']:.3f}" for r in mine)
              + "; AM s " + ", ".join(f"{r['am_s']:.3f}" for r in mine)
              + "; search s "
              + ", ".join(f"{r['search_s']:.3f}" for r in mine))
    return 0


if __name__ == "__main__":
    sys.exit(main())
