#!/usr/bin/env python3
"""The Librispeech recipe's WER over seeds and rescoring grids.

    python3 scripts/libri_diagnose.py --seeds 53 --eval-utts 800 --wide-grid
    python3 scripts/libri_diagnose.py --device cpu --num-utts 36 --epochs 2
    JAX_PLATFORMS=cpu python3 scripts/libri_diagnose.py \
        --package kaldi_cnn_tpu --seeds 53 --eval-utts 800

For each seed, runs the package's ``recipes.librispeech.run``
(``--num-utts`` utterances, ``--eval-utts`` eval utterances, ``--epochs``
epochs) and prints one JSON line: dev and test WER, the test errors by
kind, the operating point, each stage's seconds (the port) and the wall
seconds.  ``kaldi_cnn_tpu_torch`` (the default) runs on ``--device`` as
a process group of one; ``kaldi_cnn_tpu`` (the JAX reference) runs
wherever JAX is set to run, and imports nothing of the port.

With ``--wide-grid`` (the port only), the line also holds, for the run's
dev and test lattices, the dev point of a wider rescoring grid than
``score_sweep``'s (acoustic scales 0.01-2.0, word insertion penalties
-16 to 0.5) and the test WER and deletions there, and the grid's point
of least test WER (an oracle: it reads the test references).  The grid
is rescored in ``--jobs`` forked processes.

On the card, the GPU's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDE_SCALES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0)
WIDE_WIPS = (-16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5)
KEYS = ("dev_wer", "wer", "errors", "words", "sub", "ins", "del", "point",
        "tree_leaves", "train_audio_ss", "seconds")

# the forked rescoring workers read these: (lattices, refs, word table)
_SETS = {}


def _score(args):
    """(name, point) -> (point, wer, deletions) of set ``name``'s
    lattices rescored at ``point``."""
    from kaldi_cnn_tpu_torch.decode.score import wer_details
    from kaldi_cnn_tpu_torch.recipes.rm import best_hyps
    name, point = args
    lats, refs, word_table = _SETS[name]
    r = wer_details(refs, best_hyps(lats, point, word_table))
    return point, r["wer"], r["del"]


def wide_grid(dev_lats, test_lats, dev, test, word_table, jobs,
              recipe: dict) -> dict:
    """The dev point of the wide grid and the test WER there; the grid's
    least test WER.  The grid holds ``score_sweep``'s points, and at the
    recipe's own point it must give the recipe's dev and test WER."""
    _SETS.update(dev=(dev_lats, dev.transcripts, word_table),
                 test=(test_lats, test.transcripts, word_table))
    points = [(s, wip) for s in WIDE_SCALES for wip in WIDE_WIPS]
    work = [(name, p) for name in ("dev", "test") for p in points]
    with multiprocessing.get_context("fork").Pool(jobs) as pool:
        out = pool.map(_score, work)
    dev_res, test_res = out[:len(points)], out[len(points):]
    k = points.index(tuple(recipe["point"]))
    if (dev_res[k][1], test_res[k][1]) != (recipe["dev_wer"],
                                           recipe["wer"]):
        raise AssertionError(f"the grid's WERs at {points[k]} are "
                             f"{dev_res[k][1]}, {test_res[k][1]}, not the "
                             f"recipe's {recipe['dev_wer']}, "
                             f"{recipe['wer']}")
    # the first point of least dev WER, score_sweep's tie rule
    i = min(range(len(points)), key=lambda k: (dev_res[k][1], k))
    j = min(range(len(points)), key=lambda k: (test_res[k][1], k))
    return {"point": points[i], "dev_wer": dev_res[i][1],
            "test_wer": test_res[i][1], "del": test_res[i][2],
            "test_oracle": {"point": points[j], "wer": test_res[j][1],
                            "del": test_res[j][2]},
            "points": len(points)}


def recording(module, name: str, calls: list):
    """``module.name`` that appends the result of each call to
    ``calls``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out
    return wrapper


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="kaldi_cnn_tpu_torch",
                    choices=["kaldi_cnn_tpu_torch", "kaldi_cnn_tpu"])
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the JAX package ignores it)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[53])
    ap.add_argument("--num-utts", type=int, default=200)
    ap.add_argument("--eval-utts", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--wide-grid", action="store_true")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="processes that rescore the wide grid")
    a = ap.parse_args(argv)
    port = a.package == "kaldi_cnn_tpu_torch"
    if a.wide_grid and not port:
        ap.error("--wide-grid reads the port's decodes")
    if port and a.device.startswith("cuda"):
        print("gpu:", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    lib = importlib.import_module(f"{a.package}.recipes.librispeech")
    for seed in a.seeds:
        kw = dict(num_utts=a.num_utts, seed=seed, nnet_epochs=a.epochs,
                  eval_utts=a.eval_utts)
        if port:
            kw["device"] = a.device
        lats = []
        if a.wide_grid:
            saved = lib.nnet_decode
            lib.nnet_decode = recording(lib, "nnet_decode", lats)
        t = time.perf_counter()
        try:
            res = lib.run(**kw)
        finally:
            if a.wide_grid:
                lib.nnet_decode = saved
        wall_s = time.perf_counter() - t
        line = {"package": a.package,
                "device": a.device if port else "jax-default",
                "seed": seed, "num_utts": a.num_utts,
                "eval_utts": a.eval_utts, "epochs": a.epochs,
                **{k: res[k] for k in KEYS if k in res},
                "wall_s": wall_s}
        if a.wide_grid:
            from kaldi_cnn_tpu_torch.lang.hclg import Lang
            t = time.perf_counter()
            train, dev, test = lib.make_corpus(a.num_utts, seed,
                                               a.eval_utts)
            word_table = Lang.create(train.lexicon).word_table
            line["wide"] = wide_grid(lats[0], lats[1], dev, test,
                                     word_table, a.jobs, res)
            line["wide"]["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
