#!/usr/bin/env python3
"""The RM recipe's GMM-SAT and DNN WERs over seeds, devices and
packages.

    python3 scripts/rm_diagnose.py --seeds 29 30 31            # port, card
    python3 scripts/rm_diagnose.py --device cpu --seeds 29      # port, CPU
    JAX_PLATFORMS=cpu python3 scripts/rm_diagnose.py \
        --package kaldi_cnn_tpu --seeds 29
    python3 scripts/rm_diagnose.py --seeds 29 --exp-dir D --stage 5
    python3 scripts/rm_diagnose.py --eval-utts 900 --seeds 29 --wide-grid

For each seed, runs the package's ``recipes.rm.run`` (``--num-utts``
utterances, ``--eval-utts`` eval utterances, ``--epochs`` epochs) and
prints one JSON line: GMM-SAT and DNN dev and test WER, the DNN's test
errors by kind, each stage's seconds (the port) and the wall seconds.
``kaldi_cnn_tpu_torch`` (the default) runs on ``--device``;
``kaldi_cnn_tpu`` (the JAX reference) runs wherever JAX is set to run,
and imports nothing of the port.

``--exp-dir D`` keeps each seed's stage artifacts in ``D/seed<N>`` and
``--stage K`` resumes from them: with the artifacts of a run on another
device (copied into ``D/seed<N>``) and ``--stage 5``, the DNN is trained
and decoded on this device from that run's GMM chain and features.

With ``--wide-grid`` (the port only), each seed also prints, for the
GMM-SAT and the DNN lattices of the run, the dev point of a wider
rescoring grid than ``score_sweep``'s (acoustic scales 0.01-1.0, word
insertion penalties to -8) and the test WER and deletions there.

On the card, the GPU's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDE_SCALES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0)
WIDE_WIPS = (-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5)
KEYS = ("gmm_dev_wer", "gmm_test_wer", "dnn_dev_wer", "wer", "errors",
        "words", "sub", "ins", "del", "gmm_point", "dnn_point", "seconds")


def recording(module, name: str, calls: list):
    """``module.name`` that appends (args, result) of each call to
    ``calls``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out
    return wrapper


def wide_grid(rm, dev_lats, test_lats, dev, test, word_table) -> dict:
    """The dev point of the wide grid and the test WER there."""
    wer, pt, _ = rm.score_sweep(dev_lats, dev.transcripts, word_table,
                                WIDE_SCALES, WIDE_WIPS)
    res = rm.wer_details(test.transcripts,
                         rm.best_hyps(test_lats, pt, word_table))
    return {"point": pt, "dev_wer": wer, "test_wer": res["wer"],
            "del": res["del"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="kaldi_cnn_tpu_torch",
                    choices=["kaldi_cnn_tpu_torch", "kaldi_cnn_tpu"])
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the JAX package ignores it)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[29])
    ap.add_argument("--num-utts", type=int, default=140)
    ap.add_argument("--eval-utts", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--exp-dir", default=None)
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--wide-grid", action="store_true")
    a = ap.parse_args(argv)
    port = a.package == "kaldi_cnn_tpu_torch"
    if a.wide_grid and not port:
        ap.error("--wide-grid reads the port's decodes")
    if port and a.device.startswith("cuda"):
        print("gpu:", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    rm = importlib.import_module(f"{a.package}.recipes.rm")
    for seed in a.seeds:
        kw = dict(num_utts=a.num_utts, seed=seed, nnet_epochs=a.epochs,
                  eval_utts=a.eval_utts, stage=a.stage,
                  exp_dir=(os.path.join(a.exp_dir, f"seed{seed}")
                           if a.exp_dir else None))
        if port:
            kw["device"] = a.device
        gmm, dnn = [], []
        if a.wide_grid:
            saved = rm.gmm_decode, rm.nnet_decode
            rm.gmm_decode = recording(rm, "gmm_decode", gmm)
            rm.nnet_decode = recording(rm, "nnet_decode", dnn)
        t = time.perf_counter()
        try:
            res = rm.run(**kw)
        finally:
            if a.wide_grid:
                rm.gmm_decode, rm.nnet_decode = saved
        wall_s = time.perf_counter() - t
        line = {"package": a.package,
                "device": a.device if port else "jax-default",
                "seed": seed, "num_utts": a.num_utts,
                "eval_utts": a.eval_utts, "epochs": a.epochs,
                "stage": a.stage,
                **{k: res[k] for k in KEYS if k in res},
                "wall_s": wall_s}
        if a.wide_grid:
            _, dev, test = rm.make_corpus(a.num_utts, seed, a.eval_utts)
            word_table = gmm[0][0][5].word_table
            line["wide_gmm"] = wide_grid(rm, gmm[0][1][0], gmm[1][1][0],
                                         dev, test, word_table)
            line["wide_dnn"] = wide_grid(rm, dnn[0][1], dnn[1][1], dev,
                                         test, word_table)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
