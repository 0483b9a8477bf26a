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

``--classify`` (the port only) sorts each DNN test utterance that loses
words into one class and counts the deleted words by word;
``--wide-search`` and ``--host-subset N`` decode the deleted utterances
again with a wider search and with the host ``lattice_decode``
(``scripts/deletions.py``).  ``--dump DIR`` (the port only) keeps the
DNN test decode's graph, loglikes, references and point in
``DIR/rm_<package>_seed<N>.npz``, and the line names the test
utterances that lose words (``test_deleted``); ``libri_diagnose.py
--decode-inputs`` decodes such a file with either package.

    python3 scripts/rm_diagnose.py --eval-utts 900 --seeds 29 \
        --classify --wide-search --host-subset 16

On the card, the GPU's name and power limit come first, and again as
each line's first key (``gpu``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from deletions import (Recorder, classify, gpu_name,  # noqa: E402
                       save_inputs, test_deleted)

WIDE_SCALES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0)
WIDE_WIPS = (-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5)
KEYS = ("gmm_dev_wer", "gmm_test_wer", "dnn_dev_wer", "wer", "errors",
        "words", "sub", "ins", "del", "gmm_point", "dnn_point",
        "tree_leaves", "seconds")


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
    ap.add_argument("--classify", action="store_true")
    ap.add_argument("--wide-search", action="store_true")
    ap.add_argument("--host-subset", type=int, default=0)
    ap.add_argument("--dump", default="")
    ap.add_argument("--dump-deleted", action="store_true",
                    help="--dump only the test utterances that lose words")
    ap.add_argument("--note", default="",
                    help="kept as each line's 'note' (e.g. where the "
                         "--exp-dir artifacts came from)")
    a = ap.parse_args(argv)
    port = a.package == "kaldi_cnn_tpu_torch"
    if (a.wide_grid or a.classify or a.dump) and not port:
        ap.error("--wide-grid, --classify and --dump read the port's "
                 "decodes")
    gpu = (gpu_name() if port and a.device.startswith("cuda")
           else None)
    if gpu:
        print("gpu:", gpu, flush=True)
    rm = importlib.import_module(f"{a.package}.recipes.rm")
    for seed in a.seeds:
        kw = dict(num_utts=a.num_utts, seed=seed, nnet_epochs=a.epochs,
                  eval_utts=a.eval_utts, stage=a.stage,
                  exp_dir=(os.path.join(a.exp_dir, f"seed{seed}")
                           if a.exp_dir else None))
        if port:
            kw["device"] = a.device
        gmm = []
        record = a.wide_grid or a.classify or a.dump
        if record:
            saved = rm.gmm_decode
            rm.gmm_decode = recording(rm, "gmm_decode", gmm)
        t = time.perf_counter()
        try:
            with Recorder(rm, a.package) as rec:
                res = rm.run(**kw)
        finally:
            if record:
                rm.gmm_decode = saved
        wall_s = time.perf_counter() - t
        line = {**({"gpu": gpu} if gpu else {}), "package": a.package,
                "device": (a.device if port else
                           os.environ.get("JAX_PLATFORMS") or "jax-default"),
                "seed": seed, "num_utts": a.num_utts,
                "eval_utts": a.eval_utts, "epochs": a.epochs,
                "stage": a.stage,
                **{k: res[k] for k in KEYS if k in res},
                "wall_s": wall_s, **({"note": a.note} if a.note else {})}
        if record:
            train, dev, test = rm.make_corpus(a.num_utts, seed,
                                              a.eval_utts)
            word_table = gmm[0][0][5].word_table
        if a.dump:
            line["test_deleted"] = test_deleted(
                a.package, rec.calls[-1], test.transcripts, word_table,
                res["dnn_point"])
            os.makedirs(a.dump, exist_ok=True)
            save_inputs(os.path.join(a.dump, f"rm_{a.package}_seed{seed}"
                                     ".npz"), rec.calls[-1],
                        test.transcripts, word_table, res["dnn_point"],
                        line["test_deleted"] if a.dump_deleted else None)
        if a.classify:
            line["classes"] = classify(
                rec.calls[-1], test.transcripts, word_table,
                res["dnn_point"], train.transcripts, a.device,
                a.wide_search, a.host_subset)
        if a.wide_grid:
            line["wide_gmm"] = wide_grid(rm, gmm[0][1][0], gmm[1][1][0],
                                         dev, test, word_table)
            line["wide_dnn"] = wide_grid(rm, rec.calls[0]["lats"],
                                         rec.calls[1]["lats"], dev,
                                         test, word_table)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
