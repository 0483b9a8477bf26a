#!/usr/bin/env python3
"""The Switchboard recipe's WER over seeds, in either package, and where
the port's errors come from.

    python3 scripts/swbd_diagnose.py --seeds 43 44 45 --ablate
    JAX_PLATFORMS=cpu python3 scripts/swbd_diagnose.py \
        --package kaldi_cnn_tpu --seeds 43 44 45

For each seed, runs the package's ``recipes.swbd.run`` at the ledger
configuration (``--eval-utts-per-speaker 34``, everything else at its
default) and prints one JSON line: dev and test WER, test errors by kind
and the wall seconds.  ``kaldi_cnn_tpu_torch`` (the default) runs on the
card; ``kaldi_cnn_tpu`` (the JAX reference) runs wherever JAX is set to
run, and imports nothing of the port.

With ``--ablate`` (the port only), each seed also prints:

1. the test WER at the best dev point of a wider rescoring grid than
   ``score_sweep``'s (acoustic scales to 1.0, word insertion penalties
   to -8), from the recipe's own lattices;
2. the test WER at the recipe's point after decoding the test rows
   again with every utterance's iVector columns replaced by the mean
   test iVector, which takes away what the iVector tells the net.

With ``--classify`` (the port only), each seed also prints the
classification of the test utterances that lose words and the deleted
words by word; ``--wide-search`` and ``--host-subset N`` decode the
deleted utterances again with a wider search and with the host
``lattice_decode`` (``scripts/deletions.py``).

    python3 scripts/swbd_diagnose.py --seeds 43 --classify --wide-search \
        --host-subset 16
    python3 scripts/swbd_diagnose.py --device cpu --seeds 43 --dump D

``--device`` is the port's (the card by default); ``--dump DIR`` keeps
the test decode's graph, loglikes, references and point in
``DIR/swbd_<package>_seed<N>.npz`` and names the test utterances that
lose words (``test_deleted``), for ``libri_diagnose.py
--decode-inputs``.

On the card, the GPU's name and power limit come first.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from deletions import (Recorder, classify, save_inputs,  # noqa: E402
                       test_deleted)

SCALES = (0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0)
WIPS = (-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5)
IVECTOR_DIM = 12     # swbd.run's default ivector_dim
ERROR_KEYS = ("wer", "errors", "words", "sub", "ins", "del")


@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """Record (args, result) of every call to ``module.name``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def scored(lats, refs, word_table, point) -> dict:
    from kaldi_cnn_tpu_torch.decode.lattice import shortest_path
    from kaldi_cnn_tpu_torch.decode.score import wer_details
    hyps = {}
    for u, lat in lats.items():
        _, wids, _ = shortest_path(lat, 1.0, point[0], point[1])
        hyps[u] = [word_table.sym(int(w)) for w in wids]
    r = wer_details(refs, hyps)
    return {k: r[k] for k in ERROR_KEYS}


def ablations(swbd, decodes, sweeps, point, seed: int,
              eval_utts: int) -> None:
    """Steps 1 and 2 of the module's docstring on one run's decodes."""
    import numpy as np
    (dev_args, dev_lats), (test_args, test_lats) = decodes
    am, rows, hclg = test_args[:3]
    word_table = sweeps[0][0][2]
    _, dev, test = swbd.make_corpus(seed=seed,
                                    eval_utts_per_speaker=eval_utts)
    dev_wer, wide, _ = swbd.score_sweep(dev_lats, dev.transcripts,
                                        word_table, SCALES, WIPS)
    print(json.dumps({"step": "wide grid", "seed": seed, "point": wide,
                      "dev_wer": dev_wer,
                      **scored(test_lats, test.transcripts, word_table,
                               wide)}), flush=True)
    mean = np.mean([r[0, -IVECTOR_DIM:] for r in rows.values()], axis=0)
    changed = {}
    for u, r in rows.items():
        r = r.copy()
        r[:, -IVECTOR_DIM:] = mean
        changed[u] = r
    lats = swbd.nnet_decode(am, changed, hclg)
    print(json.dumps({"step": "test mean iVector", "seed": seed,
                      "point": point,
                      **scored(lats, test.transcripts, word_table,
                               point)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="kaldi_cnn_tpu_torch",
                    choices=("kaldi_cnn_tpu_torch", "kaldi_cnn_tpu"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[43])
    ap.add_argument("--eval-utts-per-speaker", type=int, default=34)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--classify", action="store_true")
    ap.add_argument("--wide-search", action="store_true")
    ap.add_argument("--host-subset", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default="")
    ap.add_argument("--dump-deleted", action="store_true",
                    help="--dump only the test utterances that lose words")
    a = ap.parse_args()
    port = a.package == "kaldi_cnn_tpu_torch"
    if (a.ablate or a.classify or a.dump) and not port:
        ap.error("--ablate, --classify and --dump need the port")
    swbd = importlib.import_module(f"{a.package}.recipes.swbd")
    if port and a.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("swbd_diagnose: the port's recipe needs a CUDA GPU",
                  file=sys.stderr)
            return 1
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"gpu: {gpu.stdout.strip()}", flush=True)
    for seed in a.seeds:
        decodes, sweeps = [], []
        t0 = time.time()
        with contextlib.ExitStack() as stack:
            if a.ablate:
                stack.enter_context(recorded(swbd, "nnet_decode", decodes))
            if a.ablate or a.classify or a.dump:
                stack.enter_context(recorded(swbd, "score_sweep", sweeps))
            rec = stack.enter_context(Recorder(swbd, a.package))
            res = swbd.run(seed=seed, **({"device": a.device} if port
                                         else {}),
                           eval_utts_per_speaker=a.eval_utts_per_speaker)
        print(json.dumps({"step": "recipe", "package": a.package,
                          "seed": seed, "dev_wer": res["dev_wer"],
                          "point": res.get("point"),
                          **{k: res[k] for k in ERROR_KEYS},
                          "seconds": time.time() - t0}), flush=True)
        if a.classify or a.dump:
            train, _, test = swbd.make_corpus(
                seed=seed, eval_utts_per_speaker=a.eval_utts_per_speaker)
            point = tuple(res["point"])
        if a.dump:
            deleted = test_deleted(a.package, rec.calls[-1],
                                   test.transcripts, sweeps[0][0][2], point)
            os.makedirs(a.dump, exist_ok=True)
            save_inputs(os.path.join(a.dump, f"swbd_{a.package}_seed{seed}"
                                     ".npz"), rec.calls[-1],
                        test.transcripts, sweeps[0][0][2], point,
                        deleted if a.dump_deleted else None)
            print(json.dumps({"step": "dump", "seed": seed,
                              "test_deleted": deleted}), flush=True)
        if a.classify:
            print(json.dumps({"step": "classes", "seed": seed, **classify(
                rec.calls[-1], test.transcripts, sweeps[0][0][2], point,
                train.transcripts, a.device, a.wide_search,
                a.host_subset)}), flush=True)
        if a.ablate:
            ablations(swbd, decodes, sweeps, tuple(res["point"]), seed,
                      a.eval_utts_per_speaker)
    return 0


if __name__ == "__main__":
    sys.exit(main())
