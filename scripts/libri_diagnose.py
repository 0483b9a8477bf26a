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

Every line also holds ``test_deleted``: each test utterance that loses
words at the run's point, with its count of deletions (both packages).
The port's options, each on the run's test decode (``deletions.py``):

  --classify        sorts each deleted utterance into one class (no final
                    state, determinize's pop budget, lost in the prune or
                    the determinization, not in the raw lattice, or
                    outscored) and counts the deleted words by word
  --wide-search     decodes the deleted utterances again at lattice beam
                    16, max_active 7000 and acoustic scale 0.2
  --host-subset N   and the first N with the host ``lattice_decode`` and no
                    cap on the active states
  --dump DIR        keeps the test decode's graph, loglikes, references
                    and point in ``DIR/libri_<package>_seed<N>.npz``
                    (with --dump-deleted, only the utterances that lose
                    words: small enough to bring back from the card)

``--decode-inputs FILE`` decodes such a file with ``--package``'s
``decode_utterances`` (on ``--device`` for the port; with
``--deleted-from RUN.jsonl`` only the utterances that run's
``test_deleted`` names) and prints one line of each utterance's words;
``--compare A B`` reads two such lines and prints the utterances whose
words differ.  ``--classify-inputs FILE`` runs ``--classify`` (and
``--wide-search``, ``--host-subset``) on such a file's decode, the
training transcripts from ``--seeds``' first seed and ``--num-utts``.

    python3 scripts/libri_diagnose.py --device cpu --seeds 53 \
        --eval-utts 800 --classify --dump D
    JAX_PLATFORMS=cpu python3 scripts/libri_diagnose.py \
        --package kaldi_cnn_tpu \
        --decode-inputs D/libri_kaldi_cnn_tpu_torch_seed53.npz

On the card, the GPU's name and power limit come first, and again as
each line's first key (``gpu``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from deletions import (Recorder, classify, classify_inputs,  # noqa: E402
                       decode_inputs, gpu_name, save_inputs, test_deleted)

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


def make_corpus(package: str, num_utts: int, seed: int, eval_utts: int):
    """The recipe's (train, dev, test) from ``package``'s synthetic corpus
    (the JAX ``run`` builds it inline, the port's ``make_corpus``)."""
    synthetic = importlib.import_module(f"{package}.recipes.synthetic")
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    train = synthetic.make_corpus(lex, wp, num_utts, 2, 5, seed)
    if eval_utts > 0:
        dev, test = synthetic.make_corpus(lex, wp, eval_utts, 2, 5,
                                          seed + 9001).split(0.5)
        return train, dev, test
    train, test = train.split(0.15)
    train, dev = train.split(0.1)
    return train, dev, test


def decode_and_compare(a) -> int:
    """``--decode-inputs`` and ``--compare``."""
    if a.compare:
        x, y = (json.loads([ln for ln in open(p) if ln.startswith("{")][-1])
                for p in a.compare)
        differ = sorted(u for u in x["words"]
                        if x["words"][u] != y["words"].get(u))
        print(json.dumps({"a": x["package"], "b": y["package"],
                          "utts": len(x["words"]),
                          "wer": [x["wer"], y["wer"]],
                          "del": [x["del"], y["del"]],
                          "differ": differ}), flush=True)
        return 0
    utts = None
    if a.deleted_from:
        line = [ln for ln in open(a.deleted_from)
                if ln.startswith("{") and '"test_deleted"' in ln][-1]
        utts = sorted(json.loads(line)["test_deleted"])
    port = a.package == "kaldi_cnn_tpu_torch"
    gpu = gpu_name() if port and a.device.startswith("cuda") else None
    print(json.dumps({**({"gpu": gpu} if gpu else {}),
                      "inputs": os.path.basename(a.decode_inputs),
                      "deleted_from": (os.path.basename(a.deleted_from)
                                       or None),
                      **decode_inputs(a.decode_inputs, a.package, a.device,
                                      utts)}), flush=True)
    return 0


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
    ap.add_argument("--classify", action="store_true")
    ap.add_argument("--wide-search", action="store_true")
    ap.add_argument("--host-subset", type=int, default=0)
    ap.add_argument("--dump", default="")
    ap.add_argument("--dump-deleted", action="store_true",
                    help="--dump only the test utterances that lose words")
    ap.add_argument("--decode-inputs", default="")
    ap.add_argument("--deleted-from", default="",
                    help="with --decode-inputs: only the test utterances "
                         "that lose words in this file's last line")
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--classify-inputs", default="",
                    help="--classify (with --wide-search, --host-subset) "
                         "on a --dump file's decode, the port on --device")
    a = ap.parse_args(argv)
    port = a.package == "kaldi_cnn_tpu_torch"
    if (a.wide_grid or a.classify) and not port:
        ap.error("--wide-grid and --classify read the port's decodes")
    gpu = (gpu_name() if port and a.device.startswith("cuda")
           else None)
    if gpu:
        print("gpu:", gpu, flush=True)
    if a.decode_inputs or a.compare:
        return decode_and_compare(a)
    if a.classify_inputs:
        train = make_corpus(a.package, a.num_utts, a.seeds[0],
                            a.eval_utts)[0]
        print(json.dumps({"inputs": os.path.basename(a.classify_inputs),
                          "device": a.device, "classes": classify_inputs(
                              a.classify_inputs, train.transcripts,
                              a.device, a.wide_search, a.host_subset)}),
              flush=True)
        return 0
    lib = importlib.import_module(f"{a.package}.recipes.librispeech")
    for seed in a.seeds:
        kw = dict(num_utts=a.num_utts, seed=seed, nnet_epochs=a.epochs,
                  eval_utts=a.eval_utts)
        if port:
            kw["device"] = a.device
        t = time.perf_counter()
        with Recorder(lib, a.package) as rec:
            res = lib.run(**kw)
        wall_s = time.perf_counter() - t
        dev_call, test_call = rec.calls[0], rec.calls[-1]
        line = {**({"gpu": gpu} if gpu else {}), "package": a.package,
                "device": a.device if port else "jax-default",
                "seed": seed, "num_utts": a.num_utts,
                "eval_utts": a.eval_utts, "epochs": a.epochs,
                **{k: res[k] for k in KEYS if k in res},
                "wall_s": wall_s}
        train, dev, test = make_corpus(a.package, a.num_utts, seed,
                                       a.eval_utts)
        word_table = importlib.import_module(
            f"{a.package}.lang.hclg").Lang.create(train.lexicon).word_table
        point = res.get("point") or importlib.import_module(
            f"{a.package}.recipes.rm").score_sweep(
                dev_call["lats"], dev.transcripts, word_table)[1]
        line["test_deleted"] = test_deleted(a.package, test_call,
                                            test.transcripts, word_table,
                                            point)
        if a.dump:
            os.makedirs(a.dump, exist_ok=True)
            save_inputs(os.path.join(
                a.dump, f"libri_{a.package}_seed{seed}.npz"), test_call,
                test.transcripts, word_table, point,
                line["test_deleted"] if a.dump_deleted else None)
        if a.wide_grid:
            t = time.perf_counter()
            line["wide"] = wide_grid(dev_call["lats"], test_call["lats"],
                                     dev, test, word_table, a.jobs, res)
            line["wide"]["seconds"] = time.perf_counter() - t
        if a.classify:
            line["classes"] = classify(
                test_call, test.transcripts, word_table, point,
                train.transcripts, a.device, a.wide_search, a.host_subset)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
