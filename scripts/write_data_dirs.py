#!/usr/bin/env python3
"""Writes Kaldi data directories of the synthetic corpora, for the
recipes' ``--data-dir`` flags and the command-line verbs:

    python3 scripts/write_data_dirs.py OUT

gives ``OUT/yesno`` (the yesno recipe's own 100-utterance corpus, seed
17, with its ``lexicon.txt`` inside) and ``OUT/wsj`` (``wsj.make_corpus``
at its default 160 utterances, seed 37) with ``OUT/wsj_lexicon.txt``;
then

    python3 -m kaldi_cnn_tpu_torch.recipes.yesno --data-dir OUT/yesno
    python3 -m kaldi_cnn_tpu_torch.recipes.wsj --data-dir OUT/wsj \\
        --lexicon OUT/wsj_lexicon.txt

With ``--run-wsj`` it then runs the WSJ recipe on the card from
``OUT/wsj`` twice and prints a JSON line for each: as the ``--data-dir``
run reads it (the unigram estimated from the transcripts, the waves
rounded to int16), and with the synthetic corpus's own word
probabilities given to it, which leaves the rounding as the one
difference from the corpus in memory.  Each line holds the WER, the
errors by kind and the classification of the test utterances that lose
words (``scripts/deletions.py``; ``--wide-search`` and ``--host-subset
N`` as there).  On the card the GPU's name and power limit come first,
and again as each line's first key (``gpu``).
``--device cpu`` runs it on the CPU; ``--dump DIR`` keeps each run's
test decode in ``DIR/wsj_datadir_<word probs>.npz`` (``--dump-deleted``:
only the utterances that lose words) and names its test utterances that
lose words (``test_deleted``), for ``libri_diagnose.py
--decode-inputs``.

    python3 scripts/write_data_dirs.py OUT --run-wsj --wide-search \\
        --host-subset 16

``--seed N`` writes ``wsj.make_corpus(160, N)`` and runs the recipe at
seed N (the default 37 is the recipe's own).  ``--probs estimated``
runs only the first of the two variants, ``--no-classify`` leaves the
classification out.  ``--package kaldi_cnn_tpu``
runs the JAX package's ``wsj.run`` on the data dir instead (wherever
JAX is set to run; it prints the WER and errors, no classification):

    JAX_PLATFORMS=cpu python3 scripts/write_data_dirs.py OUT --run-wsj \\
        --seed 38 --probs estimated --package kaldi_cnn_tpu
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from deletions import (Recorder, classify, gpu_name,  # noqa: E402
                       save_inputs, test_deleted)
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj  # noqa: E402
from kaldi_cnn_tpu_torch.recipes.datadir import (  # noqa: E402
    write_data_dir, write_lexicon_file)

ERROR_KEYS = ("dev_wer", "wer", "errors", "words", "sub", "ins", "del",
              "point")


def write(out: str, seed: int = 37):
    """The two data dirs; returns the WSJ corpus written."""
    lex = synthetic.yesno_lexicon()
    c = synthetic.make_corpus(lex, {"yes": 0.5, "no": 0.5}, 100, 1, 3, 17)
    write_data_dir(os.path.join(out, "yesno"), c.waves, c.transcripts,
                   None, c.sample_rate)
    write_lexicon_file(os.path.join(out, "yesno", "lexicon.txt"), lex)
    c = wsj.make_corpus(160, seed)
    write_data_dir(os.path.join(out, "wsj"), c.waves, c.transcripts, None,
                   c.sample_rate)
    write_lexicon_file(os.path.join(out, "wsj_lexicon.txt"), c.lexicon)
    print(f"data dirs in {out}", flush=True)
    return c


def run_jax_wsj(out: str, synthetic_corpus, seed: int, probs_list) -> None:
    """The JAX package's recipe from ``out/wsj`` (module doc)."""
    from kaldi_cnn_tpu.recipes import wsj as jwsj
    from kaldi_cnn_tpu.recipes.datadir import corpus_from_data_dir
    for probs in probs_list:
        corpus = corpus_from_data_dir(os.path.join(out, "wsj"),
                                      os.path.join(out, "wsj_lexicon.txt"))
        if probs == "synthetic":
            corpus.word_probs = dict(synthetic_corpus.word_probs)
        t = time.perf_counter()
        res = jwsj.run(seed=seed, corpus=corpus)
        print(json.dumps({
            "package": "kaldi_cnn_tpu", "corpus": "data dir", "seed": seed,
            "word_probs": probs,
            "device": os.environ.get("JAX_PLATFORMS") or "jax-default",
            **{k: res[k] for k in ERROR_KEYS if k in res},
            "seconds": time.perf_counter() - t}), flush=True)


def run_wsj(out: str, synthetic_corpus, wide: bool, host_subset: int,
            device: str = "cuda", dump: str = "",
            dump_deleted: bool = False, seed: int = 37,
            probs_list=("estimated", "synthetic"),
            classes: bool = True) -> None:
    """The WSJ recipe from ``out/wsj`` as read, then with the synthetic
    word probabilities (module doc)."""
    from kaldi_cnn_tpu_torch.lang.hclg import Lang
    gpu = gpu_name() if device.startswith("cuda") else None
    if gpu:
        print("gpu:", gpu, flush=True)
    for probs in probs_list:
        corpus = wsj.corpus_from_data_dir(os.path.join(out, "wsj"),
                                          os.path.join(out,
                                                       "wsj_lexicon.txt"))
        if probs == "synthetic":
            corpus.word_probs = dict(synthetic_corpus.word_probs)
        t = time.perf_counter()
        with Recorder(wsj, "kaldi_cnn_tpu_torch") as rec:
            res = wsj.run(device=device, corpus=corpus, seed=seed)
        line = {**({"gpu": gpu} if gpu else {}), "corpus": "data dir",
                "seed": seed, "word_probs": probs, "device": device,
                **{k: res[k] for k in ERROR_KEYS},
                "seconds": time.perf_counter() - t}
        dev_call, test_call = rec.calls[0], rec.calls[1]
        test_refs = {u: corpus.transcripts[u] for u in test_call["loglikes"]}
        train = {u: w for u, w in corpus.transcripts.items()
                 if u not in test_refs and u not in dev_call["loglikes"]}
        words, point = (Lang.create(corpus.lexicon).word_table,
                        tuple(res["point"]))
        line["test_deleted"] = test_deleted("kaldi_cnn_tpu_torch", test_call,
                                            test_refs, words, point)
        if dump:
            os.makedirs(dump, exist_ok=True)
            save_inputs(os.path.join(dump, f"wsj_datadir_{probs}.npz"),
                        test_call, test_refs, words, point,
                        line["test_deleted"] if dump_deleted else None)
        if classes:
            line["classes"] = classify(test_call, test_refs, words, point,
                                       train, device, wide, host_subset)
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--run-wsj", action="store_true")
    ap.add_argument("--wide-search", action="store_true")
    ap.add_argument("--host-subset", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default="")
    ap.add_argument("--dump-deleted", action="store_true",
                    help="--dump only the test utterances that lose words")
    ap.add_argument("--seed", type=int, default=37)
    ap.add_argument("--no-classify", action="store_true")
    ap.add_argument("--probs", choices=["both", "estimated"],
                    default="both")
    ap.add_argument("--package", default="kaldi_cnn_tpu_torch",
                    choices=["kaldi_cnn_tpu_torch", "kaldi_cnn_tpu"])
    a = ap.parse_args(argv)
    c = write(a.out, a.seed)
    probs = (("estimated",) if a.probs == "estimated"
             else ("estimated", "synthetic"))
    if a.run_wsj and a.package == "kaldi_cnn_tpu":
        run_jax_wsj(a.out, c, a.seed, probs)
    elif a.run_wsj:
        run_wsj(a.out, c, a.wide_search, a.host_subset, a.device, a.dump,
                a.dump_deleted, a.seed, probs, not a.no_classify)
    return 0


if __name__ == "__main__":
    sys.exit(main())
