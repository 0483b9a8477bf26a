#!/usr/bin/env python3
"""The seed tables of ROADMAP 3.14 and 3.23: each arm's test WER by seed,
its median, and a two-sided Mann-Whitney p for each pair of arms.

    python3 scripts/seed_stats.py > scripts/seed_stats.jsonl

Reads ``scripts/rm_diagnose.jsonl`` (RM at 140 utterances, 25 epochs,
no eval corpus; seeds 29-40) and ``scripts/write_data_dirs.jsonl``
(the WSJ data dir, word probabilities estimated; seeds 37-41; a line
without ``seed`` is the recipe's 37).  Arms: the port on the card
(``"device": "cuda"``), the port on the CPU, and the JAX package on the
CPU; for RM also the stage bisection's runs of the port on the card
from the JAX package's feature stage (``scripts/jax_stage_features.py``,
with and without ``--port-deltas``, named by the lines' ``note``),
which two are also compared seed by seed (paired Wilcoxon).  Where a
seed has several lines in an arm, the last one counts (the runs
reproduce to the word).  Prints one JSON line a recipe.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np
from scipy import stats

HERE = os.path.dirname(os.path.abspath(__file__))


def arm(line: dict) -> str:
    if line.get("package") == "kaldi_cnn_tpu":
        return "jax_cpu"
    note = line.get("note", "")
    if "jax_stage_features.py --port-deltas" in note:
        return "port_card_from_jax_statics_port_deltas"
    if "jax_stage_features.py" in note:
        return "port_card_from_jax_features"
    return "port_card" if line.get("device") == "cuda" else "port_cpu"


def read(path: str, keep) -> dict:
    """{arm: {seed: wer}} of the lines ``keep`` accepts."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = json.loads(raw)
            seed = keep(line)
            if seed is not None:
                out.setdefault(arm(line), {})[seed] = float(line["wer"])
    return out


def rm_line(line: dict):
    """Stage 0, or stage 1 from the bisection's JAX feature stages."""
    stage = line.get("stage")
    if (line.get("num_utts") == 140 and line.get("eval_utts") == 0
            and line.get("epochs") == 25 and "wer" in line
            and 29 <= line["seed"] <= 40
            and (stage == 0 or (stage == 1 and "jax_stage_features.py"
                                in line.get("note", "")))):
        return line["seed"]
    return None


def wsj_line(line: dict):
    if (line.get("corpus") == "data dir"
            and line.get("word_probs") == "estimated" and "wer" in line):
        return line.get("seed", 37)
    return None


def table(name: str, wers: dict) -> dict:
    arms = {a: dict(sorted(v.items())) for a, v in sorted(wers.items())}
    pairs, paired = {}, {}
    for a, b in itertools.combinations(sorted(arms), 2):
        x, y = list(arms[a].values()), list(arms[b].values())
        p = stats.mannwhitneyu(x, y, alternative="two-sided").pvalue
        pairs[f"{a} vs {b}"] = float(p)
        if "from_jax" in a and "from_jax" in b and arms[a].keys() == \
                arms[b].keys():
            seeds = sorted(arms[a])
            paired[f"{a} vs {b}"] = float(stats.wilcoxon(
                [arms[a][k] for k in seeds], [arms[b][k] for k in seeds]
            ).pvalue)
    return {"device": "cpu", "recipe": name,
            "wer": {a: {str(s): w for s, w in v.items()}
                    for a, v in arms.items()},
            "n": {a: len(v) for a, v in arms.items()},
            "median": {a: float(np.median(list(v.values())))
                       for a, v in arms.items()},
            "mean": {a: float(np.mean(list(v.values())))
                     for a, v in arms.items()},
            "mann_whitney_p": pairs, "paired_wilcoxon_p": paired}


def main() -> int:
    print(json.dumps(table("rm", read(os.path.join(
        HERE, "rm_diagnose.jsonl"), rm_line))))
    print(json.dumps(table("wsj_data_dir", read(os.path.join(
        HERE, "write_data_dirs.jsonl"), wsj_line))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
