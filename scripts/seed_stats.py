#!/usr/bin/env python3
"""The seed tables of ROADMAP 3.14 and 3.23: each arm's test WER by seed,
its median, a two-sided Mann-Whitney p for each pair of arms with its
Holm-corrected value, and the paired tests of the delta conventions.

    python3 scripts/seed_stats.py > scripts/seed_stats.jsonl

Reads ``scripts/rm_diagnose.jsonl`` (RM at 140 utterances, 25 epochs,
no eval corpus) and ``scripts/write_data_dirs.jsonl`` (the WSJ data
dir, word probabilities estimated; seeds 37-41; a line without ``seed``
is the recipe's 37).  Where a seed has several lines in an arm, the
last one counts (the runs reproduce to the word).  Prints one JSON line
a recipe.

RM arms, seeds 29-40 (the Mann-Whitney table): the port on the card
(``"device": "cuda"``), the port on the CPU, the JAX package on the
CPU, and the stage bisection's runs of the port on the card from the
JAX package's feature stage (``scripts/jax_stage_features.py``, with
and without ``--port-deltas``, named by the lines' ``note``), which two
are also compared seed by seed (paired Wilcoxon).

The paired run of the two delta conventions on the CPU, named by the
``note``'s "arm X:" prefix (its design is fixed in PERF.md before the
runs; ``scripts/delta_arms.py`` runs them): A, the port from the JAX
package's features, and B, from its statics with the port's deltas,
seeds 29-64; C, the JAX package from its statics with the port's
deltas, seeds 29-40, paired with ``jax_cpu``.  Each pair gets a two-sided
Wilcoxon signed-rank p (``scipy.stats.wilcoxon``, zero differences
dropped), the Hodges-Lehmann shift (the median of the Walsh averages
of the differences) with its 95 % interval (the normal approximation of
the signed-rank distribution), and the seeds that go each way, for the
DNN test WER, the GMM-SAT test WER and the tree's leaves.  The card's
arms stay apart from the CPU's: no test pools the devices.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import sys

import numpy as np
from scipy import stats

HERE = os.path.dirname(os.path.abspath(__file__))

PAIRED_ARMS = {"A": "A_port_cpu_from_jax_features",
               "B": "B_port_cpu_from_jax_statics_port_deltas",
               "C": "C_jax_cpu_from_jax_statics_port_deltas"}
# (later, earlier): each row is later - earlier, seed by seed.
PAIRS = (("B", "A"), ("C", "jax_cpu"))
METRICS = {"dnn_test_wer": "wer", "gmm_test_wer": "gmm_test_wer",
           "tree_leaves": "tree_leaves"}


def arm(line: dict) -> str:
    note = line.get("note", "")
    for key, name in PAIRED_ARMS.items():
        if note.startswith(f"arm {key}:"):
            return name
    if line.get("package") == "kaldi_cnn_tpu":
        return "jax_cpu"
    if "jax_stage_features.py --port-deltas" in note:
        return "port_card_from_jax_statics_port_deltas"
    if "jax_stage_features.py" in note:
        return "port_card_from_jax_features"
    return "port_card" if line.get("device") == "cuda" else "port_cpu"


def read(path: str, keep) -> dict:
    """{arm: {seed: line}} of the lines ``keep`` accepts."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = json.loads(raw)
            seed = keep(line)
            if seed is not None:
                out.setdefault(arm(line), {})[seed] = line
    return out


def rm_line(line: dict):
    """Stage 0, or stage 1 from the bisection's JAX feature stages; the
    paired arms' seeds 29-64, the others' 29-40."""
    stage, note = line.get("stage"), line.get("note", "")
    paired = arm(line) in PAIRED_ARMS.values()
    if (line.get("num_utts") == 140 and line.get("eval_utts") == 0
            and line.get("epochs") == 25 and "wer" in line
            and 29 <= line["seed"] <= (64 if paired else 40)
            and (stage == 0 or (stage == 1 and "jax_stage_features.py"
                                in note))):
        return line["seed"]
    return None


def wsj_line(line: dict):
    if (line.get("corpus") == "data dir"
            and line.get("word_probs") == "estimated" and "wer" in line):
        return line.get("seed", 37)
    return None


def holm(ps: dict) -> dict:
    """Holm's step-down adjustment of a family of p values."""
    order = sorted(ps, key=ps.get)
    out, running = {}, 0.0
    for i, k in enumerate(order):
        running = max(running, min(1.0, (len(order) - i) * ps[k]))
        out[k] = running
    return {k: out[k] for k in ps}


def hodges_lehmann(d: np.ndarray, level: float = 0.95):
    """The median of the Walsh averages of ``d`` and the interval of the
    signed-rank test at ``level`` (normal approximation)."""
    n = len(d)
    walsh = np.sort([(d[i] + d[j]) / 2 for i in range(n)
                     for j in range(i, n)])
    z = stats.norm.ppf(0.5 + level / 2)
    k = int(math.floor(n * (n + 1) / 4
                       - z * math.sqrt(n * (n + 1) * (2 * n + 1) / 24)))
    k = max(k, 0)
    return (float(np.median(walsh)),
            [float(walsh[k]), float(walsh[len(walsh) - 1 - k])])


def paired(later: dict, earlier: dict, key: str) -> dict:
    """``later`` - ``earlier`` seed by seed over the seeds both have."""
    seeds = sorted(s for s in later.keys() & earlier.keys()
                   if key in later[s] and key in earlier[s])
    if len(seeds) < 2:
        return {"n": len(seeds)}
    x = np.array([float(later[s][key]) for s in seeds])
    y = np.array([float(earlier[s][key]) for s in seeds])
    d = x - y
    shift, ci = hodges_lehmann(d)
    nonzero = np.count_nonzero(d)
    return {"n": len(seeds), "seeds": [seeds[0], seeds[-1]],
            "wilcoxon_p": (float(stats.wilcoxon(x, y).pvalue) if nonzero
                           else 1.0),
            "hl_shift": shift, "hl_ci95": ci,
            "later_higher": int(np.sum(d > 0)),
            "earlier_higher": int(np.sum(d < 0)),
            "equal": int(np.sum(d == 0)),
            "median": [float(np.median(x)), float(np.median(y))]}


def table(name: str, lines: dict) -> dict:
    arms = {a: {s: float(v[s]["wer"]) for s in sorted(v)}
            for a, v in sorted(lines.items())}
    unpaired = sorted(a for a in arms if a not in PAIRED_ARMS.values())
    pairs, paired_card = {}, {}
    for a, b in itertools.combinations(unpaired, 2):
        x, y = list(arms[a].values()), list(arms[b].values())
        p = stats.mannwhitneyu(x, y, alternative="two-sided").pvalue
        pairs[f"{a} vs {b}"] = float(p)
        if "from_jax" in a and "from_jax" in b and arms[a].keys() == \
                arms[b].keys():
            seeds = sorted(arms[a])
            paired_card[f"{a} vs {b}"] = float(stats.wilcoxon(
                [arms[a][k] for k in seeds], [arms[b][k] for k in seeds]
            ).pvalue)
    out = {"device": "cpu", "recipe": name,
           "wer": {a: {str(s): w for s, w in v.items()}
                   for a, v in arms.items()},
           "n": {a: len(v) for a, v in arms.items()},
           "median": {a: float(np.median(list(v.values())))
                      for a, v in arms.items()},
           "mean": {a: float(np.mean(list(v.values())))
                    for a, v in arms.items()},
           "mann_whitney_p": pairs, "mann_whitney_p_holm": holm(pairs),
           "paired_wilcoxon_p": paired_card}
    tests = {}
    for later, earlier in PAIRS:
        a = PAIRED_ARMS.get(later, later)
        b = PAIRED_ARMS.get(earlier, earlier)
        if a in lines and b in lines:
            tests[f"{later} - {earlier}"] = {
                m: paired(lines[a], lines[b], k)
                for m, k in METRICS.items()}
    if tests:
        out["paired"] = tests
    return out


def main() -> int:
    print(json.dumps(table("rm", read(os.path.join(
        HERE, "rm_diagnose.jsonl"), rm_line))))
    print(json.dumps(table("wsj_data_dir", read(os.path.join(
        HERE, "write_data_dirs.jsonl"), wsj_line))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
