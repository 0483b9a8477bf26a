#!/usr/bin/env python3
"""The paired seed run of ROADMAP 3.14: the RM recipe's arms on the CPU,
several processes at a time, each pinned to cores of its own.

    python3 scripts/delta_arms.py D A:29:64 B:29:64 C:29:40
    python3 scripts/seed_stats.py > scripts/seed_stats.jsonl

Each ``ARM:FIRST:LAST`` runs ``scripts/rm_diagnose.py`` at its RM
defaults (140 utterances, no eval corpus, 25 epochs) for every seed in
the range, from ``D/<ARM>/seed<N>``:

- A: the port on the CPU from the JAX package's feature stage
  (``scripts/jax_stage_features.py``, ``--stage 1``);
- B: the same from the JAX package's static MFCC with the port's deltas
  (``jax_stage_features.py --port-deltas``);
- C: the JAX package on the CPU from a directory that holds only the
  ``--port-deltas`` feature stage.

Feature stages that are missing are written first (by the JAX package
on the CPU).  The arms' jobs go out seed by seed, interleaved, four at a
time, each under ``taskset`` on two cores of its own with two threads
(``OMP_NUM_THREADS``); a run that fails is run again, up to three
times.  Each run's line is appended to
``scripts/rm_diagnose.jsonl`` with the arm in its ``note`` ("arm A:
..."), which ``scripts/seed_stats.py`` reads; its log goes to
``D/<ARM>_<N>.log``.
"""

from __future__ import annotations

import argparse
import os
import queue
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEDGER = os.path.join(ROOT, "scripts", "rm_diagnose.jsonl")
JOBS, CORES = 4, 2
NOTES = {
    "A": "arm A: --exp-dir of scripts/jax_stage_features.py: the JAX "
         "package features, the port on the CPU, --stage 1, two cores a "
         "process",
    "B": "arm B: --exp-dir of scripts/jax_stage_features.py "
         "--port-deltas: the JAX package static MFCC, the port deltas, "
         "the port on the CPU, --stage 1, two cores a process",
    "C": "arm C: the JAX package on the CPU from an --exp-dir holding "
         "only the feature stage of scripts/jax_stage_features.py "
         "--port-deltas, --stage 1, two cores a process",
}


def command(arm: str, seed: int, exp_dir: str) -> list:
    cmd = [sys.executable, "scripts/rm_diagnose.py", "--seeds", str(seed),
           "--exp-dir", os.path.join(exp_dir, arm), "--note", NOTES[arm],
           "--stage", "1"]
    if arm == "C":
        return cmd + ["--package", "kaldi_cnn_tpu"]
    return cmd + ["--device", "cpu"]


def write_features(exp_dir: str, arm: str, seeds: list, env: dict):
    missing = [s for s in seeds if not os.path.exists(os.path.join(
        exp_dir, arm, f"seed{s}", "stage00_features.pkl"))]
    if not missing:
        return
    subprocess.check_call(
        [sys.executable, "scripts/jax_stage_features.py",
         os.path.join(exp_dir, arm), "--seeds", *map(str, missing)]
        + (["--port-deltas"] if arm in "BC" else []), cwd=ROOT, env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_dir")
    ap.add_argument("arms", nargs="+", help="ARM:FIRST:LAST, ARM in ABC")
    a = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               **{k: str(CORES) for k in ("OMP_NUM_THREADS",
                                          "MKL_NUM_THREADS",
                                          "OPENBLAS_NUM_THREADS")})
    ranges = []
    for spec in a.arms:
        arm, first, last = spec.split(":")
        if arm not in NOTES:
            ap.error(f"no arm {arm}")
        seeds = list(range(int(first), int(last) + 1))
        write_features(a.exp_dir, arm, seeds, env)
        ranges.append([(arm, s) for s in seeds])
    jobs = queue.Queue()
    for i in range(max(map(len, ranges))):
        for r in ranges:
            if i < len(r):
                jobs.put(r[i])
    lock = threading.Lock()
    failed = []

    def worker(slot: int):
        cores = ",".join(str(slot * CORES + k) for k in range(CORES))
        while True:
            try:
                arm, seed = jobs.get_nowait()
            except queue.Empty:
                return
            log = os.path.join(a.exp_dir, f"{arm}_{seed}.log")
            for attempt in range(3):
                t = time.perf_counter()
                with open(log, "a") as err:
                    run = subprocess.run(
                        ["taskset", "-c", cores]
                        + command(arm, seed, a.exp_dir), cwd=ROOT, env=env,
                        stdout=subprocess.PIPE, stderr=err, text=True)
                print(f"arm {arm} seed {seed}: rc {run.returncode}, "
                      f"{time.perf_counter() - t:.0f} s", flush=True)
                if run.returncode == 0:
                    with lock, open(LEDGER, "a") as f:
                        f.write(run.stdout)
                    break
            else:
                failed.append((arm, seed))

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(JOBS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        print("failed three times:", failed, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
