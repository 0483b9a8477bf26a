#!/usr/bin/env python3
"""Time the port's bench train step in several checkouts on one GPU.

    python3 scripts/train_step_bench.py [--rows N] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example one unpacked with
``git archive <commit> | tar -x -C ROOT``).  For each ROOT in the order
given, a fresh process imports ``kaldi_cnn_tpu_torch`` from that ROOT,
builds its CUDA kernels, and times ``Nnet.train_step`` at
``ConvnetConfig()`` with minibatch ``--rows`` (4096 by default; at 256
the eager step is host-bound) on random inputs from a seed:
the ms a step while the natural-gradient states update every step (the
warm-up) and in the steady state that updates them every 16th step, by
CUDA events, ``REPEATS`` times.  Give a ROOT twice (A B B A) to see the
drift between calls.  Prints the GPU's name and power limit, one JSON
line a ROOT and a summary of the steady medians.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROWS = 4096
SEED = 37
REPEATS = 5


def bench_here(rows: int = ROWS) -> dict:
    """The bench in this process at minibatch ``rows``, with
    ``kaldi_cnn_tpu_torch`` imported from the first entry of sys.path."""
    import numpy as np
    import torch
    from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
    from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ConvnetConfig()
    net = make_convnet(cfg, fused=True, device=dev)
    net.init(torch_generator(SEED, "bench_train"))
    rng = np_rng(SEED, "bench_train")
    x = torch.as_tensor(rng.normal(size=(rows, cfg.input_dim))
                        .astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, cfg.num_pdfs, rows), device=dev)
    opt = net.init_opt()

    def steps(k):
        nonlocal opt
        for _ in range(k):
            opt, _ = net.train_step(opt, x, y, 0.001)

    def ms(k, iters):
        steps(1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            steps(k)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * k)

    steps(2)
    warm = ms(1, 8)
    steps(64 - opt[0]["ng_in"].t)     # past the NG warm-up
    steady = [ms(16, 2) for _ in range(REPEATS)]
    return {"warm_ms": warm, "steady_ms": steady,
            "steady_median_ms": statistics.median(steady)}


def main(argv) -> int:
    rows = ROWS
    if len(argv) >= 2 and argv[0] == "--rows":
        rows, argv = int(argv[1]), argv[2:]
    if len(argv) >= 2 and argv[0] == "--one":
        root = os.path.abspath(argv[1])
        sys.path.insert(0, root)
        out = bench_here(rows)
        out["root"], out["rows"] = argv[1], rows
        print(json.dumps(out), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}", flush=True)
    medians = {}
    for root in argv:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--rows", str(rows),
             "--one", os.path.abspath(root)],
            cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=os.path.abspath(root)))
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        medians.setdefault(root, []).append(
            json.loads(line)["steady_median_ms"])
    print("summary (steady ms a step, median of each call, in order): "
          + json.dumps(medians))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
