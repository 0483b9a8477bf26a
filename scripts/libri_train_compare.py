#!/usr/bin/env python3
"""Time the Librispeech recipe's training stage in several checkouts on
one GPU.

    python3 scripts/libri_train_compare.py --exp-dir D ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example one unpacked with
``git archive <commit> | tar -x -C ROOT``).  For each ROOT in the order
given, a fresh process imports ``kaldi_cnn_tpu_torch`` from that ROOT
and runs ``recipes.librispeech.run`` at its defaults (200 utterances,
seed 53, 25 epochs, one rank over NCCL) with its stage artifacts and egs
store under D: the first run computes the GMM bootstrap and the egs
store, the later ones load them (``stage=2``), so each run after the
first costs the fbank volumes, the training and the two decodes.  Give
the ROOTs as A B B A to see the drift between runs.  Prints the GPU's
name and power limit, then one JSON line a run: the root, the stage
seconds (``nnet_train`` among them), the training audio-s/s and the
test WER.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = """
import json, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from kaldi_cnn_tpu_torch.recipes import librispeech
res = librispeech.run(exp_dir={exp!r}, egs_dir={egs!r}, stage={stage})
print("RESULT " + json.dumps({{"seconds": res["seconds"],
    "train_audio_ss": res["train_audio_ss"], "wer": res["wer"],
    "dev_wer": res["dev_wer"]}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-dir", required=True)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    exp = os.path.abspath(args.exp_dir)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for i, root in enumerate(args.roots):
        root = os.path.abspath(root)
        code = RUN.format(exp=exp, egs=os.path.join(exp, "egs"),
                          stage=0 if i == 0 else 2)
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             env={**os.environ, "PYTHONPATH": root},
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = next(x for x in out.stdout.splitlines()
                    if x.startswith("RESULT "))
        print(json.dumps({"root": args.roots[i], "stage": 0 if i == 0
                          else 2, **json.loads(line[len("RESULT "):])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
