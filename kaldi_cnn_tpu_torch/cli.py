"""The command-line multitool (twin of ``kaldi_cnn_tpu/cli.py``): the
reference's thin binaries as verbs of one entry point.

    python -m kaldi_cnn_tpu_torch.cli <verb> [--flag=value ...] args...

Ported verbs:

  online2-wav-latgen   online2bin/online2-wav-nnet2-latgen-faster.cc

Every verb self-documents with --help (ref: ParseOptions usage
strings).  The JAX package's other verbs are not ported yet.
"""

from __future__ import annotations

import sys
from typing import List

from kaldi_cnn_tpu_torch.cli_train import TRAIN_VERBS

VERBS = dict(TRAIN_VERBS)


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("verbs:", ", ".join(sorted(VERBS)))
        return 0
    verb, rest = argv[0], argv[1:]
    if verb not in VERBS:
        print(f"unknown verb {verb!r}; verbs: {', '.join(sorted(VERBS))}",
              file=sys.stderr)
        return 2
    return VERBS[verb](rest)


if __name__ == "__main__":
    sys.exit(main())
