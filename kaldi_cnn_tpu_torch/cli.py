"""The command-line multitool (twin of ``kaldi_cnn_tpu/cli.py``): the
reference's thin binaries as verbs of one entry point.

    python -m kaldi_cnn_tpu_torch.cli <verb> [--flag=value ...] args...

Ported verbs:

  online2-wav-latgen          online2bin/online2-wav-nnet2-latgen-faster.cc
  compute-kaldi-pitch-feats   featbin/compute-kaldi-pitch-feats.cc
  process-kaldi-pitch-feats   featbin/process-kaldi-pitch-feats.cc
  run-recipe                  egs/<corpus>/run.sh equivalents

Every verb self-documents with --help (ref: ParseOptions usage
strings).  The JAX package's other verbs are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from kaldi_cnn_tpu_torch.cli_train import TRAIN_VERBS


def cmd_compute_pitch(argv: List[str]) -> int:
    """(ref: featbin/compute-kaldi-pitch-feats.cc — NCCF + Viterbi
    lag track, two columns (nccf, pitch_hz) per frame.)  Each file's
    pitch runs at that file's sample rate; the JAX verb's
    --sample-frequency, which every file's rate overwrote, is dropped."""
    from kaldi_cnn_tpu_torch.features.pitch import PitchOptions, raw_pitch
    from kaldi_cnn_tpu_torch.io.kaldi_io import ArkWriter
    from kaldi_cnn_tpu_torch.io.wave import read_wave
    p = argparse.ArgumentParser(prog="compute-kaldi-pitch-feats")
    p.add_argument("--frame-length", type=float, default=25.0)
    p.add_argument("--frame-shift", type=float, default=10.0)
    p.add_argument("--min-f0", type=float, default=50.0)
    p.add_argument("--max-f0", type=float, default=400.0)
    p.add_argument("--penalty-factor", type=float, default=0.1)
    p.add_argument("wav_scp")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    args = p.parse_args(argv)
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for line in open(args.wav_scp):
            utt, path = line.split(None, 1)
            wave, rate = read_wave(path.strip())
            if wave.ndim == 2:
                wave = wave[0]
            opts = PitchOptions(
                samp_freq=rate, frame_length_ms=args.frame_length,
                frame_shift_ms=args.frame_shift, min_f0=args.min_f0,
                max_f0=args.max_f0, penalty_factor=args.penalty_factor)
            w.write(utt, raw_pitch(wave, opts))
            n += 1
    print(f"computed pitch for {n} utterances", file=sys.stderr)
    return 0


def cmd_process_pitch(argv: List[str]) -> int:
    """(ref: featbin/process-kaldi-pitch-feats.cc — raw (nccf, pitch)
    -> 3-column (pov_feature, normalized_log_pitch, delta_pitch).)"""
    from kaldi_cnn_tpu_torch.features.pitch import PitchOptions, process_pitch
    from kaldi_cnn_tpu_torch.io.kaldi_io import ArkWriter, read_mat_ark
    p = argparse.ArgumentParser(prog="process-kaldi-pitch-feats")
    p.add_argument("--normalization-left-context", type=int, default=75)
    p.add_argument("--normalization-right-context", type=int, default=75)
    p.add_argument("--delta-pitch-scale", type=float, default=10.0)
    p.add_argument("in_ark")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    args = p.parse_args(argv)
    opts = PitchOptions(
        normalization_left_context=args.normalization_left_context,
        normalization_right_context=args.normalization_right_context,
        delta_pitch_scale=args.delta_pitch_scale)
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for utt, mat in read_mat_ark(args.in_ark):
            w.write(utt, process_pitch(mat, opts))
            n += 1
    print(f"processed pitch for {n} utterances", file=sys.stderr)
    return 0


def cmd_run_recipe(argv: List[str]) -> int:
    """(ref: egs/<corpus>/run.sh) One recipe's ``run`` on --device (the
    card unless told otherwise); prints its result.  The JAX verb's
    --pallas is dropped: the port takes its kernels wherever the tensors
    lie on the card.  librispeech runs as a process group of one (see
    ``recipes/librispeech.py`` for several)."""
    p = argparse.ArgumentParser(prog="run-recipe")
    p.add_argument("recipe", choices=["yesno", "rm", "wsj", "swbd",
                                      "librispeech"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import importlib
    mod = importlib.import_module(
        f"kaldi_cnn_tpu_torch.recipes.{args.recipe}")
    res = mod.run(device=args.device)
    print(res)
    return 0


VERBS = dict(TRAIN_VERBS)
VERBS.update({"compute-kaldi-pitch-feats": cmd_compute_pitch,
              "process-kaldi-pitch-feats": cmd_process_pitch,
              "run-recipe": cmd_run_recipe})


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
