#!/usr/bin/env python3
"""The front end's error against an exact (float64) reference, on the
card's kernels, the plain version on the card and on the CPU.

    python3 scripts/frontend_error.py                  # the card
    python3 scripts/frontend_error.py --device cpu     # the CPU paths only

Takes the RM recipe's training corpus of ``--seed`` (29: its 96
training waves) and the recipe's own dither draws (the generator of
stage ("mfcc_dither", i), as ``FeatureExtractor.extract_corpus`` draws
them), and computes on the same dithered frames:

- ``mfcc_fft``: the RM recipe's MFCC (8 kHz, 23 bins, 13 cepstra,
  N = 256): the kernel is ``kcnn_fbank_fft``;
- ``mfcc_table``: the same through the table kernel ``kcnn_fbank``
  (``fbank_frames_table``), and ``mfcc_table_n200`` with
  ``round_to_power_of_two`` off (N = 200, where ``fbank_frames`` itself
  takes the table kernel);
- ``fbank36_fft``: the 36-bin log-mel of the WSJ recipe's volumes on the
  same frames (``kcnn_fbank_fft``).

Each path (``kernel`` and ``plain_cuda`` on the card, ``plain_cpu``) is
held against a numpy float64 reference of the same frames (DC removal,
raw log energy, pre-emphasis, Povey window, ``numpy.fft.rfft``, the mel
banks, the log, the DCT and the lifter, all in float64).  One JSON line
a (variant, path): max and mean absolute and mean signed error, per
coefficient, and by decile of the frames' log energy (the quietest
frames first); then one ``verdict`` line a variant: the kernel's mean
absolute error in each decile over the f32 plain version's on the card,
and each path's bias in standard errors (``bias_z``).  A kernel fault
is a ratio of 10 or more in some decile, or a bias the plain version
does not have.  On the card the GPU's name and power limit come first,
and again as each line's first key (``gpu``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from kaldi_cnn_tpu_torch.core.rng import torch_generator  # noqa: E402
from kaldi_cnn_tpu_torch.features import functional as F  # noqa: E402
from kaldi_cnn_tpu_torch.ops import fbank as K  # noqa: E402


def options(variant: str, sample_rate: int):
    """(fbank options, MFCC options or None) of a variant."""
    if variant.startswith("mfcc"):
        mo = F.MfccOptions()
        mo.frame_opts.samp_freq = float(sample_rate)
        mo.frame_opts.dither = 1.0
        if variant.endswith("n200"):
            mo.frame_opts.round_to_power_of_two = False
        return F.mfcc_fbank_options(mo), mo
    fb = F.FbankOptions()
    fb.frame_opts.samp_freq = float(sample_rate)
    fb.frame_opts.dither = 1.0
    fb.mel_opts.num_bins = 36
    return fb, None


def reference64(frames: np.ndarray, fb, mo) -> np.ndarray:
    """The float64 reference of the same frames."""
    fo = fb.frame_opts
    x = frames.astype(np.float64)
    if fo.remove_dc_offset:
        x = x - x.mean(axis=1, keepdims=True)
    energy = np.log(np.maximum((x * x).sum(axis=1), F.EPSILON))
    if fo.preemph_coeff != 0.0:
        prev = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        x = x - fo.preemph_coeff * prev
    n = fo.window_size
    i = np.arange(n, dtype=np.float64)
    x = x * (0.5 - 0.5 * np.cos(2.0 * math.pi / (n - 1) * i)) ** 0.85
    spec = np.fft.rfft(x, n=fo.padded_window_size, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    log_mel = np.log(np.maximum(power @ mel64(fb).T, F.EPSILON))
    if mo is None:
        return log_mel
    m = dct64(mo.num_ceps, mo.mel_opts.num_bins).T
    q = float(mo.cepstral_lifter)
    m = m * (1.0 + 0.5 * q * np.sin(math.pi * np.arange(mo.num_ceps) / q))
    ceps = log_mel @ m
    ceps[:, 0] = energy
    return ceps


def mel64(fb) -> np.ndarray:
    """``F.mel_banks`` in float64."""
    fo, mo = fb.frame_opts, fb.mel_opts
    nyq = 0.5 * fo.samp_freq
    high = mo.high_freq if mo.high_freq > 0 else nyq + mo.high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f) / 700.0)
    lo, hi = mel(mo.low_freq), mel(high)
    delta = (hi - lo) / (mo.num_bins + 1)
    centers = lo + delta * np.arange(mo.num_bins + 2)
    nb = fo.padded_window_size // 2 + 1
    mels = mel(fo.samp_freq / fo.padded_window_size * np.arange(nb))[None]
    up = (mels - centers[:-2, None]) / (centers[1:-1, None]
                                         - centers[:-2, None])
    down = (centers[2:, None] - mels) / (centers[2:, None]
                                         - centers[1:-1, None])
    return np.maximum(0.0, np.minimum(up, down))


def dct64(rows: int, cols: int) -> np.ndarray:
    m = np.zeros((rows, cols))
    m[0] = math.sqrt(1.0 / cols)
    for k in range(1, rows):
        m[k] = math.sqrt(2.0 / cols) * np.cos(
            math.pi / cols * (np.arange(cols) + 0.5) * k)
    return m


def run_path(path: str, variant: str, frames: torch.Tensor, fb, mo
             ) -> np.ndarray:
    dev = "cuda" if path in ("kernel", "plain_cuda") else "cpu"
    x = frames.to(dev)
    if path == "kernel":
        fn = (K.fbank_frames_table if variant == "mfcc_table"
              else K.fbank_frames)
    else:
        fn = K.fbank_reference_frames
    log_mel, energy = fn(x, fb)
    out = log_mel if mo is None else F.cepstra(log_mel, energy, mo)
    return out.double().cpu().numpy()


def stats_of(err: np.ndarray) -> dict:
    a = np.abs(err)
    return {"max_abs": float(a.max()), "mean_abs": float(a.mean()),
            "mean_signed": float(err.mean()),
            "bias_z": float(err.mean() / max(err.std(), 1e-300)
                            * math.sqrt(err.size))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--num-utts", type=int, default=140)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", nargs="+",
                    default=["mfcc_fft", "mfcc_table", "mfcc_table_n200",
                             "fbank36_fft"])
    a = ap.parse_args(argv)
    from kaldi_cnn_tpu_torch.recipes import rm
    card = a.device.startswith("cuda")
    gpu = None
    if card:
        from deletions import gpu_name
        gpu = gpu_name()
        print("gpu:", gpu, flush=True)
    head = {"gpu": gpu} if gpu else {"device": "cpu"}
    train, _, _ = rm.make_corpus(a.num_utts, a.seed, 0)
    paths = (["kernel", "plain_cuda"] if card else []) + ["plain_cpu"]
    for variant in a.variants:
        fb, mo = options(variant, train.sample_rate)
        outs = {p: [] for p in paths}
        refs, energies = [], []
        for i, (utt, wave) in enumerate(sorted(train.waves.items())):
            w = torch.as_tensor(np.asarray(wave, np.float32).reshape(-1))
            frames = F.add_dither(
                F.extract_frames(w, fb.frame_opts), fb.frame_opts,
                torch_generator(a.seed, "mfcc_dither", i)).contiguous()
            ref = reference64(frames.numpy(), fb, mo)
            x = frames.double().numpy()
            x = x - x.mean(axis=1, keepdims=True)
            energies.append(np.log(np.maximum((x * x).sum(axis=1),
                                              F.EPSILON)))
            refs.append(ref)
            for p in paths:
                outs[p].append(run_path(p, variant, frames, fb, mo))
        ref = np.concatenate(refs)
        energy = np.concatenate(energies)
        edges = np.quantile(energy, np.linspace(0, 1, 11))
        dec = np.clip(np.searchsorted(edges, energy, side="right") - 1, 0, 9)
        per_decile = {}
        for p in paths:
            err = np.concatenate(outs[p]) - ref
            line = {**head, "variant": variant, "path": p,
                    "frames": int(ref.shape[0]), "dims": int(ref.shape[1]),
                    **stats_of(err),
                    "per_coef": {k: [round(float(v), 9) for v in vals]
                                 for k, vals in (
                                     ("max_abs", np.abs(err).max(0)),
                                     ("mean_abs", np.abs(err).mean(0)),
                                     ("mean_signed", err.mean(0)))},
                    "deciles": [{"log_energy": [float(edges[d]),
                                                float(edges[d + 1])],
                                 **stats_of(err[dec == d])}
                                for d in range(10)]}
            per_decile[p] = [d["mean_abs"] for d in line["deciles"]]
            print(json.dumps(line), flush=True)
        verdict = {**head, "verdict": variant,
                   "bias_z": {p: stats_of(np.concatenate(outs[p]) - ref)[
                       "bias_z"] for p in paths}}
        if card:
            ratio = [k / max(q, 1e-30) for k, q in
                     zip(per_decile["kernel"], per_decile["plain_cuda"])]
            verdict["kernel_over_plain_by_decile"] = ratio
            verdict["kernel_fault"] = bool(max(ratio) >= 10.0)
        print(json.dumps(verdict), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
