"""PLP feature extraction (twin of ``kaldi_cnn_tpu/features/plp.py``).

Clean-room equivalent of src/feat/feature-plp.{h,cc} (Plp::Compute):
mel filterbank energies -> equal-loudness weighting -> intensity-to-
loudness compression (cube root) -> inverse DFT to autocorrelation ->
Levinson-Durbin LPC -> LPC-to-cepstrum, with the reference's option
names (lpc_order, num_ceps, compress_factor, cepstral_lifter,
cepstral_scale).

Framing and the power spectrum run on the wave's device (the card unless
``device="cpu"``); the rest is host numpy, as in the JAX package.
Dither noise comes from an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.features.functional import (
    EPSILON, FbankOptions, FrameExtractionOptions, MelBanksOptions,
    frame_signal, lifter_coeffs, mel_banks, power_spectrum,
    inverse_mel_scale, mel_scale)


@configclass
class PlpOptions:
    frame_opts: FrameExtractionOptions = None  # type: ignore
    mel_opts: MelBanksOptions = None  # type: ignore
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0

    def __post_init__(self):
        if self.frame_opts is None:
            self.frame_opts = FrameExtractionOptions()
        if self.mel_opts is None:
            self.mel_opts = MelBanksOptions()


@lru_cache(maxsize=8)
def _equal_loudness(num_bins: int, low_freq: float, high_freq: float,
                    samp_freq: float, padded: int) -> np.ndarray:
    """Per-mel-bin equal-loudness curve (ref: feature-plp.cc,
    InitIdftBases-era code: f^4 / (f^2 + 1.6e5)^2 * (f^2+1.44e6)/(f^2+9.61e6))."""
    # center frequencies of the mel bins
    high = high_freq if high_freq > 0 else samp_freq / 2 + high_freq
    mel_lo, mel_hi = mel_scale(low_freq), mel_scale(high)
    delta = (mel_hi - mel_lo) / (num_bins + 1)
    centers = np.array([inverse_mel_scale(mel_lo + (i + 1) * delta)
                        for i in range(num_bins)])
    fsq = centers ** 2
    return ((fsq / (fsq + 1.6e5)) ** 2 * (fsq + 1.44e6) / (fsq + 9.61e6))


@lru_cache(maxsize=8)
def _idft_bases(num_bins: int, lpc_order: int) -> np.ndarray:
    """IDFT matrix mapping symmetrized mel spectrum -> autocorrelation
    (ref: matrix-functions.cc ComputeDctMatrix counterpart InitIdftBases)."""
    n = num_bins + 2   # with duplicated endpoints
    out = np.zeros((lpc_order + 1, n))
    for i in range(lpc_order + 1):
        out[i, 0] = 1.0 / n
        out[i, n - 1] = math.cos(math.pi * i) / n
        for j in range(1, n - 1):
            out[i, j] = 2.0 / n * math.cos(2.0 * math.pi * i * j
                                           / (2 * n - 2))
    return out


def _levinson(r: np.ndarray, order: int) -> Tuple[np.ndarray, float]:
    """Levinson-Durbin (ref: matrix-functions.cc ComputeLpc/Durbin).
    r: [order+1] autocorrelation.  Returns (lpc coeffs a[1..p], gain)."""
    a = np.zeros(order)
    e = r[0]
    for i in range(order):
        acc = r[i + 1] - np.dot(a[:i], r[i:0:-1][:i])
        k = acc / max(e, 1e-10)
        new_a = a.copy()
        new_a[i] = k
        new_a[:i] = a[:i] - k * a[i - 1::-1][:i]
        a = new_a
        e *= (1.0 - k * k)
    return a, max(e, 1e-10)


def _lpc_to_cepstrum(a: np.ndarray, gain: float,
                     num_ceps: int) -> np.ndarray:
    """(ref: matrix-functions.cc Lpc2Cepstrum)."""
    p = len(a)
    c = np.zeros(num_ceps)
    c[0] = -math.log(max(1.0 / max(gain, 1e-10), 1e-10))
    for n in range(1, num_ceps):
        s = a[n - 1] if n <= p else 0.0
        for k in range(1, n):
            if n - k <= p:
                s += a[n - k - 1] * c[k] * k / n
        c[n] = s
    return c


@torch.no_grad()
def compute_plp(wave, opts: Optional[PlpOptions] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> np.ndarray:
    """wave [N] -> PLP features [T, num_ceps]; framing and the power
    spectrum on ``device``."""
    opts = opts or PlpOptions()
    wave = torch.as_tensor(wave, dtype=torch.float32,
                           device=device).reshape(-1)
    windowed, log_energy = frame_signal(wave, opts.frame_opts, generator)
    power = power_spectrum(windowed).cpu().numpy()
    mel = mel_banks(opts.mel_opts, opts.frame_opts)
    mel_en = power @ mel.T                       # [T, B]
    eq = _equal_loudness(
        opts.mel_opts.num_bins, opts.mel_opts.low_freq,
        opts.mel_opts.high_freq, opts.frame_opts.samp_freq,
        opts.frame_opts.padded_window_size)
    comp = np.power(np.maximum(mel_en * eq, EPSILON),
                    opts.compress_factor)         # [T, B]
    # duplicate first/last bins (ref: feature-plp.cc)
    sym = np.concatenate([comp[:, :1], comp, comp[:, -1:]], axis=1)
    idft = _idft_bases(opts.mel_opts.num_bins, opts.lpc_order)
    autocorr = sym @ idft.T                       # [T, p+1]
    T = autocorr.shape[0]
    feats = np.zeros((T, opts.num_ceps), np.float32)
    for t in range(T):
        a, gain = _levinson(autocorr[t], opts.lpc_order)
        c = _lpc_to_cepstrum(a, gain, opts.num_ceps)
        feats[t] = opts.cepstral_scale * c
    if opts.cepstral_lifter != 0.0:
        feats *= lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)
    if opts.use_energy:
        en = log_energy.cpu().numpy()
        if opts.energy_floor > 0:
            en = np.maximum(en, math.log(opts.energy_floor))
        feats[:, 0] = en
    return feats
