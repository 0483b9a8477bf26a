"""Bandlimited waveform resampling.

Clean-room equivalent of src/feat/resample.{h,cc} (LinearResample):
windowed-sinc interpolation at the target rate with a Hann-windowed
lowpass at min(nyquist_in, nyquist_out) * cutoff_factor.
"""

from __future__ import annotations

import math

import numpy as np


def resample_waveform(wave: np.ndarray, rate_in: float, rate_out: float,
                      num_zeros: int = 6,
                      cutoff_factor: float = 0.95) -> np.ndarray:
    """[N] -> [round(N * rate_out / rate_in)] float32."""
    wave = np.asarray(wave, np.float64)
    if rate_in == rate_out:
        return wave.astype(np.float32)
    n_in = len(wave)
    n_out = int(round(n_in * rate_out / rate_in))
    cutoff = cutoff_factor * 0.5 * min(rate_in, rate_out)
    window_width = num_zeros / (2.0 * cutoff)      # seconds
    t_out = np.arange(n_out) / rate_out            # output times
    t_in = np.arange(n_in) / rate_in
    out = np.zeros(n_out)
    half = window_width
    dt_in = 1.0 / rate_in
    for i, t in enumerate(t_out):
        lo = max(0, int(math.ceil((t - half) * rate_in)))
        hi = min(n_in - 1, int(math.floor((t + half) * rate_in)))
        if hi < lo:
            continue
        d = t_in[lo:hi + 1] - t
        # Hann-windowed sinc
        sinc = np.sinc(2.0 * cutoff * d) * 2.0 * cutoff * dt_in
        hann = 0.5 * (1.0 + np.cos(math.pi * d / half))
        out[i] = np.dot(wave[lo:hi + 1], sinc * hann)
    return out.astype(np.float32)
