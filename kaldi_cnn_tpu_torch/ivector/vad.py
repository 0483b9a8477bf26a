"""Energy-based voice activity detection.

Clean-room equivalent of src/ivector/voice-activity-detection.{h,cc}
(ComputeVadEnergy): a frame is speech if its log-energy (feature dim 0
of MFCC with energy, or computed directly) exceeds a threshold derived
from the utterance mean, with a context-proportion smoothing vote.
"""

from __future__ import annotations

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass


@configclass
class VadOptions:
    vad_energy_threshold: float = 5.5
    vad_energy_mean_scale: float = 0.5
    vad_frames_context: int = 0
    vad_proportion_threshold: float = 0.6


def compute_vad(log_energy: np.ndarray,
                opts: VadOptions = None) -> np.ndarray:
    """[T] log energies -> [T] float 0/1 speech decisions."""
    opts = opts or VadOptions()
    e = np.asarray(log_energy, np.float64)
    thresh = opts.vad_energy_threshold
    if opts.vad_energy_mean_scale > 0:
        thresh += opts.vad_energy_mean_scale * e.mean()
    raw = e > thresh
    ctx = opts.vad_frames_context
    if ctx == 0:
        return raw.astype(np.float32)
    T = len(e)
    out = np.zeros(T, np.float32)
    for t in range(T):
        lo, hi = max(0, t - ctx), min(T, t + ctx + 1)
        if raw[lo:hi].mean() >= opts.vad_proportion_threshold:
            out[t] = 1.0
    return out


def log_energy(wave_frames: np.ndarray) -> np.ndarray:
    """[T, win] framed signal -> [T] log energies
    (ref: feature-window.cc log_energy_pre_window)."""
    en = np.maximum((wave_frames.astype(np.float64) ** 2).sum(axis=1),
                    1e-10)
    return np.log(en)
