"""Pitch extraction (Kaldi-pitch style: NCCF + Viterbi smoothing).

Host numpy, the twin of ``kaldi_cnn_tpu/features/pitch.py`` (verbatim
but for its imports), apart from ``OnlinePitchExtractor``: it gives the
JAX extractor's results, but where that one re-runs ``raw_pitch`` over
the whole stream on every chunk, this one computes the NCCF of the new
frames only and carries the Viterbi forward pass across chunks.

Clean-room equivalent of src/feat/pitch-functions.{h,cc}
(ComputeKaldiPitch + ProcessPitch, Ghahremani et al. 2014): per-frame
normalized cross-correlation over log-spaced candidate lags, Viterbi
smoothing with a log-lag transition penalty, then the processed
3-column feature stream the recipes append (process-kaldi-pitch-feats
semantics): (pov_feature, normalized_log_pitch, delta_pitch).

Round-5 rewrite: the NCCF is computed for ALL frames and ALL lags at
once — frames via stride tricks, the lag cross-correlations as ONE
batched FFT autocorrelation (irfft(|rfft(seg)|²)), the per-lag energy
normalizers from two cumulative sums — so a minute of audio costs
milliseconds instead of the old O(T·lags·window) Python loops (~2 s
per utterance).  The Viterbi stays an O(T·L²) dynamic program but
vectorized over the lag axis.  Simplifications vs the reference,
stated: no 2 kHz resampling front end (we correlate at the input rate
over the same lag grid), no ballast ramp-in, and the POV mapping uses
the reference's feature nonlinearity but a logistic stand-in for its
piecewise NccfToPov probability (only the normalization weighting
consumes it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.config import configclass


@configclass
class PitchOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1
    num_lags: int = 64
    # short-lag preference: the NCCF of a periodic frame is ~1 at every
    # multiple of the true lag, so the Viterbi local cost subtracts
    # lag_bias * log(lag / min_lag) — the octave-error guard playing
    # the role of the reference's ballast + soft-min-f0 machinery
    # (ref: pitch-functions.cc nccf_ballast / soft_min_f0)
    lag_bias: float = 0.01
    # ProcessPitch (ref: pitch-functions.cc ProcessPitchOptions)
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    delta_window: int = 2
    delta_pitch_scale: float = 10.0
    pov_scale: float = 2.0


def _candidate_lags(opts: PitchOptions, wlen: int) -> np.ndarray:
    lags = np.exp(np.linspace(np.log(opts.samp_freq / opts.max_f0),
                              np.log(opts.samp_freq / opts.min_f0),
                              opts.num_lags))
    lags = np.unique(np.round(lags).astype(int))
    return lags[lags < wlen - 2]


def nccf_frames(wave: np.ndarray, opts: PitchOptions
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched NCCF: [T, L] for the candidate lag grid (and the lags).

    For frame segment s (mean-subtracted, length w) and lag ℓ:
      nccf[ℓ] = Σ_i s_i s_{i+ℓ} / sqrt((Σ_{i<w-ℓ} s_i²)(Σ_{i>=ℓ} s_i²))
    The numerator for every ℓ is the autocorrelation, computed for all
    frames at once via FFT; the denominators come from cumulative sums
    of s² (exact, no approximation vs the direct loop)."""
    sr = opts.samp_freq
    shift = int(sr * opts.frame_shift_ms / 1000.0)
    wlen = int(sr * opts.frame_length_ms / 1000.0)
    wave = np.asarray(wave, np.float64)
    T = max(0, (len(wave) - wlen) // shift + 1)
    lags = _candidate_lags(opts, wlen)
    L = len(lags)
    if T == 0 or L == 0:
        return np.zeros((0, max(L, 1))), lags
    idx = np.arange(wlen)[None, :] + shift * np.arange(T)[:, None]
    seg = wave[idx]
    seg = seg - seg.mean(axis=1, keepdims=True)
    # autocorrelation of every frame in one batched FFT
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    spec = np.fft.rfft(seg, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :wlen]
    # energy normalizers from cumsums of s^2
    sq = seg * seg
    csum = np.concatenate([np.zeros((T, 1)), np.cumsum(sq, axis=1)],
                          axis=1)                       # [T, w+1]
    tot = csum[:, -1:]
    e_a = csum[:, wlen - lags]                          # Σ_{i<w-ℓ}
    e_b = tot - csum[:, lags]                           # Σ_{i>=ℓ}
    denom = np.sqrt((e_a + 1e-10) * (e_b + 1e-10))
    return ac[:, lags] / denom, lags


def raw_pitch(wave: np.ndarray, opts: Optional[PitchOptions] = None
              ) -> np.ndarray:
    """[N] -> [T, 2] columns (nccf_on_path, pitch_hz): the Viterbi-
    smoothed lag track (ComputeKaldiPitch's output pair)."""
    opts = opts or PitchOptions()
    nccf, lags = nccf_frames(wave, opts)
    T, L = nccf.shape
    if T == 0 or len(lags) == 0:
        return np.zeros((0, 2), np.float32)
    loglag = np.log(lags)
    pen = opts.penalty_factor * (loglag[None, :] - loglag[:, None]) ** 2
    bias = opts.lag_bias * (loglag - loglag[0])   # octave-error guard
    cost = -(nccf[0] - bias)
    back = np.zeros((T, L), np.int32)
    for t in range(1, T):
        tot = cost[:, None] + pen
        back[t] = np.argmin(tot, axis=0)
        cost = tot[back[t], np.arange(L)] - (nccf[t] - bias)
    path = np.zeros(T, np.int32)
    path[-1] = int(np.argmin(cost))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    pitch = opts.samp_freq / lags[path]
    pov = nccf[np.arange(T), path]
    return np.stack([pov, pitch], axis=1).astype(np.float32)


def _nccf_to_pov(nccf: np.ndarray) -> np.ndarray:
    """Probability-of-voicing in [0, 1] used to weight the pitch
    normalization window (logistic stand-in for the reference's
    piecewise-polynomial NccfToPov; monotone, 0.5 at nccf≈0.3)."""
    return 1.0 / (1.0 + np.exp(-8.0 * (nccf - 0.3)))


def process_pitch(raw: np.ndarray,
                  opts: Optional[PitchOptions] = None) -> np.ndarray:
    """[T, 2] (nccf, pitch_hz) -> [T, 3] processed feature columns
    (ref: pitch-functions.cc ProcessPitch / process-kaldi-pitch-feats):

      pov_feature          = pov_scale * ((1.0001 - nccf)^0.15 - 1)
                             (the reference's NccfToPovFeature shape)
      normalized_log_pitch = log(pitch) - POV-weighted moving average
                             over +-normalization_context frames
      delta_pitch          = delta_pitch_scale * standard delta of
                             log(pitch) over +-delta_window frames
    """
    opts = opts or PitchOptions()
    T = raw.shape[0]
    if T == 0:
        return np.zeros((0, 3), np.float32)
    nccf = raw[:, 0].astype(np.float64)
    logp = np.log(np.maximum(raw[:, 1].astype(np.float64), 1.0))
    pov_feat = opts.pov_scale * (np.power(1.0001 - nccf, 0.15) - 1.0)
    # POV-weighted moving mean of log pitch
    w = _nccf_to_pov(nccf)
    lc, rc = opts.normalization_left_context, \
        opts.normalization_right_context
    cw = np.concatenate([[0.0], np.cumsum(w)])
    cwp = np.concatenate([[0.0], np.cumsum(w * logp)])
    lo = np.maximum(np.arange(T) - lc, 0)
    hi = np.minimum(np.arange(T) + rc + 1, T)
    wsum = cw[hi] - cw[lo]
    wmean = np.where(wsum > 1e-8, (cwp[hi] - cwp[lo])
                     / np.maximum(wsum, 1e-8), logp)
    norm_log_pitch = logp - wmean
    # standard delta over log pitch (ref: add-deltas window semantics)
    d = opts.delta_window
    offs = np.arange(-d, d + 1)
    denom = float(np.sum(offs * offs))
    pad = np.pad(logp, (d, d), mode="edge")
    delta = np.zeros(T)
    for k, o in enumerate(offs):
        delta += o * pad[k:k + T]
    delta = opts.delta_pitch_scale * delta / denom
    return np.stack([pov_feat, norm_log_pitch, delta],
                    axis=1).astype(np.float32)


def compute_pitch(wave: np.ndarray,
                  opts: Optional[PitchOptions] = None) -> np.ndarray:
    """[N] -> [T, 2] columns (pov=nccf_on_path, pitch_hz) — the
    backward-compatible raw pair (ComputeKaldiPitch)."""
    return raw_pitch(wave, opts)


def compute_and_process_pitch(wave: np.ndarray,
                              opts: Optional[PitchOptions] = None
                              ) -> np.ndarray:
    """[N] -> [T, 3]: the pipeline the recipes append
    (compute-kaldi-pitch-feats | process-kaldi-pitch-feats)."""
    opts = opts or PitchOptions()
    return process_pitch(raw_pitch(wave, opts), opts)


class OnlinePitchExtractor:
    """Chunked pitch (ref: online-feature.cc OnlinePitchFeature):
    samples stream in via accept_waveform(); frames commit once they
    fall ``recompute_window`` frames behind the input edge, and whenever
    the commit point moves the whole committed prefix is re-set from the
    newest Viterbi track (the JAX package's semantics, output for
    output).

    The work is incremental where the JAX extractor re-runs
    ``raw_pitch`` over the whole stream on every chunk: the NCCF of a
    frame depends on its own samples only, so each call computes it for
    the frames the new samples complete (``nccf_frames`` over the
    samples from the first new frame on), and the Viterbi forward pass
    is causal, so its cost vector and backpointers carry across calls.
    Only the backtrace runs from the end, when the commit point moves
    and at ``input_finished``."""

    def __init__(self, opts: Optional[PitchOptions] = None,
                 recompute_window: int = 80):
        self.opts = opts or PitchOptions()
        self.recompute_window = int(recompute_window)
        o = self.opts
        self._shift = int(o.samp_freq * o.frame_shift_ms / 1000.0)
        wlen = int(o.samp_freq * o.frame_length_ms / 1000.0)
        self._lags = _candidate_lags(o, wlen)
        loglag = np.log(self._lags)
        self._pen = o.penalty_factor * (loglag[None, :]
                                        - loglag[:, None]) ** 2
        self._bias = o.lag_bias * (loglag - loglag[0])
        self._tail = np.zeros(0, np.float64)   # from the next frame's start
        self._nccf: List[np.ndarray] = []      # [n, L] a call
        self._back: List[np.ndarray] = []      # [n, L] a call
        self._cost: Optional[np.ndarray] = None
        self._committed = np.zeros((0, 2), np.float32)

    @property
    def num_frames(self) -> int:
        """Frames whose NCCF has been computed."""
        return sum(len(x) for x in self._nccf)

    def _advance(self, samples: np.ndarray) -> None:
        """NCCF of the frames the new samples complete, then the forward
        pass over them (raw_pitch's recursion, step for step)."""
        self._tail = np.concatenate(
            [self._tail, np.asarray(samples, np.float64)])
        if not len(self._lags):
            return
        nccf, _ = nccf_frames(self._tail, self.opts)
        if not len(nccf):
            return
        self._tail = self._tail[len(nccf) * self._shift:]
        L = len(self._lags)
        back = np.zeros(nccf.shape, np.int32)
        cost = self._cost
        for t in range(len(nccf)):
            if cost is None:
                cost = -(nccf[0] - self._bias)
                continue
            tot = cost[:, None] + self._pen
            back[t] = np.argmin(tot, axis=0)
            cost = tot[back[t], np.arange(L)] - (nccf[t] - self._bias)
        self._cost = cost
        self._nccf.append(nccf)
        self._back.append(back)

    def _raw(self) -> np.ndarray:
        """raw_pitch of the samples so far: the backtrace from the end."""
        T = self.num_frames
        if T == 0:
            return np.zeros((0, 2), np.float32)
        nccf = np.concatenate(self._nccf)
        back = np.concatenate(self._back)
        path = np.zeros(T, np.int32)
        path[-1] = int(np.argmin(self._cost))
        for t in range(T - 1, 0, -1):
            path[t - 1] = back[t, path[t]]
        pitch = self.opts.samp_freq / self._lags[path]
        pov = nccf[np.arange(T), path]
        return np.stack([pov, pitch], axis=1).astype(np.float32)

    def accept_waveform(self, samples: np.ndarray) -> None:
        self._advance(samples)
        commit_to = max(self.num_frames - self.recompute_window, 0)
        if commit_to > len(self._committed):
            self._committed = self._raw()[:commit_to]

    def input_finished(self) -> np.ndarray:
        """Returns the FULL [T, 2] raw track: the committed prefix (as it
        was set when the commit point last moved; it can deviate from
        the offline Viterbi path where a late observation would have
        re-routed the track through committed frames), then the trailing
        window freshly smoothed."""
        raw = self._raw()
        if len(self._committed):
            raw = np.concatenate(
                [self._committed, raw[len(self._committed):]])
        return raw

    @property
    def num_frames_ready(self) -> int:
        return len(self._committed)


def add_pitch_features(feats: np.ndarray,
                       pitch_feats: np.ndarray) -> np.ndarray:
    """Append (pov, normalized log pitch) columns
    (ref: paste-feats in the pitch recipes)."""
    T = min(len(feats), len(pitch_feats))
    logp = np.log(np.maximum(pitch_feats[:T, 1], 1.0))
    logp = logp - logp.mean()
    return np.concatenate(
        [feats[:T], pitch_feats[:T, :1], logp[:, None]], axis=1
    ).astype(np.float32)
