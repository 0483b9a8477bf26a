"""Kaldi-semantics feature extraction in PyTorch: fbank, MFCC and deltas.

Twin of ``kaldi_cnn_tpu/features/functional.py``: options, framing,
windows, the mel, DFT and DCT tables and the lifter (numpy, identical to
the JAX package's), the rfft-based ``compute_fbank`` and
``compute_mfcc`` references, the CMVN family (on the input's device;
``cmvn_stats`` host numpy in float64) and ``compute_deltas``.  The
fused kernel path is ``kaldi_cnn_tpu_torch.ops.fbank``.

Dither is ``opts.dither * randn`` drawn from an explicit
``torch.Generator`` and added to the raw frames before DC removal
(``dither_noise``).  The noise is drawn on the generator's device and
moved to the frames' device, so a CPU generator gives the same noise to
a run on the card and a run on the CPU.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.config import configclass

EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, Kaldi's log floor


@configclass
class FrameExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


@configclass
class MelBanksOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0 means nyquist + high_freq


@configclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = None  # type: ignore
    mel_opts: MelBanksOptions = None  # type: ignore
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True

    def __post_init__(self):
        if self.frame_opts is None:
            self.frame_opts = FrameExtractionOptions()
        if self.mel_opts is None:
            self.mel_opts = MelBanksOptions()


@configclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = None  # type: ignore
    mel_opts: MelBanksOptions = None  # type: ignore
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0

    def __post_init__(self):
        if self.frame_opts is None:
            self.frame_opts = FrameExtractionOptions()
        if self.mel_opts is None:
            self.mel_opts = MelBanksOptions()


# --------------------------------------------------------------------------
# Windows / framing
# --------------------------------------------------------------------------

def feature_window(opts: FrameExtractionOptions) -> np.ndarray:
    """The analysis window (ref: feature-window.cc FeatureWindowFunction)."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        w = 0.42 - 0.5 * np.cos(a * i) + 0.08 * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {opts.window_type!r}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Frame count (snip_edges semantics of feature-window.h NumFrames)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def extract_frames(wave: torch.Tensor,
                   opts: FrameExtractionOptions) -> torch.Tensor:
    """Slice the waveform into contiguous [T, window_size] raw frames.

    snip_edges=True: frame t covers samples [t*shift, t*shift + ws);
    snip_edges=False: frames are centred, with mirrored edges."""
    n = wave.shape[0]
    T = num_frames(n, opts)
    ws, sh = opts.window_size, opts.window_shift
    if T == 0:
        return wave.new_zeros((0, ws))
    if opts.snip_edges:
        return wave.unfold(0, ws, sh)[:T].contiguous()
    starts = np.arange(T) * sh + sh // 2 - ws // 2
    idx = starts[:, None] + np.arange(ws)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    idx = np.clip(idx, 0, n - 1)
    return wave[torch.as_tensor(idx, device=wave.device)]


def dither_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard-normal f32 noise from ``generator``, on ``device``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def add_dither(frames: torch.Tensor, opts: FrameExtractionOptions,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    x = frames.to(torch.float32)
    if opts.dither != 0.0 and generator is not None:
        x = x + opts.dither * dither_noise(x.shape, generator, x.device)
    return x


def process_window(
    frames: torch.Tensor,
    opts: FrameExtractionOptions,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dither -> DC removal -> raw log-energy -> preemphasis -> window.

    ref: feature-window.cc ProcessWindow/ExtractWindow.  Returns
    (windowed [T, window_size], raw log energy [T])."""
    x = add_dither(frames, opts, generator)
    if opts.remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    raw_energy = torch.log(torch.clamp_min((x * x).sum(dim=-1), EPSILON))
    if opts.preemph_coeff != 0.0:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        x = x - opts.preemph_coeff * prev
    x = x * torch.as_tensor(feature_window(opts), device=x.device)
    return x, raw_energy


def frame_signal(
    wave: torch.Tensor,
    opts: FrameExtractionOptions,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wave [N] -> (windowed, zero-padded frames [T, padded], log-energy
    [T]), on the wave's device."""
    win, energy = process_window(extract_frames(wave, opts), opts,
                                 generator)
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        win = torch.nn.functional.pad(win, (0, pad))
    return win, energy


# --------------------------------------------------------------------------
# Mel filterbank / DFT tables (host numpy)
# --------------------------------------------------------------------------

def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)


@lru_cache(maxsize=None)
def _mel_banks_cached(num_bins, low_freq, high_freq, samp_freq,
                      padded_window_size):
    nyquist = 0.5 * samp_freq
    high = high_freq if high_freq > 0 else nyquist + high_freq
    if not (0 <= low_freq < high <= nyquist):
        raise ValueError(
            f"bad mel range [{low_freq}, {high}] vs nyquist {nyquist}")
    num_fft_bins = padded_window_size // 2 + 1
    fft_bin_width = samp_freq / padded_window_size
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high)
    delta = (mel_high - mel_low) / (num_bins + 1)
    centers = mel_low + delta * np.arange(num_bins + 2)
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)[None, :]
    left = centers[:-2, None]
    center = centers[1:-1, None]
    right = centers[2:, None]
    up = (mels - left) / (center - left)
    down = (right - mels) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32)  # [num_bins, num_fft_bins]


def mel_banks(opts: MelBanksOptions,
              frame_opts: FrameExtractionOptions) -> np.ndarray:
    """[num_bins, num_fft_bins] triangular filters
    (ref: mel-computations.cc MelBanks::MelBanks)."""
    return _mel_banks_cached(
        opts.num_bins, opts.low_freq, opts.high_freq,
        frame_opts.samp_freq, frame_opts.padded_window_size)


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [num_rows, num_cols]
    (ref: matrix/matrix-functions.cc ComputeDctMatrix)."""
    m = np.zeros((num_rows, num_cols))
    m[0, :] = math.sqrt(1.0 / num_cols)
    scale = math.sqrt(2.0 / num_cols)
    for k in range(1, num_rows):
        m[k, :] = scale * np.cos(math.pi / num_cols * (np.arange(num_cols) + 0.5) * k)
    return m.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Cepstral liftering coefficients (ref: feature-mfcc.cc ComputeLifterCoeffs)."""
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def dft_matrices(padded_window_size: int):
    """Real DFT as two matmul operands: cos/sin matrices [N, N/2 + 1]."""
    n = padded_window_size
    f = n // 2 + 1
    k = np.arange(n)[:, None]
    j = np.arange(f)[None, :]
    ang = 2.0 * np.pi * k * j / n
    cos = np.cos(ang)
    sin = -np.sin(ang)
    return cos.astype(np.float32), sin.astype(np.float32)


# --------------------------------------------------------------------------
# fbank and MFCC references (rfft), deltas
# --------------------------------------------------------------------------

def power_spectrum(windowed: torch.Tensor) -> torch.Tensor:
    """[T, padded] -> [T, padded//2+1] |rfft|^2 (srfft.cc equivalent)."""
    spec = torch.fft.rfft(windowed, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)


def compute_fbank(
    wave: torch.Tensor,
    opts: Optional[FbankOptions] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """wave [N] -> log-mel filterbank [T, num_bins(+1 if use_energy)]
    through torch.fft.rfft (ref: feature-fbank.cc Fbank::Compute; energy,
    if used, goes in column 0)."""
    opts = opts or FbankOptions()
    fo = opts.frame_opts
    windowed, log_energy = frame_signal(wave, fo, generator)
    power = power_spectrum(windowed)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo), device=wave.device)
    feats = power @ mel.T
    if opts.use_log_fbank:
        feats = torch.log(torch.clamp_min(feats, EPSILON))
    if opts.use_energy:
        energy = log_energy if opts.raw_energy else torch.log(
            torch.clamp_min((windowed ** 2).sum(dim=-1), EPSILON))
        if opts.energy_floor > 0.0:
            energy = torch.clamp_min(energy, math.log(opts.energy_floor))
        feats = torch.cat([energy[:, None], feats], dim=1)
    return feats


def mfcc_fbank_options(opts: MfccOptions) -> FbankOptions:
    """The log-mel fbank under an MFCC: the same frames and bins, with the
    raw log energy (Kaldi's default, and what the JAX package's
    ``compute_mfcc`` and the fbank kernels always give) beside it."""
    return FbankOptions(frame_opts=opts.frame_opts, mel_opts=opts.mel_opts,
                        use_energy=True, raw_energy=True, use_log_fbank=True)


@lru_cache(maxsize=None)
def cepstral_matrix(num_ceps: int, num_bins: int,
                    cepstral_lifter: float) -> np.ndarray:
    """[num_bins, num_ceps] f32: the DCT with the lifter folded in, so
    that log-mel @ it gives the liftered cepstra in one product."""
    m = dct_matrix(num_ceps, num_bins).T.astype(np.float64)
    if cepstral_lifter != 0.0:
        m = m * lifter_coeffs(num_ceps, cepstral_lifter)[None, :]
    return m.astype(np.float32)


def cepstra(log_mel: torch.Tensor, energy: torch.Tensor,
            opts: MfccOptions) -> torch.Tensor:
    """log-mel [T, num_bins] and raw log energy [T] -> MFCC [T, num_ceps]:
    the DCT and the lifter as one product on log-mel's device, then,
    with ``use_energy``, the (floored) energy in column 0."""
    m = torch.as_tensor(cepstral_matrix(opts.num_ceps, opts.mel_opts.num_bins,
                                        float(opts.cepstral_lifter)),
                        device=log_mel.device, dtype=log_mel.dtype)
    feats = log_mel @ m
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            energy = torch.clamp_min(energy, math.log(opts.energy_floor))
        feats = torch.cat([energy[:, None].to(feats.dtype), feats[:, 1:]],
                          dim=1)
    return feats


def compute_mfcc(
    wave: torch.Tensor,
    opts: Optional[MfccOptions] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """wave [N] -> MFCC [T, num_ceps] (ref: feature-mfcc.cc Mfcc::Compute):
    log-mel and raw log energy from ``compute_fbank``, then ``cepstra``."""
    opts = opts or MfccOptions()
    both = compute_fbank(wave, mfcc_fbank_options(opts), generator)
    return cepstra(both[:, 1:], both[:, 0], opts)


# --------------------------------------------------------------------------
# Post-processing: CMVN, deltas, splicing
# --------------------------------------------------------------------------

def apply_cmvn(feats: torch.Tensor, norm_vars: bool = False) -> torch.Tensor:
    """Per-utterance cepstral mean (and optionally variance) normalization
    (ref: transform/cmvn.cc ApplyCmvn with per-utt stats), on the
    input's device."""
    mean = feats.mean(dim=0, keepdim=True)
    out = feats - mean
    if norm_vars:
        var = feats.var(dim=0, correction=0, keepdim=True)
        out = out / torch.sqrt(var + 1e-10)
    return out


def cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Kaldi-layout CMVN stats [2, dim+1]: row0 = sum,count; row1 = sumsq.
    (ref: transform/cmvn.cc AccCmvnStats)."""
    dim = feats.shape[1]
    stats = np.zeros((2, dim + 1), dtype=np.float64)
    stats[0, :dim] = feats.sum(axis=0)
    stats[0, dim] = feats.shape[0]
    stats[1, :dim] = (feats ** 2).sum(axis=0)
    return stats


def apply_cmvn_stats(feats: torch.Tensor, stats: np.ndarray,
                     norm_vars: bool = False) -> torch.Tensor:
    """Normalize with precomputed stats (``cmvn_stats`` layout): the mean
    and variance in float64 on the host, the arithmetic in the
    features' dtype on their device."""
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    like = dict(dtype=feats.dtype, device=feats.device)
    out = feats - torch.as_tensor(mean, **like)
    if norm_vars:
        var = stats[1, :-1] / count - mean ** 2
        out = out / torch.as_tensor(np.sqrt(np.maximum(var, 1e-10)), **like)
    return out


def sliding_window_cmn(feats: torch.Tensor, window: int = 600,
                       center: bool = True) -> torch.Tensor:
    """Sliding-window cepstral mean normalization
    (ref: feature-functions.cc SlidingWindowCmn, cmn_window=600, center):
    the window bounds on the host, the prefix sums on the input's
    device."""
    T = feats.shape[0]
    cum = torch.cumsum(torch.nn.functional.pad(feats, (0, 0, 1, 0)), dim=0)
    t = np.arange(T)
    if center:
        lo = np.clip(t - window // 2, 0, T)
        hi = np.clip(t + (window + 1) // 2, 0, T)
        # widen clipped edge windows to `window` frames where possible
        lo = np.where(hi - lo < window, np.maximum(0, hi - window), lo)
        hi = np.where(hi - lo < window, np.minimum(T, lo + window), hi)
    else:
        lo = np.clip(t + 1 - window, 0, T)
        hi = np.maximum(t + 1, np.minimum(window, T))
    n = torch.as_tensor((hi - lo)[:, None], dtype=feats.dtype,
                        device=feats.device)
    lo, hi = (torch.as_tensor(i, device=feats.device) for i in (lo, hi))
    return feats - (cum[hi] - cum[lo]) / n


def compute_deltas(feats: torch.Tensor, order: int = 2,
                   window: int = 2) -> torch.Tensor:
    """Append delta features (ref: feature-functions.cc DeltaFeatures):
    regression over [-w..w] normalised by 2 * sum(i^2), edges replicate."""
    outs = [feats]
    cur = feats
    denom = sum(i * i for i in range(1, window + 1)) * 2
    offsets = np.arange(-window, window + 1)
    scales = torch.as_tensor(offsets / denom, dtype=feats.dtype,
                             device=feats.device)
    T = feats.shape[0]
    idx = np.clip(np.arange(T)[:, None] + offsets[None, :], 0, T - 1)
    idx = torch.as_tensor(idx, device=feats.device)
    for _ in range(order):
        cur = torch.einsum("twd,w->td", cur[idx], scales)
        outs.append(cur)
    return torch.cat(outs, dim=1)


def splice_frames(feats: np.ndarray, left_context: int,
                  right_context: int) -> np.ndarray:
    """[T, D] -> [T, (l+r+1)*D] with edge replication
    (ref: feature-functions.cc SpliceFrames; nnet2 SpliceComponent).
    Host numpy in and out: LDA, MLLT, fMLLR and the egs splice on the
    host."""
    T = feats.shape[0]
    offsets = np.arange(-left_context, right_context + 1)
    idx = np.clip(np.arange(T)[:, None] + offsets[None, :], 0, T - 1)
    return feats[idx].reshape(T, -1)
