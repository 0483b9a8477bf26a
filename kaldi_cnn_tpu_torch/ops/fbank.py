"""Fused log-mel filterbank: the CUDA kernels and their plain version.

Port of ``kaldi_cnn_tpu/ops/fbank_pallas.py`` (``fbank_pallas`` and
``mfcc_pallas``).  The
kernels (``csrc/fbank.cu``) run the whole per-frame chain

    DC-offset removal -> raw log energy -> preemphasis -> window
    -> real DFT -> |.|^2 -> mel -> log

for a batch of frames, and write [T, num_bins] log-mel and [T] raw log
energy with no lane padding.  ``fbank_kernel`` picks one from the padded
window size N before the launch: a real FFT in registers and warp
shuffles, one warp a frame, with the mel sums over each filter's band
only, when N is a power of two from 64 to 2048 (Kaldi's default
``round_to_power_of_two``; ``fbank_frames.launches``); a mixed-radix
real FFT (a 25-point DFT in each lane's registers, a power-of-two one
across L lanes) when N = 50 L is in ``MIXED_SIZES``, as Kaldi's 25 ms
frames are with ``round_to_power_of_two`` off (``fbank_frames_mixed``,
its own count); else the DFT as sums against cos/sin tables
(``fbank_frames_table``, its own count).
``fbank_reference_frames`` is the table DFT in plain PyTorch, in the
frames' dtype (float32, or float64 with float64 DFT tables).  Dither is
added to the raw frames before either; energy flooring and
``use_energy`` are applied after it.

``mfcc`` runs the same kernels with the energy kept and then the DCT
and the lifter as one small product on the device, as ``mfcc_pallas``
does them outside its Pallas call; it counts its launches through the
wrapper that ``fbank_frames`` picks.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel
or raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.ops import common

FFT_SIZES = (64, 2048)      # padded window sizes the FFT kernel takes
# the mixed-radix kernel's: N = 50 L, L = 2 .. 32 lanes a frame
MIXED_SIZES = (100, 200, 400, 800, 1600)


def fbank_kernel(frame_opts: F.FrameExtractionOptions) -> str:
    """``"fft"`` when the padded window size is a power of two in
    ``FFT_SIZES``, ``"mixed"`` when it is in ``MIXED_SIZES``, else
    ``"table"``."""
    n = frame_opts.padded_window_size
    lo, hi = FFT_SIZES
    if lo <= n <= hi and n & (n - 1) == 0:
        return "fft"
    return "mixed" if n in MIXED_SIZES else "table"


def fft_twiddles(n: int) -> np.ndarray:
    """[n + 64, 2] f32 (re, im): exp(-2 pi i t / n) for t < n, then
    exp(-2 pi i j / 64) for j < 64, computed in float64.  Both FFT
    kernels read it; the mixed-radix one only its first n rows."""
    t = np.concatenate([np.arange(n) / n, np.arange(64) / 64])
    w = np.exp(-2j * np.pi * t)
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


def mel_bands(mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A [M, nb] filterbank as bands: ([2, M] int32 of each filter's first
    nonzero bin and its length up to its last nonzero bin; [L, M] f32 of
    the weights, L the longest band: row j holds each filter's weight at
    its first bin + j, zero past its length)."""
    bands = np.zeros((2, mel.shape[0]), np.int32)
    for m, row in enumerate(mel):
        nz = np.flatnonzero(row)
        if len(nz):
            bands[:, m] = nz[0], nz[-1] - nz[0] + 1
    weights = np.zeros((max(int(bands[1].max()), 1), mel.shape[0]),
                       np.float32)
    for m, (first, length) in enumerate(bands.T):
        weights[:length, m] = mel[m, first:first + length]
    return bands, weights


def _dft64(n: int):
    """features.functional.dft_matrices in float64."""
    ang = 2.0 * np.pi * np.arange(n)[:, None] * np.arange(n // 2 + 1) / n
    return np.cos(ang), -np.sin(ang)


class _Plan(NamedTuple):
    kernel: str                 # fbank_kernel's choice
    cos: torch.Tensor           # [n, nb]: the table kernel and the plain
    sin: torch.Tensor
    mel: torch.Tensor           # [M, nb]
    window: torch.Tensor        # [ws]
    n: int                      # padded window size
    twiddle: torch.Tensor       # [n + 64, 2] f32: the FFT kernels
    bands: torch.Tensor         # [2, M] int32
    band_w: torch.Tensor        # [L, M] f32


@lru_cache(maxsize=16)
def _tables(samp_freq: float, frame_length_ms: float, pow2: bool,
            window_type: str, num_bins: int, low_freq: float,
            high_freq: float, device: torch.device,
            dtype: torch.dtype) -> _Plan:
    fo = F.FrameExtractionOptions(
        samp_freq=samp_freq, frame_length_ms=frame_length_ms,
        round_to_power_of_two=pow2, window_type=window_type)
    mo = F.MelBanksOptions(num_bins=num_bins, low_freq=low_freq,
                           high_freq=high_freq)
    n = fo.padded_window_size
    mel = F.mel_banks(mo, fo)
    cos, sin = (_dft64(n) if dtype == torch.float64
                else F.dft_matrices(n))
    bands, band_w = mel_bands(mel)
    t = lambda a, dt=dtype: torch.as_tensor(a, device=device).to(dt)
    return _Plan(fbank_kernel(fo), t(cos), t(sin), t(mel),
                 t(F.feature_window(fo)), n,
                 t(fft_twiddles(n), torch.float32), t(bands, torch.int32),
                 t(band_w, torch.float32))


def _plan(opts: F.FbankOptions, device: torch.device,
          dtype: torch.dtype = torch.float32) -> _Plan:
    fo, mo = opts.frame_opts, opts.mel_opts
    return _tables(fo.samp_freq, fo.frame_length_ms,
                   fo.round_to_power_of_two, fo.window_type, mo.num_bins,
                   mo.low_freq, mo.high_freq, device, dtype)


def fbank_reference_frames(frames: torch.Tensor, opts: F.FbankOptions
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels: dithered frames [T, ws] ->
    (log-mel [T, num_bins], raw log energy [T]), in the frames' dtype."""
    fo = opts.frame_opts
    p = _plan(opts, frames.device, frames.dtype)
    x = frames
    if fo.remove_dc_offset:
        x = x - x.sum(dim=1, keepdim=True) / float(fo.window_size)
    energy = torch.log(torch.clamp_min((x * x).sum(dim=1), F.EPSILON))
    if fo.preemph_coeff != 0.0:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        x = x - fo.preemph_coeff * prev
    x = x * p.window
    pad = fo.padded_window_size - fo.window_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    re = x @ p.cos
    im = x @ p.sin
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ p.mel.T, F.EPSILON)), energy


def _outputs(frames: torch.Tensor, opts: F.FbankOptions):
    T = frames.shape[0]
    common.require(frames, "frames", torch.float32,
                   (T, opts.frame_opts.window_size))
    M = opts.mel_opts.num_bins
    return (torch.empty((T, M), dtype=torch.float32, device=frames.device),
            torch.empty((T,), dtype=torch.float32, device=frames.device))


def fbank_frames_table(frames: torch.Tensor, opts: F.FbankOptions
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fbank_frames`` through the table kernel, whatever the padded
    window size."""
    if not common.on_cuda(frames):
        return fbank_reference_frames(frames, opts)
    fo = opts.frame_opts
    out, energy = _outputs(frames, opts)
    p = _plan(opts, frames.device)
    rc = common.library().kcnn_fbank(
        frames.data_ptr(), frames.shape[0], fo.window_size, p.cos.data_ptr(),
        p.sin.data_ptr(), p.cos.shape[1], p.mel.data_ptr(), p.mel.shape[0],
        p.window.data_ptr(), float(fo.preemph_coeff),
        int(fo.remove_dc_offset), out.data_ptr(), energy.data_ptr(),
        common.stream_ptr(frames.device))
    common.check_launch("kcnn_fbank", rc)
    fbank_frames_table.launches += 1
    return out, energy


def _fft(fn: str, frames: torch.Tensor, opts: F.FbankOptions, p: _Plan
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the FFT kernel ``fn`` (power-of-two or mixed-radix; both
    take the same arguments) on the CUDA frames with their plan ``p``."""
    fo = opts.frame_opts
    out, energy = _outputs(frames, opts)
    rc = getattr(common.library(), fn)(
        frames.data_ptr(), frames.shape[0], fo.window_size, p.n,
        p.twiddle.data_ptr(), p.window.data_ptr(), p.bands.data_ptr(),
        p.band_w.data_ptr(), p.bands.shape[1],
        float(fo.preemph_coeff), int(fo.remove_dc_offset), out.data_ptr(),
        energy.data_ptr(), common.stream_ptr(frames.device))
    common.check_launch(fn, rc)
    return out, energy


def fbank_frames_mixed(frames: torch.Tensor, opts: F.FbankOptions
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fbank_frames`` through the mixed-radix FFT kernel; the padded
    window size must be in ``MIXED_SIZES`` (the kernel raises
    otherwise)."""
    if not common.on_cuda(frames):
        return fbank_reference_frames(frames, opts)
    res = _fft("kcnn_fbank_fft_mixed", frames, opts,
               _plan(opts, frames.device))
    fbank_frames_mixed.launches += 1
    return res


def fbank_frames(frames: torch.Tensor, opts: F.FbankOptions
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel entry on dithered frames [T, ws] f32: (log-mel, energy).
    CPU tensors take ``fbank_reference_frames``."""
    if not common.on_cuda(frames):
        return fbank_reference_frames(frames, opts)
    p = _plan(opts, frames.device)
    if p.kernel == "table":
        return fbank_frames_table(frames, opts)
    if p.kernel == "mixed":
        return fbank_frames_mixed(frames, opts)
    res = _fft("kcnn_fbank_fft", frames, opts, p)
    fbank_frames.launches += 1
    return res


common.counted(fbank_frames)
common.counted(fbank_frames_mixed)
common.counted(fbank_frames_table)


def _finish(out, energy, opts: F.FbankOptions) -> torch.Tensor:
    if not opts.use_energy:
        return out
    if opts.energy_floor > 0:
        energy = torch.clamp_min(energy, math.log(opts.energy_floor))
    return torch.cat([energy[:, None], out], dim=1)


def _frames(wave: torch.Tensor, opts: F.FbankOptions,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    fo = opts.frame_opts
    return F.add_dither(F.extract_frames(wave, fo), fo,
                        generator).contiguous()


def fbank(wave: torch.Tensor, opts: Optional[F.FbankOptions] = None,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """wave [N] -> log-mel fbank [T, num_bins(+1)] through the kernel on
    a CUDA tensor, through ``fbank_reference`` on a CPU tensor."""
    opts = opts or F.FbankOptions()
    return _finish(*fbank_frames(_frames(wave, opts, generator), opts),
                   opts)


def fbank_reference(wave: torch.Tensor,
                    opts: Optional[F.FbankOptions] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The plain PyTorch version of ``fbank`` on any device."""
    opts = opts or F.FbankOptions()
    return _finish(*fbank_reference_frames(
        _frames(wave, opts, generator), opts), opts)


def mfcc(wave: torch.Tensor, opts: Optional[F.MfccOptions] = None,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """wave [N] -> MFCC [T, num_ceps]: log-mel and raw log energy from
    ``fbank_frames`` (the kernel on a CUDA tensor, the plain version on a
    CPU tensor), then ``F.cepstra``."""
    opts = opts or F.MfccOptions()
    fb = F.mfcc_fbank_options(opts)
    return F.cepstra(*fbank_frames(_frames(wave, fb, generator), fb), opts)


def mfcc_reference(wave: torch.Tensor, opts: Optional[F.MfccOptions] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The plain PyTorch version of ``mfcc`` on any device."""
    opts = opts or F.MfccOptions()
    fb = F.mfcc_fbank_options(opts)
    return F.cepstra(*fbank_reference_frames(_frames(wave, fb, generator),
                                             fb), opts)
