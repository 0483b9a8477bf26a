"""Fused log-mel filterbank: the CUDA kernel and its plain version.

Port of ``kaldi_cnn_tpu/ops/fbank_pallas.py`` (``fbank_pallas``).  The
kernel (``csrc/fbank.cu``) runs the whole per-frame chain

    DC-offset removal -> raw log energy -> preemphasis -> window
    -> real DFT against cos/sin tables -> |.|^2 -> mel -> log

for a batch of frames, and writes [T, num_bins] log-mel and [T] raw log
energy with no lane padding.  ``fbank_reference`` is the same
matmul-DFT math in plain PyTorch.  Dither is added to the raw frames
before either; energy flooring and ``use_energy`` are applied after it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import torch

from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.ops import common


@lru_cache(maxsize=16)
def _tables(samp_freq: float, frame_length_ms: float, pow2: bool,
            window_type: str, num_bins: int, low_freq: float,
            high_freq: float, device: torch.device):
    fo = F.FrameExtractionOptions(
        samp_freq=samp_freq, frame_length_ms=frame_length_ms,
        round_to_power_of_two=pow2, window_type=window_type)
    mo = F.MelBanksOptions(num_bins=num_bins, low_freq=low_freq,
                           high_freq=high_freq)
    cos, sin = F.dft_matrices(fo.padded_window_size)
    return tuple(torch.as_tensor(a, device=device) for a in (
        cos, sin, F.mel_banks(mo, fo), F.feature_window(fo)))


def _plan(opts: F.FbankOptions, device: torch.device):
    """(cos [n, nb], sin [n, nb], mel [M, nb], window [ws]) on device."""
    fo, mo = opts.frame_opts, opts.mel_opts
    return _tables(fo.samp_freq, fo.frame_length_ms,
                   fo.round_to_power_of_two, fo.window_type, mo.num_bins,
                   mo.low_freq, mo.high_freq, device)


def fbank_reference_frames(frames: torch.Tensor, opts: F.FbankOptions
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: dithered frames [T, ws] ->
    (log-mel [T, num_bins], raw log energy [T])."""
    fo = opts.frame_opts
    cos, sin, mel, window = _plan(opts, frames.device)
    x = frames
    if fo.remove_dc_offset:
        x = x - x.sum(dim=1, keepdim=True) / float(fo.window_size)
    energy = torch.log(torch.clamp_min((x * x).sum(dim=1), F.EPSILON))
    if fo.preemph_coeff != 0.0:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        x = x - fo.preemph_coeff * prev
    x = x * window
    pad = fo.padded_window_size - fo.window_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    re = x @ cos
    im = x @ sin
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel.T, F.EPSILON)), energy


def fbank_frames(frames: torch.Tensor, opts: F.FbankOptions
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel entry on dithered frames [T, ws] f32: (log-mel, energy).
    CPU tensors take ``fbank_reference_frames``."""
    if not common.on_cuda(frames):
        return fbank_reference_frames(frames, opts)
    fo = opts.frame_opts
    T, ws = frames.shape[0], fo.window_size
    common.require(frames, "frames", torch.float32, (T, ws))
    cos, sin, mel, window = _plan(opts, frames.device)
    M, nb = mel.shape
    out = torch.empty((T, M), dtype=torch.float32, device=frames.device)
    energy = torch.empty((T,), dtype=torch.float32, device=frames.device)
    lib = common.library()
    rc = lib.kcnn_fbank(
        frames.data_ptr(), T, ws, cos.data_ptr(), sin.data_ptr(), nb,
        mel.data_ptr(), M, window.data_ptr(), float(fo.preemph_coeff),
        int(fo.remove_dc_offset), out.data_ptr(), energy.data_ptr(),
        common.stream_ptr(frames.device))
    common.check_launch("kcnn_fbank", rc)
    fbank_frames.launches += 1
    return out, energy


fbank_frames.launches = 0


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
