"""RIFF WAV reading/writing (PCM16/PCM32/float32, mono or multichannel).

Replacement for Kaldi's src/feat/wave-reader.{h,cc} (WaveData): like the
reference we return samples as float32 in the int16 range (Kaldi keeps
wave samples unscaled, e.g. +-32768), which the feature options
(dither=1.0 etc.) assume.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wave(path: str) -> Tuple[np.ndarray, float]:
    """Returns (samples [num_channels, num_samples] float32, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        arr = np.frombuffer(samples, dtype="<i2").astype(np.float32)
    elif audio_format == 1 and bits == 32:
        arr = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 65536.0
    elif audio_format == 3 and bits == 32:
        arr = np.frombuffer(samples, dtype="<f4").astype(np.float32) * 32768.0
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    n = (len(arr) // channels) * channels
    arr = arr[:n].reshape(-1, channels).T
    return np.ascontiguousarray(arr), float(rate)


def write_wave(path: str, samples: np.ndarray, rate: float) -> None:
    """samples: [num_samples] or [channels, num_samples], int16 range."""
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, n = samples.shape
    pcm = np.clip(np.round(samples.T), -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, int(rate),
                            int(rate) * channels * 2, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
