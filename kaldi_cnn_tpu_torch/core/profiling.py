"""Tracing / profiling utilities (twin of ``kaldi_cnn_tpu/core/profiling.py``).

The reference's profiling is CuDevice::AccuProfile (cumulative time per
CUDA function, printed at exit; src/cudamatrix/cu-device.cc) plus ad hoc
base/timer.h timers.  The equivalents here:

  - ``accu_profile`` / ``print_profile``: the AccuProfile pattern for
    host-side stages (feature extraction, graph build, decode).
  - ``trace``: context manager around ``torch.profiler.profile`` (CPU
    activity, and CUDA when a card is present) writing a Chrome trace
    file into ``logdir`` on exit.
  - ``step_timer``: per-train-step wall/percentile stats with
    audio-seconds/s derivation (the first-class metric per
    BASELINE.md).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

_ACCU: Dict[str, list] = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def accu_profile(name: str) -> Iterator[None]:
    """(ref: CuDevice::AccuProfile) — accumulate wall time per tag."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _ACCU[name][0] += dt
        _ACCU[name][1] += 1


def print_profile(reset: bool = False) -> Dict[str, Dict]:
    """(ref: CuDevice::PrintProfile at program exit)."""
    out = {}
    for name, (tot, n) in sorted(_ACCU.items(), key=lambda kv: -kv[1][0]):
        out[name] = {"total_s": tot, "calls": n,
                     "mean_ms": 1e3 * tot / max(n, 1)}
        logger.info("profile: %-30s %8.3fs over %6d calls (%.2f ms/call)",
                    name, tot, n, 1e3 * tot / max(n, 1))
    if reset:
        _ACCU.clear()
    return out


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Chrome trace of the block (chrome://tracing, Perfetto) in
    ``logdir``/trace_<pid>_<ns>.json (replaces nvprof-era workflows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Per-step timing -> audio-seconds/s/chip
    (frames-per-second metric of the reference train logs)."""

    def __init__(self, frames_per_step: int,
                 frames_per_second: float = 100.0):
        self.frames_per_step = frames_per_step
        self.fps = frames_per_second
        self._times: list = []
        self._last: Optional[float] = None

    def tic(self) -> None:
        self._last = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._last
        self._times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self._times[1:] or self._times)  # drop compile
        step_s = float(np.median(t))
        return {
            "steps": len(self._times),
            "median_step_ms": 1e3 * step_s,
            "p95_step_ms": 1e3 * float(np.percentile(t, 95)),
            "audio_seconds_per_sec":
                self.frames_per_step / self.fps / step_s,
        }
