"""Logging + structured JSONL metrics.

Replaces Kaldi's KALDI_LOG/WARN/ERR -> stderr + per-job log files
(ref: src/base/kaldi-error.{h,cc}; utils/parallel/run.pl redirection)
with Python logging plus a structured metrics stream the trainer and
decoder write per step/utterance (SURVEY.md §5.5).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, IO, Optional

_FORMAT = "%(levelname)s (%(name)s) %(asctime)s %(message)s"


def get_logger(name: str, verbose: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
    env_v = int(os.environ.get("KCT_VERBOSE", "0"))
    level = logging.DEBUG if max(verbose, env_v) > 0 else logging.INFO
    logger.setLevel(level)
    return logger


class MetricsWriter:
    """Append-only JSONL metrics stream.

    One record per event, e.g.::

        {"ts": ..., "kind": "train_step", "step": 10, "loss": 2.3,
         "audio_seconds_per_sec": 812.0}

    Replaces Kaldi's exp/*/log/compute_prob_*.log diagnostics with a
    machine-readable stream.
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._f: Optional[IO] = stream
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def write(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": round(time.time(), 3), "kind": kind, **fields}
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self) -> None:
        if self._f is not None and self._f not in (sys.stdout, sys.stderr):
            self._f.close()
            self._f = None


class Timer:
    """Wall-clock timer (ref: src/base/timer.h ``Timer``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0
