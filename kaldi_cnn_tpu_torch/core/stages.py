"""Stage-guarded recipe execution with per-stage artifacts.

The reference's entire recovery model is recipe-level idempotence:
every stage writes its artifacts under ``exp/<dir>`` and scripts take
``--stage K`` to re-enter after a crash, skipping completed work (ref:
steps/nnet2/train_*.sh stage guards, run.sh stage variables;
SURVEY.md §5.3).  This module is that model for the Python recipes:

    sr = StageRunner("exp/wsj", from_stage=args.stage)
    feats = sr.stage("mfcc", lambda: compute_features(...))
    am    = sr.stage("gmm",  lambda: train_mono(...))

A stage whose index is below ``from_stage`` AND whose artifact exists
is loaded from disk (the artifact's mtime is untouched — the test
criterion for "skipped"); everything else is computed and saved.  A
crash mid-recipe therefore loses only the running stage: re-launch with
``--stage K`` (or ``from_stage=auto_stage(exp_dir)``) and completed
stages replay from their artifacts.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional

from kaldi_cnn_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def _pickle_save(path: str, value: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)     # atomic: a crash never leaves a torn artifact


def _pickle_load(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


class StageRunner:
    """Sequential stage executor over an exp/-style directory."""

    def __init__(self, exp_dir: str, from_stage: int = 0):
        self.exp_dir = exp_dir
        self.from_stage = from_stage
        self.next_idx = 0
        os.makedirs(exp_dir, exist_ok=True)

    def _path(self, idx: int, name: str) -> str:
        return os.path.join(self.exp_dir, f"stage{idx:02d}_{name}.pkl")

    def stage(self, name: str, compute: Callable[[], Any],
              save: Optional[Callable[[str, Any], None]] = None,
              load: Optional[Callable[[str], Any]] = None) -> Any:
        """Run (or skip-and-load) the next stage.  ``save``/``load``
        override the pickle default for artifacts with their own
        format (e.g. npz, Kaldi .mdl)."""
        idx = self.next_idx
        self.next_idx += 1
        path = self._path(idx, name)
        if idx < self.from_stage and os.path.exists(path):
            logger.info("stage %d (%s): already done, loading %s",
                        idx, name, path)
            return (load or _pickle_load)(path)
        logger.info("stage %d (%s): running", idx, name)
        value = compute()
        (save or _pickle_save)(path, value)
        return value


class NullStageRunner:
    """No exp dir: compute every stage, persist nothing (the default
    in-memory recipe mode and the unit-test path)."""

    exp_dir = None
    from_stage = 0

    def stage(self, name: str, compute: Callable[[], Any],
              save=None, load=None) -> Any:
        return compute()


def make_runner(exp_dir: Optional[str], stage: int = 0):
    return StageRunner(exp_dir, stage) if exp_dir else NullStageRunner()


def auto_stage(exp_dir: str) -> int:
    """Highest resumable stage: 1 + the last contiguous stage index with
    an artifact on disk (``--stage auto`` convenience)."""
    idx = 0
    while True:
        found = [f for f in os.listdir(exp_dir)
                 if f.startswith(f"stage{idx:02d}_")] \
            if os.path.isdir(exp_dir) else []
        if not found:
            return idx
        idx += 1
