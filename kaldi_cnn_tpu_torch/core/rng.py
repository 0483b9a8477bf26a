"""RNG discipline (twin of ``kaldi_cnn_tpu/core/rng.py``).

Every stochastic stage derives its seed from (base_seed, stage_name,
index), so runs are reproducible and independent of execution order.
``np_rng`` gives the same numpy streams as the JAX package;
``torch_generator`` gives an explicit ``torch.Generator`` for the same
stage (torch's streams differ from jax.random's, so tests that compare
the two packages feed both numpy-made inputs).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def stage_seed(base_seed: int, stage: str, index: int = 0) -> int:
    h = hashlib.sha256(f"{base_seed}/{stage}/{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & 0x7FFFFFFF


def np_rng(base_seed: int, stage: str, index: int = 0
           ) -> np.random.Generator:
    return np.random.default_rng(stage_seed(base_seed, stage, index))


def torch_generator(base_seed: int, stage: str, index: int = 0,
                    device="cpu") -> torch.Generator:
    """A generator for the stage.  On the CPU (the default), noise drawn
    from it is the same whichever device it is moved to; on a CUDA
    device it draws there (another stream than the CPU's)."""
    g = torch.Generator(device=device)
    g.manual_seed(stage_seed(base_seed, stage, index))
    return g
