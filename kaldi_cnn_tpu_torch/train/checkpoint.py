"""Checkpoints in the JAX package's npz layout
(twin of ``kaldi_cnn_tpu/train/checkpoint.py``).

Keys ``p{i}`` hold the parameter leaves and ``o{i}`` the optimizer-state
leaves, in ``jax.tree_util`` flatten order: tuples and lists in order,
dict keys sorted, an NG state as (u, d, rho, t); ``meta`` is JSON bytes.
A checkpoint written by either package loads into the other.  Leaves
may be numpy arrays or tensors (saved from the host); loaded leaves are
numpy arrays, and an NG state's step count comes back as an integer.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.models.ng_sgd import NGState


def _leaves(tree: Any, out: List) -> List:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (tuple, list)):      # NGState is a tuple too
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _rebuild(template: Any, it) -> Any:
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if isinstance(template, NGState):
        u, d, rho, t = (next(it) for _ in range(4))
        return NGState(u=u, d=d, rho=rho, t=int(t))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, it) for v in template)
    if template is None:
        return None
    return next(it)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)          # an NG step count
    return np.asarray(leaf)


def save_checkpoint(path: str, params: Any, opt: Any = None,
                    meta: Dict = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"p{i}": _numpy(leaf)
              for i, leaf in enumerate(_leaves(params, []))}
    if opt is not None:
        arrays.update({f"o{i}": _numpy(leaf)
                       for i, leaf in enumerate(_leaves(opt, []))})
    arrays["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str, params_template: Any,
                    opt_template: Any = None) -> Tuple[Any, Any, Dict]:
    """Restores into the structure of the given templates."""
    with np.load(path) as z:
        n_p = len(_leaves(params_template, []))
        params = _rebuild(params_template,
                          iter([z[f"p{i}"] for i in range(n_p)]))
        opt = None
        if opt_template is not None:
            n_o = len(_leaves(opt_template, []))
            opt = _rebuild(opt_template,
                           iter([z[f"o{i}"] for i in range(n_o)]))
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
    return params, opt, meta
