"""Parameter exchange with the JAX package.

``params_from_jax`` loads the pytree of ``kaldi_cnn_tpu`` ``Nnet.init``
(a tuple of per-component dicts, converted to numpy arrays) into the
port's modules, so both packages compute the same function.  Both keep
``w [out, in]`` and ``b [out]``, so the copy is one to one.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet


def params_from_jax(net: Union[Nnet, AmNnet],
                    params: Sequence[Dict[str, np.ndarray]],
                    priors: Optional[np.ndarray] = None) -> None:
    """Copy per-component JAX params (and, for an AmNnet, the priors)."""
    nnet = net.nnet if isinstance(net, AmNnet) else net
    if len(params) != len(nnet.components):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(nnet.components)} components")
    with torch.no_grad():
        for i, (c, p) in enumerate(zip(nnet.components, params)):
            own = dict(c.named_parameters(recurse=False))
            if set(own) != set(p):
                raise ValueError(f"component {i} ({type(c).__name__}): "
                                 f"params {sorted(p)} vs {sorted(own)}")
            for name, t in own.items():
                src = torch.from_numpy(np.array(p[name], np.float32))
                if src.shape != t.shape:
                    raise ValueError(f"component {i}.{name}: shape "
                                     f"{tuple(src.shape)} vs {tuple(t.shape)}")
                t.copy_(src)
    if priors is not None:
        if not isinstance(net, AmNnet):
            raise TypeError("priors need an AmNnet")
        net.priors = np.asarray(priors, np.float64).copy()


def params_to_numpy(net: Nnet) -> Tuple[Dict[str, np.ndarray], ...]:
    """The inverse of ``params_from_jax``: the JAX pytree layout."""
    return tuple({k: v.detach().cpu().numpy()
                  for k, v in c.named_parameters(recurse=False)}
                 for c in net.components)
