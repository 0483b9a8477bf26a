"""Parameter and optimizer-state exchange with the JAX package.

``params_from_jax`` loads the pytree of ``kaldi_cnn_tpu`` ``Nnet.init``
(a tuple of per-component dicts, converted to numpy arrays) into the
port's modules, so both packages compute the same function.  Both keep
``w [out, in]`` and ``b [out]``, so the copy is one to one.
``opt_from_jax``/``opt_to_numpy`` do the same for ``Nnet.init_opt``'s
tuple of per-component ``{"ng_in", "ng_out"}`` NG states.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_cnn_tpu_torch.models.ng_sgd import NGState
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


def opt_from_jax(opt: Sequence[Dict],
                 device="cuda") -> Tuple[Dict, ...]:
    """JAX NG states (numpy leaves, or any (u, d, rho, t) tuple) -> the
    port's, with the step count as a host integer."""
    def state(s):
        u, d, rho, t = s
        f32 = dict(dtype=torch.float32, device=device)
        return NGState(u=torch.as_tensor(np.asarray(u), **f32),
                       d=torch.as_tensor(np.asarray(d), **f32),
                       rho=torch.as_tensor(np.asarray(rho), **f32),
                       t=int(np.asarray(t)))
    return tuple({k: state(v) for k, v in o.items()} for o in opt)


def opt_to_numpy(opt: Sequence[Dict]) -> Tuple[Dict, ...]:
    """The inverse of ``opt_from_jax``: numpy leaves, t as int32."""
    return tuple({k: NGState(u=s.u.detach().cpu().numpy(),
                             d=s.d.detach().cpu().numpy(),
                             rho=s.rho.detach().cpu().numpy(),
                             t=np.asarray(s.t, np.int32))
                  for k, s in o.items()} for o in opt)
