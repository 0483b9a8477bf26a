"""Parameter and optimizer-state exchange with the JAX package.

``params_from_jax`` loads the pytree of ``kaldi_cnn_tpu`` ``Nnet.init``
(a tuple of per-component dicts, converted to numpy arrays) into the
port's modules, so both packages compute the same function.  Both keep
``w [out, in]`` and ``b [out]``, so the copy is one to one; a
``SliceParallelComponent``'s entry nests as ``{"parts": (one dict a
part)}``; a ``FixedAffineComponent``'s ``w``/``b`` (buffers in the
port, leaves of the pytree in the JAX package) are carried too, and the
components without parameters take ``{}``.
``opt_from_jax``/``opt_to_numpy`` do the same for ``Nnet.init_opt``'s
tuple of per-component ``{"ng_in", "ng_out"}`` NG states (``{}``
untrained, ``{"parts": (...)}`` for a slice).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_cnn_tpu_torch.models.components import (
    FixedAffineComponent, map_tree, param_tree)
from kaldi_cnn_tpu_torch.models.ng_sgd import NGState
from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet


def _tree(c, leaf):
    """``param_tree``, with a FixedAffineComponent's buffers as its
    parameters (the JAX package keeps them in the pytree)."""
    if isinstance(c, FixedAffineComponent):
        return {k: leaf(k, t) for k, t in c.named_buffers()}
    return param_tree(c, leaf)


def _load_component(c, p, where: str) -> None:
    names = map_tree(p, lambda k, _: k)
    want = _tree(c, lambda k, _: k)
    if names != want:
        raise ValueError(f"{where} ({type(c).__name__}): params {names}, "
                         f"want {want}")
    own = {**dict(c.named_parameters()), **dict(c.named_buffers())}

    def copy(name, value):
        src = torch.from_numpy(np.array(value, np.float32))
        if src.shape != own[name].shape:
            raise ValueError(f"{where}.{name}: shape {tuple(src.shape)} "
                             f"vs {tuple(own[name].shape)}")
        own[name].copy_(src)

    map_tree(p, copy)


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
            _load_component(c, p, f"component {i}")
    if priors is not None:
        if not isinstance(net, AmNnet):
            raise TypeError("priors need an AmNnet")
        net.priors = np.asarray(priors, np.float64).copy()


def params_to_numpy(net: Nnet) -> Tuple[Dict, ...]:
    """The inverse of ``params_from_jax``: the JAX pytree layout."""
    return tuple(_tree(c, lambda _, t: t.detach().cpu().numpy())
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
    return tuple(map_tree(o, lambda _, v: state(v)) for o in opt)


def opt_to_numpy(opt: Sequence[Dict]) -> Tuple[Dict, ...]:
    """The inverse of ``opt_from_jax``: numpy leaves, t as int32."""
    def state(s):
        return NGState(u=s.u.detach().cpu().numpy(),
                       d=s.d.detach().cpu().numpy(),
                       rho=s.rho.detach().cpu().numpy(),
                       t=np.asarray(s.t, np.int32))
    return tuple(map_tree(o, lambda _, v: state(v)) for o in opt)
