"""Data-parallel training step over a rank grid (twin of
``kaldi_cnn_tpu/parallel/dp.py``; ref: steps/nnet2/train_*.sh N parallel
jobs + nnet2bin/nnet-am-average; Povey et al. ICLR WS 2015).

Mode A (``make_dp_step``): ONE train step over the global minibatch,
its rows split over the mesh's data axis, one slice a rank.  The JAX
package jits the step with the batch sharded and lets GSPMD put a psum
on every contraction over rows; here ``Nnet.train_step`` is given the
mesh's data group and all-reduces each sum over rows itself (the
objective's, and each NG-SGD update's gradient, norms, projections and
row sample: ``models/ng_sgd.py``).  Every rank then computes the
single-device step of the global minibatch, so parameters and NG states
stay bit-equal across ranks: an all-reduce hands every rank the same
bits.

Model averaging (nnet-am-average): ``stack_replicas``,
``average_replicas`` and ``average_params`` work on lists of parameter
sets in the JAX pytree layout (per-component dicts of tensors or
arrays), where the JAX package stacks a leading replica axis.  Over a
list, ``average_replicas`` and ``average_params`` are one function.

Not ported: ``make_dp_tp_step`` (tensor parallelism on a "model"
axis), ``make_replica_step`` (independent streams vmapped on one host;
replica mode over ranks is ``parallel/multihost.py``) and
``initialize_distributed`` (``multihost.initialize`` starts the process
group).
"""

from __future__ import annotations

import copy
from typing import Callable, List

import torch

from kaldi_cnn_tpu_torch.core.mesh import Mesh
from kaldi_cnn_tpu_torch.models.nnet import Nnet


def make_dp_step(net: Nnet, mesh: Mesh) -> Callable:
    """Returns step(opt, x, labels, lr, weights=None, generator=None) ->
    (opt', objf): x/labels/weights are THIS rank's rows of the global
    minibatch (host arrays or tensors; ``core.mesh.shard_batch`` cuts
    them), the parameters in ``net`` change in place, and objf is the
    global minibatch's, a device scalar.  Every rank of the replica
    passes the same ``generator`` (Dropout draws the global minibatch's
    mask from it).  The mesh's data group is one replica, so the same
    step serves each replica's stream in replica mode."""
    dev = mesh.device

    def step(opt, x, labels, lr: float, weights=None, generator=None):
        return net.train_step(
            opt, torch.as_tensor(x, device=dev),
            torch.as_tensor(labels, device=dev), lr,
            None if weights is None else torch.as_tensor(weights,
                                                         device=dev),
            group=mesh.data_group, generator=generator)

    return step


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_replicas(tree, num_replicas: int) -> List:
    """``num_replicas`` independent copies of a parameter (or NG state)
    set."""
    return [copy.deepcopy(tree) for _ in range(num_replicas)]


def average_params(param_list: List):
    """nnet-am-average equivalent: elementwise mean over model copies
    (ref: src/nnet2bin/nnet-am-average.cc), leaf by leaf as the JAX
    package sums them."""
    n = len(param_list)
    return _tree_map(lambda *leaves: sum(leaves) / n, *param_list)


# the once-per-outer-iteration sync of the reference, over a list of
# replicas' parameter sets
average_replicas = average_params

