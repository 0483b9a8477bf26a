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
bits.  On the card over an NCCL group, the step is a replay of a CUDA
graph with its all-reduces inside (``Nnet.train_steps`` at K = 1,
``models/step_graphs.py``), the counterpart of the JAX package's jit;
over a gloo group, whose collectives run on the host and cannot be
captured, and on the CPU, it is ``Nnet.train_step`` run eagerly.

Model averaging (nnet-am-average): ``stack_replicas``,
``average_replicas`` and ``average_params`` work on lists of parameter
sets in the JAX pytree layout (per-component dicts of tensors or
arrays), where the JAX package stacks a leading replica axis.  Over a
list, ``average_replicas`` and ``average_params`` are one function.

Tensor parallelism (``make_dp_tp_step``): mode A over the data axis
plus, over the mesh's "model" axis, the wide Affine layers split by
output rows, as the JAX package's P("model", None) sharding of w and
P("model") of b: each rank keeps its row slice (``local_slice``) in a
``ShardedAffineComponent``, the forward gathers the output columns over
the model group, the input derivative is the model group's sum of the
shards' parts, and the NG-SGD update runs on every model rank from the
whole derivative (the output-side preconditioner needs all of its
columns) and updates that rank's rows.  The NG states stay whole on
every rank, as the JAX step keeps them replicated.  ``gather_params``
gives the whole parameters back in the JAX pytree layout.

Mode B in one process (``make_replica_step``): R independent NG-SGD
streams on one device, synchronized only by ``average_replicas``, where
the JAX package vmaps the step over a leading replica axis sharded over
its mesh's data slots.  Replica mode over ranks is
``parallel/multihost.py``.

``initialize_distributed`` joins a multi-process group
(``multihost.initialize`` calls it).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from kaldi_cnn_tpu_torch.convert import params_to_numpy
from kaldi_cnn_tpu_torch.core.mesh import (Mesh, all_gather_cols,
                                           all_reduce, local_slice)
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models.components import (AffineComponent,
                                                   Component, map_tree,
                                                   param_tree)
from kaldi_cnn_tpu_torch.models.ng_sgd import ng_affine_apply
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.models.step_graphs import replays_collectives


def make_dp_step(net: Nnet, mesh: Mesh, eager: bool = False) -> Callable:
    """Returns step(opt, x, labels, lr, weights=None, generator=None) ->
    (opt', objf): x/labels/weights are THIS rank's rows of the global
    minibatch (host arrays or tensors; ``core.mesh.shard_batch`` cuts
    them), the parameters in ``net`` change in place, and objf is the
    global minibatch's, a device scalar.  Every rank of the replica
    passes the same ``generator`` (Dropout draws the global minibatch's
    mask from it).  The mesh's data group is one replica, so the same
    step serves each replica's stream in replica mode.

    On a CUDA net over an NCCL data group the step replays a CUDA graph
    (``net.train_steps`` with one step, whose ``StepGraphs`` the net
    keeps; the learning rate goes in as float32, as there); otherwise,
    and always with ``eager``, it runs ``net.train_step`` eagerly."""
    dev, group = mesh.device, mesh.data_group
    graphed = (not eager and net.device.type == "cuda"
               and replays_collectives(group))

    def step(opt, x, labels, lr: float, weights=None, generator=None):
        if graphed:
            opt, objf = net.train_steps(
                opt, [x], [labels], [lr],
                weights=None if weights is None else [weights],
                generators=None if generator is None else [generator],
                group=group)
            return opt, objf[0]
        return net.train_step(
            opt, torch.as_tensor(x, device=dev),
            torch.as_tensor(labels, device=dev), lr,
            None if weights is None else torch.as_tensor(weights,
                                                         device=dev),
            group=group, generator=generator)

    return step


def make_replica_step(net: Nnet, mesh: Optional[Mesh], num_replicas: int,
                      eager: bool = False) -> Callable:
    """Mode B, the reference's exact semantics: ``num_replicas``
    independent SGD streams, synchronized only by explicit
    ``average_replicas`` calls (ref: steps/nnet2/train_*.sh N parallel
    jobs + nnet-am-average; Povey et al. ICLR WS 2015: NG-SGD makes the
    averaging work).  The counterpart of the JAX package's
    ``make_replica_step``, in one process on ``net``'s device (the
    ``mesh``'s, where one is given).

    Returns step(params_r, opt_r, x_r, labels_r, lr, indices_r=None,
    weights_r=None) -> (params_r', opt_r', objf_r): ``params_r`` and
    ``opt_r`` are R parameter sets (the JAX pytree layout) and NG states,
    as ``stack_replicas`` gives them; x_r [R, B, D], labels_r [R, B] and
    weights_r [R, B] (None: ones) each replica's rows; ``indices_r`` one
    generator index a replica in place of the JAX step's ``keys_r``
    (ROADMAP 3.20): replica r's Dropout draws from the generator of
    (0, "mh_step", indices_r[r]), and None draws nothing.  objf_r
    [R] is each replica's objective, a device tensor.

    The R steps take turns on ``net``: a replica's parameters are copied
    into it, it steps, and its new parameters are copied out (the
    parameters' addresses never change).  On a CUDA net each step
    replays ``net.train_steps``' CUDA graph at K = 1, whose NG states
    are copied into fixed storage and out again, so one set of graphs
    (a graph a gate pattern; a refreshing step cut around its eighs,
    ``models/step_graphs.py``) serves every replica.  On the CPU, and
    with ``eager``, it is ``net.train_step`` R times."""
    if mesh is not None and mesh.device != net.device:
        raise ValueError(f"mesh on {mesh.device}, net on {net.device}")
    dev = net.device

    def step(params_r, opt_r, x_r, labels_r, lr: float, indices_r=None,
             weights_r=None):
        if not (len(params_r) == len(opt_r) == len(x_r) == num_replicas):
            raise ValueError(f"{num_replicas} replicas: got "
                             f"{len(params_r)} / {len(opt_r)} / {len(x_r)}")
        steps = net._train_steps_eager if eager else net.train_steps
        new_p, new_o, objfs = [], [], []
        for r in range(num_replicas):
            set_params(net, params_r[r])
            gen = (None if indices_r is None else
                   torch_generator(0, "mh_step", int(indices_r[r]), dev))
            w = None if weights_r is None else weights_r[r]
            opt, objf = steps(opt_r[r], [x_r[r]], [labels_r[r]], [lr],
                              weights=None if w is None else [w],
                              generators=None if gen is None else [gen])
            new_p.append(tuple(param_tree(c, lambda _, t: t.detach().clone())
                               for c in net.components))
            new_o.append(opt)
            objfs.append(objf[0])
        return new_p, new_o, torch.stack(objfs)

    return step


@torch.no_grad()
def set_params(net: Nnet, params) -> None:
    """Copies a parameter set in the JAX pytree layout (tensors or
    arrays) into ``net``'s parameters, in place."""
    for c, p in zip(net.components, params, strict=True):
        own = dict(c.named_parameters())
        map_tree(p, lambda k, v: own[k].copy_(torch.as_tensor(v)))


class ShardedAffineComponent(Component):
    """This rank's rows [lo, hi) of an AffineComponent (its
    ``local_slice`` on the mesh's model axis) in a tensor-parallel
    step.  ``w`` [hi - lo, in] and ``b`` [hi - lo] are the shard;
    ``output_dim`` and the NG states are the whole layer's."""

    trainable = True

    def __init__(self, full: AffineComponent, mesh: Mesh):
        super().__init__()
        self.input_dim, self.output_dim = full.input_dim, full.output_dim
        self.max_change = full.max_change
        self.lo, self.hi = local_slice(full.output_dim, mesh.shape["model"],
                                       mesh.model_index)
        self.group = mesh.model_group
        self.w = nn.Parameter(full.w.detach()[self.lo:self.hi].clone(),
                              requires_grad=False)
        self.b = nn.Parameter(full.b.detach()[self.lo:self.hi].clone(),
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.w.dtype) @ self.w.T + self.b
        return all_gather_cols(y, self.output_dim, self.lo, self.group)

    def backprop(self, in_value, out_value, out_deriv, aux):
        part = out_deriv[:, self.lo:self.hi].to(self.w.dtype) @ self.w
        return all_reduce(part, self.group)

    # the whole layer's NG states, as the unsharded component keeps them
    init_opt = AffineComponent.init_opt

    @torch.no_grad()
    def update(self, opt, in_value, out_deriv, lr, ng_in, ng_out,
               group=None):
        """The whole layer's NG-SGD step from the whole derivative
        (every model rank computes the same statistics and states);
        this rank's rows of w and b change in place."""
        w, b, opt_in, opt_out = ng_affine_apply(
            ng_in, ng_out, opt["ng_in"], opt["ng_out"], in_value, out_deriv,
            self.w, self.b, lr, self.max_change, group,
            rows=(self.lo, self.hi))
        self.w.copy_(w)
        self.b.copy_(b)
        return {"ng_in": opt_in, "ng_out": opt_out}


def shard_model(net: Nnet, mesh: Mesh) -> Nnet:
    """Replaces in ``net``, in place, every AffineComponent whose
    output_dim the mesh's model axis divides by this rank's
    ``ShardedAffineComponent`` (the layers the JAX package's
    ``make_dp_tp_step`` shards); with a model axis of 1, none.  Load
    whole parameters first (``convert.params_from_jax``)."""
    m = mesh.shape["model"]
    for i, c in enumerate(net.components):
        if (isinstance(c, AffineComponent) and m > 1
                and c.output_dim % m == 0):
            net.components[i] = ShardedAffineComponent(c, mesh)
    return net


def gather_params(net: Nnet) -> Tuple[Dict[str, np.ndarray], ...]:
    """The whole parameters of a sharded ``net`` in the JAX pytree layout
    (``convert.params_to_numpy``'s): each shard's rows gathered over its
    model group.  Every rank of a model group must call it."""
    from kaldi_cnn_tpu_torch.convert import params_to_numpy
    out = list(params_to_numpy(net))
    for i, c in enumerate(net.components):
        if isinstance(c, ShardedAffineComponent):
            w = all_gather_cols(c.w.detach().T.contiguous(), c.output_dim,
                                c.lo, c.group).T
            b = all_gather_cols(c.b.detach()[None], c.output_dim, c.lo,
                                c.group)[0]
            out[i] = {"w": w.cpu().numpy(), "b": b.cpu().numpy()}
    return tuple(out)


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def make_dp_tp_step(net: Nnet, mesh: Mesh) -> Callable:
    """Mode A over the mesh's data axis plus tensor parallelism of the
    wide Affine layers over its model axis: ``net``'s layers are sharded
    in place (``shard_model``), and the step is ``make_dp_step``'s,
    step(opt, x, labels, lr, weights=None, generator=None) -> (opt',
    objf), with x/labels/weights this rank's rows along the data axis
    (the ranks of one model group hold the same rows).  Gathered back
    (``gather_params``), the parameters are the single-process step's.

    Every rank of a model group computes the layers it does not shard
    (the conv front end) itself, so their copies stay bit-equal only if
    the kernels are deterministic: the step runs with cuDNN's
    deterministic algorithms (its default filter-gradient convolution on
    the card is not, and left the copies 1.5e-8 apart in 3 steps).  It
    runs eagerly: its layers gather over the model group, which a step
    graph's key does not hold, and it runs over gloo on one card."""
    step = make_dp_step(shard_model(net, mesh), mesh, eager=True)

    def tp_step(*args, **kwargs):
        with _deterministic_cudnn():
            return step(*args, **kwargs)

    return tp_step


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           timeout: Optional[datetime.timedelta] = None
                           ) -> None:
    """Multi-process group init (ref replacement for queue.pl job
    launching; SURVEY.md §2.3): ``num_processes`` processes join at
    ``tcp://{coordinator}``, this one as rank ``process_id``, over NCCL
    for the card and gloo for the CPU.  No-op without a coordinator
    (single process)."""
    if not coordinator:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        kids = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*kids) if hasattr(t, "_fields") else type(t)(kids)
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

    def mean(*leaves):
        if all(isinstance(v, int) for v in leaves):
            # an NG state's step count, a host integer: the same in
            # replicas that took the same steps
            return round(sum(leaves) / n)
        return sum(leaves) / n
    return _tree_map(mean, *param_list)


# the once-per-outer-iteration sync of the reference, over a list of
# replicas' parameter sets
average_replicas = average_params

