"""The rank grid and the row-sharding helpers of data-parallel training
(twin of ``kaldi_cnn_tpu/core/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
XLA insert the collectives.  Here the unit is a ``torch.distributed``
rank (one process, one device): ``Mesh`` arranges the world's ranks as
a ("replica", "data", "model") grid, with process groups along each
axis, and every sum over minibatch rows that must span the data axis
goes through ``all_reduce`` or ``reduce_sum`` by hand, as do the
tensor-parallel layers' gathers and sums over the model axis
(``all_gather_cols``; ``parallel/dp.py::make_dp_tp_step``).

``shard_batch`` is this rank's row slice of a global batch, and
``local_slice`` is the JAX package's.  ``data_sharding`` and
``replicated`` name XLA shardings and have no PyTorch counterpart: they
are left out.

A mode-A step over an NCCL group runs inside a CUDA graph
(``models/step_graphs.py``), so what it calls here does no host-to-device
copy and no host read of a device value: ``strided_rows`` takes its
share of the sample by slicing.  ``all_reduce`` counts the collectives
it issues in ``all_reduce.launches``, registered with the kernels'
counts (``ops/common.py``), so that a graph's replay adds the
all-reduces its capture issued.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kaldi_cnn_tpu_torch.ops import common


class Mesh:
    """The ranks of the initialized world as a ("replica", "data",
    "model") grid: rank = (replica_index * shape["data"] + data_index) *
    shape["model"] + model_index.  ``data_group`` joins the ranks of this
    replica at this model index (a mode-A step all-reduces its row sums
    over it), ``replica_group`` the ranks at this (data, model) index in
    every replica (the model average all-reduces over it),
    ``model_group`` the ranks of this (replica, data) cell (a
    tensor-parallel layer's shards; None with ``model=1``, the default,
    which leaves the ("replica", "data") grid as it was), ``world_group``
    every rank.  Every rank must build it, with the same ``num_replicas``
    and ``model``: creating a process group is itself collective."""

    def __init__(self, num_replicas: int = 1, device="cuda",
                 model: int = 1):
        world, rank = dist.get_world_size(), dist.get_rank()
        r, m = max(num_replicas, 1), max(model, 1)
        if world % (r * m):
            raise ValueError(f"{world} ranks not divisible into {r} "
                             f"replicas of {m} model shards")
        d = world // (r * m)
        self.shape = {"replica": r, "data": d, "model": m}
        cell, self.model_index = divmod(rank, m)
        self.replica_index, self.data_index = divmod(cell, d)
        self.device = torch.device(device)
        self.world_group = dist.group.WORLD
        self.data_group = self.replica_group = self.model_group = None
        at = lambda i, j, k: (i * d + j) * m + k
        for i in range(r):
            for k in range(m):
                g = dist.new_group([at(i, j, k) for j in range(d)])
                if (i, k) == (self.replica_index, self.model_index):
                    self.data_group = g
        for j in range(d):
            for k in range(m):
                g = dist.new_group([at(i, j, k) for i in range(r)])
                if (j, k) == (self.data_index, self.model_index):
                    self.replica_group = g
        if m > 1:
            for i in range(r):
                for j in range(d):
                    g = dist.new_group([at(i, j, k) for k in range(m)])
                    if (i, j) == (self.replica_index, self.data_index):
                        self.model_group = g

    @property
    def size(self) -> int:
        return (self.shape["replica"] * self.shape["data"]
                * self.shape["model"])


def make_mesh(num_replicas: int = 1, device="cuda", model: int = 1) -> Mesh:
    """The ("replica", "data", "model") grid over the initialized world."""
    return Mesh(num_replicas, device, model)


def local_slice(n: int, axis_size: int, axis_index: int) -> Tuple[int, int]:
    """[start, end) of this host's slice of a length-n global batch."""
    per = n // axis_size
    return axis_index * per, (axis_index + 1) * per


def shard_batch(mesh: Mesh, batch: Sequence[np.ndarray]) -> List[np.ndarray]:
    """This rank's rows, along the data axis, of each array of a global
    batch whose leading dimension the data axis divides."""
    d = mesh.shape["data"]
    out = []
    for x in batch:
        if len(x) % d:
            raise ValueError(f"a batch of {len(x)} rows does not divide "
                             f"over {d} data ranks")
        i0, i1 = local_slice(len(x), d, mesh.data_index)
        out.append(x[i0:i1])
    return out


@common.counted
def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced in place over ``group``; with no group, ``t``
    unchanged.  Counts the collectives it issues in
    ``all_reduce.launches`` (a CUDA graph's replay adds those it
    captured, ``core/graphs.py``)."""
    if group is None:
        return t
    dist.all_reduce(t, op=op, group=group)
    all_reduce.launches += 1
    return t


def all_gather_cols(y: torch.Tensor, width: int, offset: int, group=None
                    ) -> torch.Tensor:
    """The [N, width] matrix whose columns [offset, offset + y.shape[1])
    this rank holds as ``y`` and the other ranks of ``group`` the rest:
    each rank's columns in zeros, summed over the group in one
    all-reduce (exact: every entry is one rank's value plus zeros; gloo
    carries CUDA tensors through all-reduce but not all-gather).  With
    no group, ``y`` is the whole matrix."""
    if group is None:
        return y
    full = y.new_zeros((y.shape[0], width))
    full[:, offset:offset + y.shape[1]] = y
    return all_reduce(full, group)


def reduce_sum(tensors: Sequence[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` in ONE all-reduce of their f32
    concatenation (the given tensors unchanged with no group)."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    all_reduce(flat, group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def row_span(n_local: int, group=None) -> Tuple[int, int]:
    """(offset of this rank's first row, global row count) of a batch
    split in equal row slices over ``group`` in rank order."""
    if group is None:
        return 0, n_local
    return (dist.get_rank(group) * n_local,
            n_local * dist.get_world_size(group))


def strided_rows(x: torch.Tensor, n: int, count: int, offset: int,
                 group=None) -> torch.Tensor:
    """The deterministic-stride sample of s = min(n, count) rows (0, step,
    2 step, ... with step = max(n // s, 1)) of the global [n, ...] matrix
    whose rows [offset, offset + len(x)) this rank holds as ``x``: this
    rank's share, zero in the rows other ranks own, so that a sum over
    the group (``reduce_sum``) assembles them.  With no group, ``x`` is
    the whole matrix and the sample its strided slice."""
    s = min(n, count)
    step = max(n // s, 1)
    if group is None:
        return x[::step][:s]
    # the sampled rows i * step in [offset, offset + len(x)) are the
    # samples i in [lo, hi): one strided slice of x, no index tensor
    lo = min(s, -(-offset // step))
    hi = min(s, -(-(offset + x.shape[0]) // step))
    out = x.new_zeros((s,) + tuple(x.shape[1:]))
    if hi > lo:
        out[lo:hi] = x[lo * step - offset::step][:hi - lo]
    return out


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank of ``group`` (the default
    world when None and initialized; ``obj`` itself with no world)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
