"""The rank grid and the row-sharding helpers of data-parallel training
(twin of ``kaldi_cnn_tpu/core/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
XLA insert the collectives.  Here the unit is a ``torch.distributed``
rank (one process, one device): ``Mesh`` arranges the world's ranks as
a ("replica", "data") grid, with one process group per replica for the
data axis and one per data index for the replica axis, and every sum
over minibatch rows that must span the data axis goes through
``all_reduce`` or ``reduce_sum`` by hand.

``shard_batch`` is this rank's row slice of a global batch, and
``local_slice`` is the JAX package's.  ``data_sharding`` and
``replicated`` name XLA shardings and have no PyTorch counterpart: they
are left out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """The ranks of the initialized world as a ("replica", "data") grid,
    the only axes there are: rank = replica_index * shape["data"] +
    data_index.  ``data_group`` joins this rank's replica (a mode-A step
    all-reduces over it), ``replica_group`` the ranks at its data index
    in every replica (the model average all-reduces over it),
    ``world_group`` every rank.
    Every rank must build it, with the same ``num_replicas``: creating a
    process group is itself collective."""

    def __init__(self, num_replicas: int = 1, device="cuda"):
        world, rank = dist.get_world_size(), dist.get_rank()
        r = max(num_replicas, 1)
        if world % r:
            raise ValueError(f"{world} ranks not divisible into {r} "
                             "replicas")
        d = world // r
        self.shape = {"replica": r, "data": d}
        self.replica_index, self.data_index = divmod(rank, d)
        self.device = torch.device(device)
        self.world_group = dist.group.WORLD
        self.data_group = self.replica_group = None
        for i in range(r):
            g = dist.new_group([i * d + j for j in range(d)])
            if i == self.replica_index:
                self.data_group = g
        for j in range(d):
            g = dist.new_group([i * d + j for i in range(r)])
            if j == self.data_index:
                self.replica_group = g

    @property
    def size(self) -> int:
        return self.shape["replica"] * self.shape["data"]


def make_mesh(num_replicas: int = 1, device="cuda") -> Mesh:
    """The ("replica", "data") grid over the initialized world."""
    return Mesh(num_replicas, device)


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


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced in place over ``group``; with no group, ``t``
    unchanged.  Counts the collectives it issues in
    ``all_reduce.launches``."""
    if group is None:
        return t
    dist.all_reduce(t, op=op, group=group)
    all_reduce.launches += 1
    return t


all_reduce.launches = 0


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
    rows = np.arange(s) * step
    mine = (rows >= offset) & (rows < offset + x.shape[0])
    out = x.new_zeros((len(rows),) + tuple(x.shape[1:]))
    if mine.any():
        out[torch.as_tensor(np.flatnonzero(mine), device=x.device)] = x[
            torch.as_tensor(rows[mine] - offset, device=x.device)]
    return out


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank of ``group`` (the default
    world when None and initialized; ``obj`` itself with no world)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
