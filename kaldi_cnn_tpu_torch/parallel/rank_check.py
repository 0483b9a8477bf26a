"""Two ranks against world size 1: the data-parallel check that the
card's test (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` share.

Two ranks join a gloo group (on the card: NCCL refuses two ranks on one
GPU, so gloo carries the CUDA tensors) and take ``steps`` steps of the
convnet, either in mode A (each rank half of one minibatch), as two
replicas (each its own half, then one replica average), or as the two
model shards of one data slot (``make_dp_tp_step``: each rank half of
every wide Affine layer's rows, the whole minibatch).  The same steps in
one process give what they must equal: the steps on the whole
minibatch, or the mean of the two halves' streams.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core.mesh import local_slice, make_mesh, shard_batch
from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.ops import maxpool as mp
from kaldi_cnn_tpu_torch.parallel.dp import (ShardedAffineComponent,
                                             average_params, gather_params,
                                             make_dp_step, make_dp_tp_step)
from kaldi_cnn_tpu_torch.parallel.multihost import (make_replica_average,
                                                    run_ranks)

PADDING_ROWS = 7
# the tensor-parallel step against world size 1: the JAX package's own
# bar for its make_dp_tp_step (tests/test_parallel_modes.py)
TP_OBJF_ATOL = 1e-5
TP_RTOL, TP_ATOL = 1e-4, 1e-5


def seeded_case(cfg: ConvnetConfig, seed: int, rows: int):
    """(initial parameters in the JAX layout, x, y, w): the net's seeded
    init with its output affine drawn at random too (its init is zero),
    and one minibatch of ``rows`` rows whose last PADDING_ROWS weigh 0."""
    net = make_convnet(cfg, device="cpu")
    net.init(torch_generator(seed, "dp init"))
    params = [dict(p) for p in params_to_numpy(net)]
    r = np_rng(seed, "dp batch")
    params[-2]["w"] = (r.normal(size=params[-2]["w"].shape) * 0.05).astype(
        np.float32)
    w = np.ones(rows, np.float32)
    w[-PADDING_ROWS:] = 0.0
    return (tuple(params),
            r.normal(size=(rows, net.input_dim)).astype(np.float32),
            r.integers(0, cfg.num_pdfs, rows).astype(np.int32), w)


def _net(cfg, params, device):
    net = make_convnet(cfg, fused=True, device=device)
    params_from_jax(net, params)
    return net


def rank_steps(rank, cfg, params, x, y, w, steps, lr, replicas, device):
    """One of two ranks: ``steps`` mode-A steps on its rows (one
    replica), or, as one of two replicas, ``steps`` steps on its
    replica's half and then the replica average.  Returns (params, objf
    per step, (maxpool forward, backward) kernel launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(replicas, device)
    net = _net(cfg, params, mesh.device)
    if replicas == 1:
        rows = shard_batch(mesh, (x, y, w))
    else:
        i0, i1 = local_slice(len(y), replicas, mesh.replica_index)
        rows = (x[i0:i1], y[i0:i1], w[i0:i1])
    step = make_dp_step(net, mesh)
    before = (mp.maxpool3d.launches, mp.maxpool3d_backward.launches)
    opt, objfs = net.init_opt(), []
    for _ in range(steps):
        opt, objf = step(opt, rows[0], rows[1], lr, rows[2])
        objfs.append(objf)
    if replicas > 1:
        make_replica_average(mesh)(net)
    return (params_to_numpy(net), [float(o) for o in objfs],
            (mp.maxpool3d.launches - before[0],
             mp.maxpool3d_backward.launches - before[1]))


def world_one(cfg, params, x, y, w, steps, lr, device):
    """The same ``steps`` of ``Nnet.train_step`` in this process on all
    of (x, y, w): (params, objf per step)."""
    net = _net(cfg, params, device)
    opt, objfs = net.init_opt(), []
    as_t = lambda a: torch.as_tensor(a, device=device)
    for _ in range(steps):
        opt, objf = net.train_step(opt, as_t(x), as_t(y), lr,
                                   weights=as_t(w))
        objfs.append(objf)
    return params_to_numpy(net), [float(o) for o in objfs]


def two_ranks_vs_one(cfg: ConvnetConfig, case, steps: int, lr: float,
                     replicas: int, device="cuda",
                     timeout_s: float = 300.0) -> Dict:
    """Two ranks (``replicas`` 1: mode A; 2: two replicas and one
    average) against world size 1 on ``case`` (``seeded_case``'s).
    Returns ``ranks_equal`` (the ranks' parameters and objfs bit-equal),
    ``objf_err`` (max |objf - world size 1's| over ranks and steps),
    ``param_rel`` (max over tensors of ||a - b|| / ||b||), ``launches``
    (each rank's (maxpool forward, backward) kernel launches) and
    ``seconds`` (the ranks' run, the spawn included)."""
    params, x, y, w = case
    t = time.perf_counter()
    (p0, o0, l0), (p1, o1, l1) = run_ranks(
        rank_steps, 2, cfg, params, x, y, w, steps, lr, replicas, device,
        timeout_s=timeout_s)
    seconds = time.perf_counter() - t
    if replicas == 1:
        want, objfs = world_one(cfg, params, x, y, w, steps, lr, device)
        objfs = [objfs, objfs]
    else:
        half = len(y) // 2
        streams = [world_one(cfg, params, x[s], y[s], w[s], steps, lr,
                             device)
                   for s in (slice(0, half), slice(half, 2 * half))]
        want = average_params([p for p, _ in streams])
        objfs = [o for _, o in streams]
    same = o0 == o1 if replicas == 1 else True
    same = same and all(np.array_equal(a[k], b[k])
                        for a, b in zip(p0, p1) for k in a)
    objf_err = max(abs(a - b) for o, ref in zip((o0, o1), objfs)
                   for a, b in zip(o, ref, strict=True))
    rel = max(float(np.linalg.norm(a[k] - b[k])
                    / max(np.linalg.norm(b[k]), 1e-30))
              for a, b in zip(p0, want, strict=True) for k in b)
    return {"ranks_equal": bool(same), "objf_err": float(objf_err),
            "param_rel": rel, "launches": (tuple(l0), tuple(l1)),
            "seconds": seconds}



def tp_rank_steps(rank, cfg, params, x, y, w, steps, lr, device):
    """One of the two model shards of one data slot: ``steps``
    tensor-parallel steps on the whole minibatch.  Returns (the whole
    parameters gathered, objf per step, the number of sharded
    layers)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, device, model=2)
    net = _net(cfg, params, mesh.device)
    step = make_dp_tp_step(net, mesh)
    x, y, w = shard_batch(mesh, (x, y, w))
    opt, objfs = net.init_opt(), []
    for _ in range(steps):
        opt, objf = step(opt, x, y, lr, w)
        objfs.append(objf)
    sharded = sum(isinstance(c, ShardedAffineComponent)
                  for c in net.components)
    return gather_params(net), [float(o) for o in objfs], sharded


def tp_two_ranks_vs_one(cfg: ConvnetConfig, case, steps: int, lr: float,
                        device="cuda", timeout_s: float = 300.0) -> Dict:
    """Two ranks as the model shards of one data slot (data 1 x model 2)
    against world size 1 on ``case`` (``seeded_case``'s).  Returns
    ``ranks_equal`` (the gathered parameters and objfs bit-equal),
    ``objf_err`` (max |objf - world size 1's|), ``param_rel`` (max over
    tensors of ||a - b|| / ||b||), ``param_excess`` (max over elements
    of |a - b| - (TP_ATOL + TP_RTOL |b|): <= 0 within the JAX package's
    bar), ``sharded`` (layers split), ``params`` (rank 0's gathered, the
    JAX layout), ``objfs`` and ``seconds``."""
    params, x, y, w = case
    t = time.perf_counter()
    (p0, o0, s0), (p1, o1, _) = run_ranks(
        tp_rank_steps, 2, cfg, params, x, y, w, steps, lr, device,
        timeout_s=timeout_s)
    seconds = time.perf_counter() - t
    want, objfs = world_one(cfg, params, x, y, w, steps, lr, device)
    same = o0 == o1 and all(np.array_equal(a[k], b[k])
                            for a, b in zip(p0, p1) for k in a)
    excess = max(float((np.abs(a[k] - b[k])
                        - (TP_ATOL + TP_RTOL * np.abs(b[k]))).max())
                 for a, b in zip(p0, want, strict=True) for k in b)
    rel = max(float(np.linalg.norm(a[k] - b[k])
                    / max(np.linalg.norm(b[k]), 1e-30))
              for a, b in zip(p0, want, strict=True) for k in b)
    return {"ranks_equal": bool(same),
            "objf_err": max(abs(a - b) for a, b in zip(o0, objfs,
                                                       strict=True)),
            "param_rel": rel, "param_excess": excess, "sharded": s0,
            "params": p0,
            "objfs": o0, "seconds": seconds}
