"""Data-parallel checks that the card's tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` share: two ranks
against world size 1, and ``train_multihost`` over an NCCL group of one
through the step's CUDA graphs against the same training run eagerly
(``nccl_graphs_vs_eager``), and mode B's R replicas in one process
through the graphs against the same steps run eagerly
(``replicas_graphs_vs_eager``).

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

import contextlib
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core import mesh as mesh_ops
from kaldi_cnn_tpu_torch.core.mesh import local_slice, make_mesh, shard_batch
from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.models.step_graphs import ng_states
from kaldi_cnn_tpu_torch.ops import maxpool as mp
from kaldi_cnn_tpu_torch.parallel.dp import (ShardedAffineComponent,
                                             average_params,
                                             average_replicas, gather_params,
                                             make_dp_step, make_dp_tp_step,
                                             make_replica_step,
                                             stack_replicas)
from kaldi_cnn_tpu_torch.parallel.multihost import (MultihostConfig,
                                                    initialize,
                                                    make_replica_average,
                                                    run_ranks,
                                                    train_multihost)
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig

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


@contextlib.contextmanager
def counted_eager_calls(swap: bool):
    """Counts the calls of ``Nnet._train_steps_eager``, the eager loop of
    ``train_step``; with ``swap``, ``Nnet.train_steps`` is that loop (the
    graphs' reference; there is no public switch).  Yields the list
    that counts them."""
    steps, eager = Nnet.train_steps, Nnet._train_steps_eager
    calls = []

    def counting(self, *args, **kwargs):
        calls.append(1)
        return eager(self, *args, **kwargs)

    Nnet._train_steps_eager = counting
    if swap:
        Nnet.train_steps = counting
    try:
        yield calls
    finally:
        Nnet.train_steps, Nnet._train_steps_eager = steps, eager


@contextlib.contextmanager
def timed_steps(marks):
    """Wraps ``Nnet.train_steps``: records each call's objf, and the card
    synchronized and the clock and the net's capture seconds read at the
    call of each step count in ``marks`` (the first NG state's ``t``);
    yields (objfs, {mark: (seconds, capture seconds)})."""
    steps = Nnet.train_steps
    objfs, at = [], {}

    def recording(self, opt, *args, **kwargs):
        t = ng_states(opt)[0][1].t
        if t in marks:
            torch.cuda.synchronize()
            at[t] = (time.perf_counter(),
                     sum(self.capture_seconds.values()))
        out = steps(self, opt, *args, **kwargs)
        objfs.append(out[1])
        return out

    Nnet.train_steps = recording
    try:
        yield objfs, at
    finally:
        Nnet.train_steps = steps


def _counts():
    return np.array([mesh_ops.all_reduce.launches,
                     mesh_ops.all_reduce.warmup_launches,
                     mp.maxpool3d.launches, mp.maxpool3d.warmup_launches,
                     mp.maxpool3d_backward.launches,
                     mp.maxpool3d_backward.warmup_launches])


def nccl_graphs_vs_eager(cfg: ConvnetConfig, steps: int = 112,
                         rows: int = 256, lr: float = 0.08, seed: int = 5,
                         device="cuda") -> Dict:
    """``train_multihost`` (mode A) over an NCCL process group of this
    process alone, twice on the same seeded rows under deterministic
    cuDNN: through the dp step's CUDA graphs, and with the steps run
    eagerly.  ``steps`` minibatches of ``rows`` rows in
    two epochs; the net's NG warm-up refreshes every step below 64, then
    every ``update_period``-th.  Starts (and then ends) the group unless
    one is initialized.  The eager run counts every step in the eager
    loop (``counted_eager_calls``), the graphed run none.

    Returns ``same`` ({what: bit-equal?} for the objfs, parameters and
    NG states), ``refreshes`` (steps whose NG states refresh, and of
    them after the warm-up), per run (``graphed`` / ``eager``): seconds
    of ``train_multihost``, ``ms_warmup`` / ``ms_steady`` (ms a step
    over steps [0, 64) and [64, steps), the captures taken out),
    ``all_reduces`` and ``maxpool`` ((forward, backward)) counted in the
    run less those of graph warm-ups, ``warmup`` (the warm-ups'
    all-reduces and maxpool launches), ``eager_calls``; and the graphed
    net's ``captures`` ({key: seconds})."""
    warm = 64
    half = steps // 2
    r = np_rng(seed, "nccl graphs")
    net0 = make_convnet(cfg, device="cpu")
    n = half * rows                      # a batch a step in each epoch
    x = r.normal(size=(n, net0.input_dim)).astype(np.float32)
    y = r.integers(0, cfg.num_pdfs, n).astype(np.int32)
    w = np.ones(n, np.float32)
    w[rows - 9:rows] = 0.0               # 9 rows of zero weight
    valid = Egs(x[:rows], y[:rows], w[:rows])
    tcfg = TrainConfig(num_epochs=2, minibatch_size=rows,
                       initial_learning_rate=lr,
                       final_learning_rate=lr / 10, seed=seed)
    own = not dist.is_initialized()
    mesh = initialize(MultihostConfig(), device)
    if dist.get_backend(mesh.data_group) != "nccl":
        raise ValueError("the data group is not an NCCL group")
    runs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("graphed", "eager"):
            net = make_convnet(cfg, fused=True, device=mesh.device)
            before = _counts()
            with counted_eager_calls(mode == "eager") as eager_calls, \
                    timed_steps({0, warm}) as (objfs, at):
                params, opt = train_multihost(net, Egs(x, y, w), valid,
                                              tcfg, mesh=mesh)
                torch.cuda.synchronize()
                end = (time.perf_counter(),
                       sum(net.capture_seconds.values()))
            c = _counts() - before
            (t0, c0), (t1, c1) = at[0], at[warm]
            runs[mode] = {
                "seconds": end[0] - t0,
                "ms_warmup": 1e3 * (t1 - t0 - (c1 - c0)) / warm,
                "ms_steady": 1e3 * (end[0] - t1 - (end[1] - c1))
                / (steps - warm),
                "all_reduces": int(c[0] - c[1]),
                "maxpool": (int(c[2] - c[3]), int(c[4] - c[5])),
                "warmup": {"all_reduces": int(c[1]),
                           "maxpool": (int(c[3]), int(c[5]))},
                "eager_calls": len(eager_calls),
                "objfs": torch.cat([o.reshape(-1) for o in objfs]).cpu(),
                "params": [t.cpu() for d in params for t in d.values()],
                "states": [(s.t, s.u.cpu(), s.d.cpu(), s.rho.cpu())
                           for _, s in ng_states(opt)],
                "captures": net.capture_seconds,
                "graphs": 0 if net._step_graphs is None
                else len(net._step_graphs.graphs)}
    finally:
        torch.backends.cudnn.deterministic = saved
        if own:
            dist.destroy_process_group()
    g, e = runs["graphed"], runs["eager"]
    same = {
        "objfs": torch.equal(g["objfs"], e["objfs"]),
        "parameters": all(torch.equal(a, b)
                          for a, b in zip(g["params"], e["params"])),
        "NG states": all(a[0] == b[0] and all(torch.equal(u, v) for u, v
                                                in zip(a[1:], b[1:]))
                         for a, b in zip(g["states"], e["states"]))}
    period = net0.ng_in.update_period
    refresh = [t for t in range(steps) if t < warm or t % period == 0]
    return {"same": same, "steps": steps, "rows": rows,
            "refreshes": (len(refresh), sum(t >= warm for t in refresh)),
            "graphed": {k: v for k, v in g.items()
                        if k not in ("objfs", "params", "states")},
            "eager": {k: v for k, v in e.items()
                      if k not in ("objfs", "params", "states",
                                   "captures")},
            "objf": (float(g["objfs"][0]), float(g["objfs"][-1]))}


def replicas_graphs_vs_eager(cfg: ConvnetConfig, replicas: int = 4,
                             steps: int = 8, rows: int = 256,
                             lr: float = 0.08, seed: int = 5,
                             device="cuda") -> Dict:
    """Mode B in one process (``make_replica_step``): ``replicas``
    streams of the net from ``seeded_case``'s parameters, each on rows
    of its own, ``steps`` steps of ``rows`` rows, twice under
    deterministic cuDNN: through the step's CUDA graphs and eagerly
    (``train_step`` a replica).  The first steps are in the NG warm-up,
    so every step refreshes the NG states (cut around its eighs in the
    graphs).  Then the replicas are averaged (``average_replicas``).

    Returns ``same`` ({what: bit-equal?} for the objfs, parameters and
    NG states of every replica), ``diverged`` (every replica's
    parameters differ from replica 0's), ``averaged_equal`` (the
    averaged replicas are one model), per run the ms of each R-step
    (host clock, the card synchronized; the graphed run's first
    includes its captures), ``maxpool`` ((forward, backward) launches
    in the run, warm-ups included) and ``warmup`` (the warm-ups'), and
    the graphed net's ``captures`` ({key: seconds})."""
    params, _, _, _ = seeded_case(cfg, seed, rows)
    r = np_rng(seed, "replica batches")
    d = make_convnet(cfg, device="cpu").input_dim
    x = r.normal(size=(steps, replicas, rows, d)).astype(np.float32)
    y = r.integers(0, cfg.num_pdfs, (steps, replicas, rows)).astype(np.int32)
    runs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("graphed", "eager"):
            net = _net(cfg, params, device)
            step = make_replica_step(net, None, replicas,
                                     eager=mode == "eager")
            p_r = stack_replicas(params, replicas)
            o_r = stack_replicas(net.init_opt(), replicas)
            before = _counts()
            ms, objfs = [], []
            for k in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                p_r, o_r, objf = step(p_r, o_r, x[k], y[k], lr)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                objfs.append(objf.cpu())
            c = _counts() - before
            avg = stack_replicas(average_replicas(p_r), replicas)
            runs[mode] = {
                "ms": ms, "maxpool": (int(c[2]), int(c[4])),
                "warmup": (int(c[3]), int(c[5])),
                "objfs": torch.stack(objfs),
                "params": [[t.cpu() for d_ in p for t in d_.values()]
                           for p in p_r],
                "states": [[(s.t, s.u.cpu(), s.d.cpu(), s.rho.cpu())
                            for _, s in ng_states(o)] for o in o_r],
                "avg": [[t.cpu() for d_ in p for t in d_.values()]
                        for p in avg],
                "captures": net.capture_seconds}
    finally:
        torch.backends.cudnn.deterministic = saved
    g, e = runs["graphed"], runs["eager"]
    eq = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b,
                                                             strict=True))
    same = {
        "objfs": torch.equal(g["objfs"], e["objfs"]),
        "parameters": all(eq(a, b) for a, b in zip(g["params"],
                                                   e["params"])),
        "NG states": all(sa[0] == sb[0] and eq(sa[1:], sb[1:])
                         for a, b in zip(g["states"], e["states"])
                         for sa, sb in zip(a, b, strict=True))}
    p = g["params"]
    return {"same": same, "replicas": replicas, "steps": steps,
            "rows": rows,
            "diverged": all(not eq(p[0], p[i]) for i in range(1, replicas)),
            "averaged_equal": all(eq(g["avg"][0], g["avg"][i])
                                  for i in range(1, replicas)),
            "graphed": {k: g[k] for k in ("ms", "maxpool", "warmup",
                                          "captures")},
            "eager": {k: e[k] for k in ("ms", "maxpool", "warmup")},
            "objf": (float(g["objfs"][0].mean()),
                     float(g["objfs"][-1].mean()))}
