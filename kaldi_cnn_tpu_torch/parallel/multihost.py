"""Multi-process training driver, the Librispeech-960h configuration
(twin of ``kaldi_cnn_tpu/parallel/multihost.py``; ref:
utils/parallel/queue.pl submitting N jobs + the per-iteration
nnet-am-average barrier, SURVEY.md §2.3).

One process a device, joined in a ``torch.distributed`` process group
(``initialize``: NCCL on the card, gloo on the CPU), utterance lists
sharded per process (``shard_utterances``), and the ranks laid out as a
("replica", "data") grid (``core.mesh.Mesh``):

  - within a replica the global minibatch's rows split over the data
    axis, and each train step all-reduces its sums over rows (mode A,
    ``parallel.dp.make_dp_step``);
  - across replicas the SGD streams are INDEPENDENT, exactly the
    reference's N parallel jobs, synchronized only by a parameter mean
    every ``average_every`` steps (``make_replica_average``, one
    all-reduce over the replica group; ref: nnet-am-average.cc).

With one replica this is mode A over the data axis.  Several replicas
need ``average_every > 0``: unaveraged, each replica would train a model
of its own on its own rows.  The JAX package's ``make_replica_dp_step`` is
``make_dp_step`` here (the mesh's data group is one replica's).  The
step's generator (Dropout's draws) comes from (seed, "mh_step",
step x replicas + replica index), the counterpart of ``_replica_keys``:
the ranks of one replica draw alike, and with one replica it is the
JAX mode-A step's ``stage_key(seed, "mh_step", step)``.

``run_ranks`` starts N ranks on one host, the local stand-in for the
reference's job scheduler, which the tests and the multi-rank check on
the card use.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.core.mesh import (Mesh, all_reduce, local_slice,
                                           shard_batch)
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models.components import param_tree
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.parallel.dp import (initialize_distributed,
                                             make_dp_step)
from kaldi_cnn_tpu_torch.train.egs import Egs, EgsBatcher
from kaldi_cnn_tpu_torch.train.trainer import (TrainConfig, lr_at,
                                               matmul_precision_scope)

logger = get_logger(__name__)


@configclass
class MultihostConfig:
    coordinator: str = ""          # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    average_every: int = 0         # steps between replica averages
    num_replicas: int = 1          # independent SGD streams


# the world group's longest wait in a collective (NCCL's default is 10
# minutes): the Librispeech recipe's ranks wait in one while rank 0
# bootstraps the GMMs
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=60)


def _check_replicas(num_replicas: int, average_every: int) -> None:
    if num_replicas > 1 and average_every <= 0:
        raise ValueError(
            f"{num_replicas} replicas need average_every > 0: unaveraged, "
            "each replica trains a model of its own")


def initialize(cfg: MultihostConfig, device="cuda") -> Mesh:
    """Process-group init + the ("replica", "data") grid over every rank
    (ref replacement for the $cmd scheduler).  The backend follows the
    device: NCCL for the card (the rank's card is ``process_id`` modulo
    the cards of the host unless the device names one), gloo for the
    CPU.  With a coordinator, ``tcp://{coordinator}`` joins
    ``num_processes`` processes; without one, a group of this process
    alone.  An initialized group is taken over if it matches the config
    and the device's backend; anything else raises.

    The world group's collectives wait up to COLLECTIVE_TIMEOUT."""
    _check_replicas(cfg.num_replicas, cfg.average_every)
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device(
                "cuda", cfg.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    world = max(cfg.num_processes, 1)
    if dist.is_initialized():
        if (dist.get_backend() != backend or dist.get_world_size() != world
                or dist.get_rank() != cfg.process_id):
            raise ValueError(
                f"the initialized process group ({dist.get_backend()}, "
                f"rank {dist.get_rank()} of {dist.get_world_size()}) does "
                f"not match {backend} on {device}, rank {cfg.process_id} "
                f"of {world}")
    elif cfg.coordinator:
        initialize_distributed(cfg.coordinator, world, cfg.process_id,
                               device, COLLECTIVE_TIMEOUT)
    elif world > 1:
        raise ValueError(f"{world} processes need a coordinator")
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return Mesh(cfg.num_replicas, device)


def shard_utterances(utts: List[str], cfg: MultihostConfig) -> List[str]:
    """Deterministic per-host utterance shard
    (ref: utils/split_data.sh)."""
    return [u for i, u in enumerate(sorted(utts))
            if i % max(cfg.num_processes, 1) == cfg.process_id]


def make_replica_average(mesh: Mesh) -> Callable[[Nnet], None]:
    """The nnet-am-average point: ``average(net)`` replaces the
    parameters in ``net`` by their mean over the replica group, in one
    all-reduce of their concatenation."""
    r = mesh.shape["replica"]

    def average(net: Nnet) -> None:
        params = list(net.parameters())
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        all_reduce(flat, mesh.replica_group)
        flat /= r
        o = 0
        with torch.no_grad():
            for p in params:
                p.copy_(flat[o:o + p.numel()].reshape(p.shape))
                o += p.numel()

    return average


def _broadcast_opt(opt, src: int, group):
    """Rank ``src``'s NG states (tensors in place) on every rank of
    ``group``."""
    for leaf in opt:
        if "parts" in leaf:
            _broadcast_opt(leaf["parts"], src, group)
            continue
        for state in leaf.values():
            for t in (state.u, state.d, state.rho):
                dist.broadcast(t, src=src, group=group)
    return opt


def train_multihost(
    net: Nnet,
    egs_train: Optional[Egs],
    egs_valid: Egs,
    cfg: Optional[TrainConfig] = None,
    mh: Optional[MultihostConfig] = None,
    mesh: Optional[Mesh] = None,
    metrics: Optional[MetricsWriter] = None,
    batcher=None,
    local_batches: bool = False,
):
    """Training over the rank grid.  One replica is one globally
    synchronous stream (mode A); several run the reference's semantics,
    independent streams + a parameter average every ``average_every``
    steps (which must then be > 0).  ``net`` lives on ``mesh.device``; it is
    initialized from ``cfg.seed`` on every rank alike, as ``train_nnet``
    does, and holds the final parameters, equal on every rank.

    Batches: by default ``batcher`` (or an ``EgsBatcher`` over
    ``egs_train``) yields GLOBAL minibatches, the same on every rank,
    and each rank takes its rows of its replica's part (the JAX
    package's layout).  With ``local_batches`` it yields this rank's own
    rows (a rank's own store of egs): every rank then runs the fewest
    steps an epoch that any rank's batcher has.

    The per-step objf stays on the device and is read once an epoch.
    ``cfg.matmul_precision`` is in force for the whole training
    (``trainer.matmul_precision_scope``).  Returns (params in the JAX
    pytree layout, replica 0's NG states)."""
    cfg = cfg or TrainConfig()
    mh = mh or MultihostConfig()
    mesh = mesh or initialize(mh, net.device)
    with matmul_precision_scope(cfg):
        return _train_multihost(net, egs_train, cfg, mh, mesh, metrics,
                                batcher, local_batches)


def _train_multihost(net, egs_train, cfg, mh, mesh, metrics, batcher,
                     local_batches):
    r = mesh.shape["replica"]
    _check_replicas(r, mh.average_every)
    replica_mode = r > 1
    net.init(torch_generator(cfg.seed, "init"))
    opt = net.init_opt()
    step = make_dp_step(net, mesh)
    average = make_replica_average(mesh) if replica_mode else None
    batcher = batcher or EgsBatcher(egs_train, cfg.minibatch_size,
                                    cfg.seed)
    steps = batcher.num_batches()
    if local_batches:
        t = torch.tensor([steps], device=mesh.device)
        steps = int(all_reduce(t, mesh.world_group, dist.ReduceOp.MIN))
    total = cfg.num_epochs * steps
    it = 0
    timer = Timer()
    # (the JAX driver throttles XLA:CPU to one step in flight, for its
    # collectives' rendezvous timeout; torch.distributed needs nothing
    # of the kind)
    for epoch in range(cfg.num_epochs):
        objfs, frames = [], []
        for b, (x, y, w) in enumerate(batcher.epoch(epoch)):
            if b == steps:
                break
            lr = lr_at(cfg, it / max(total - 1, 1))
            if not local_batches:
                if replica_mode:
                    i0, i1 = local_slice(len(y) - len(y) % r, r,
                                         mesh.replica_index)
                    x, y, w = x[i0:i1], y[i0:i1], w[i0:i1]
                x, y, w = shard_batch(mesh, (x, y, w))
            gen = torch_generator(cfg.seed, "mh_step",
                                  it * r + mesh.replica_index, mesh.device)
            opt, objf = step(opt, x, y, lr, w, gen)
            objfs.append(objf)
            frames.append(float(w.sum()))
            it += 1
            # the average runs between steps, eagerly (on the card, between
            # graph replays): it writes the parameters in place, so the
            # step graphs' addresses hold
            if replica_mode and it % mh.average_every == 0:
                average(net)
        # one read an epoch: the frame-weighted objf over every rank
        tot = torch.stack([
            (torch.stack(objfs) * torch.tensor(frames, device=mesh.device)
             ).sum(), torch.tensor(float(sum(frames)), device=mesh.device)])
        tot = all_reduce(tot, mesh.world_group).cpu().numpy()
        train_prob = float(tot[0]) / max(float(tot[1]), 1.0)
        audio_ss = (it * cfg.minibatch_size / 100.0) / max(timer.elapsed(),
                                                          1e-9)
        logger.info("mh epoch %d: train logprob %.4f (%.2f audio-s/s, "
                    "%d ranks, %d replicas)", epoch, train_prob, audio_ss,
                    mesh.size, r)
        if metrics:
            metrics.write("mh_epoch", epoch=epoch,
                          train_logprob=train_prob,
                          audio_seconds_per_sec=audio_ss)
    if replica_mode:
        average(net)
        # in place, into the states the last step handed back (copies of
        # the step graphs' storage on the card)
        opt = _broadcast_opt(opt, mesh.data_index, mesh.replica_group)
    params = tuple(param_tree(c, lambda _, t: t.detach().clone())
                   for c in net.components)
    return params, opt


def _rank_main(rank: int, fn, args, world: int, backend: str, tmp: str,
               timeout_s: float) -> None:
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, num_processes: int, *args,
              backend: str = "gloo", timeout_s: float = 600.0) -> List:
    """``fn(rank, *args)`` in ``num_processes`` spawned processes joined in
    one ``backend`` process group (a file rendezvous in a temporary
    directory: no port); returns their results in rank order.  ``fn``
    must be importable (defined at module level) and its result
    picklable.  A rank's exception is raised here and stops the others;
    so does the time limit.  Every process started is ended."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="kct_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, num_processes, backend, tmp,
                              timeout_s),
            nprocs=num_processes, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{num_processes} ranks of "
                                       f"{fn.__name__} ran over "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(num_processes):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

