"""The nnet2 trainer loop (twin of ``kaldi_cnn_tpu/train/trainer.py``).

Mirrors steps/nnet2/train_pnorm_simple.sh / train_convnet_accel2.sh
semantics in one process:
  - exponential learning-rate schedule initial_lr -> final_lr
  - per-epoch train/valid log-prob diagnostics (ref: nnet-compute-prob)
  - per-epoch checkpoints in the JAX package's npz layout
  - final per-component model combination over the last iterates
    (ref: nnet-combine-fast), kept only when it helps

Minibatches go in groups of ``TrainConfig.scan_steps`` through
``Nnet.train_steps``, as the JAX package's loop sends them through its
scanned multi-step jit: on the card a group is replays of CUDA graphs
captured once per shape, on the CPU K eager steps.  A trailing partial
group goes step by step (on the card, one-step graphs), so a run needs
one group shape.  Each step keeps its own learning rate and its
generator on the net's device from (seed, "train_step", step) for the
Dropout components (the JAX package's ``stage_key`` there).  A custom
``step_fn`` (``parallel.dp.make_dp_step``'s signature) takes the
minibatches one at a time, as the JAX loop does.  The objf values stay
on the device until the epoch ends.

``TrainConfig.matmul_precision`` is the JAX package's field: None leaves
the process's float32 matmul and cuDNN settings as they stand (JAX's "no
override" off the TPU); a JAX precision name sets torch's for the
duration of ``train_nnet`` (and of ``multihost.train_multihost``) and
puts them back on every exit (``matmul_precision_scope``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models.components import param_tree
from kaldi_cnn_tpu_torch.models.nnet import Nnet, objf_from_output
from kaldi_cnn_tpu_torch.train.checkpoint import save_checkpoint
from kaldi_cnn_tpu_torch.train.egs import Egs, EgsBatcher

logger = get_logger(__name__)

Params = Dict[str, torch.Tensor]


@configclass
class TrainConfig:
    num_epochs: int = 10
    minibatch_size: int = 512
    initial_learning_rate: float = 0.02
    final_learning_rate: float = 0.002
    combine_num_models: int = 8
    valid_minibatches: int = 10
    checkpoint_dir: str = ""
    seed: int = 0
    # None = the process's float32 matmul / cuDNN settings as they stand;
    # "float32", "tensorfloat32" or "bfloat16" sets them for the training
    # (MATMUL_PRECISIONS)
    matmul_precision: Optional[str] = None
    # run this many sequential steps per dispatch through
    # Nnet.train_steps (the same math as one step at a time); on the
    # card a dispatch is a few CUDA graph replays in place of hundreds of
    # eager launches a step.  1 sends every step alone.
    scan_steps: int = 8


# JAX precision name -> (torch.set_float32_matmul_precision's level, TF32
# for cuDNN's float32 convolutions, which have no bfloat16 pass)
MATMUL_PRECISIONS = {"float32": ("highest", False),
                     "tensorfloat32": ("high", True),
                     "bfloat16": ("medium", True)}


@contextlib.contextmanager
def matmul_precision_scope(cfg: TrainConfig):
    """``cfg.matmul_precision`` in force inside the block (the JAX
    package's ``_matmul_precision_scope``): nothing with None; else the
    float32 matmul precision (which sets
    ``torch.backends.cuda.matmul.allow_tf32`` with it) and
    ``torch.backends.cudnn.allow_tf32``, both put back on any exit.  An
    unknown name raises ValueError."""
    prec = cfg.matmul_precision
    if prec is None:
        yield
        return
    if prec not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision {prec!r}: expected None or one "
                         f"of {sorted(MATMUL_PRECISIONS)}")
    level, cudnn_tf32 = MATMUL_PRECISIONS[prec]
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(level)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def lr_at(cfg: TrainConfig, frac_done: float) -> float:
    """Exponential decay like the reference scripts."""
    return (cfg.initial_learning_rate
            * (cfg.final_learning_rate / cfg.initial_learning_rate)
            ** min(max(frac_done, 0.0), 1.0))


def _params(net: Nnet) -> Params:
    """A detached copy of the net's parameters, by name."""
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def _load(net: Nnet, params: Params) -> None:
    with torch.no_grad():
        for k, v in net.named_parameters():
            v.copy_(params[k])


def _per_component(net: Nnet, params: Params) -> Tuple[Dict, ...]:
    """Name-keyed params -> the JAX pytree layout (per-component dicts,
    nested under "parts" in a SliceParallelComponent)."""
    return tuple(
        param_tree(c, lambda k, _: params[f"components.{i}.{k}"])
        for i, c in enumerate(net.components))


def _valid_objf(net: Nnet, egs: Egs, cfg: TrainConfig) -> float:
    mb = cfg.minibatch_size
    n = min(len(egs), mb * cfg.valid_minibatches)
    tot, cnt = 0.0, 0
    for i in range(0, n, mb):
        x = egs.x[i:i + mb]
        if len(x) < mb:
            break
        o = float(net.objf(torch.as_tensor(x, device=net.device),
                           torch.as_tensor(egs.y[i:i + mb],
                                           device=net.device)))
        tot += o * mb
        cnt += mb
    return tot / max(cnt, 1)


def _valid_batch(net: Nnet, egs_valid: Egs, cfg: TrainConfig):
    mb = min(cfg.minibatch_size * 4, max(len(egs_valid), 1))
    return (torch.as_tensor(egs_valid.x[:mb], device=net.device),
            torch.as_tensor(egs_valid.y[:mb], device=net.device))


def combine_models_per_component(net: Nnet, param_list: List[Params],
                                 egs_valid: Egs, cfg: TrainConfig,
                                 steps: int = 80, lr: float = 0.3,
                                 reg: float = 1e-3) -> Params:
    """Per-component regularized model combination: one softmax weight
    vector over the candidate models PER top-level component (a
    SliceParallelComponent's parts share its weights, as in the JAX
    package), optimized by momentum gradient ascent on validation
    log-prob with an L2 pull toward uniform weights (ref:
    nnet2/nnet-combine-fast.cc).  The gradient is autograd through the
    net with the mixed parameters."""
    if len(param_list) == 1:
        return param_list[0]
    m, c = len(param_list), len(net.components)
    x, y = _valid_batch(net, egs_valid, cfg)
    stacked = {k: torch.stack([p[k] for p in param_list])
               for k in param_list[0]}
    comp = {k: int(k.split(".")[1]) for k in stacked}

    def mix(logits: torch.Tensor) -> Params:
        return {k: torch.tensordot(torch.softmax(logits[:, comp[k]], 0), s,
                                   dims=1) for k, s in stacked.items()}

    def loss(logits: torch.Tensor) -> torch.Tensor:
        out = functional_call(net, mix(logits), (x,))
        return -objf_from_output(out, y) + reg * (logits ** 2).sum()

    logits = torch.zeros((m, c), device=net.device)
    vel = torch.zeros_like(logits)
    for _ in range(steps):
        lg = logits.detach().requires_grad_()
        (g,) = torch.autograd.grad(loss(lg), lg)
        vel = 0.9 * vel - lr * g
        logits = logits + vel
    w = torch.softmax(logits, 0)
    logger.info("combine(per-component): weight range %.3f..%.3f",
                float(w.min()), float(w.max()))
    with torch.no_grad():
        return mix(logits)


def combine_models(net: Nnet, param_list: List[Params], egs_valid: Egs,
                   cfg: TrainConfig, steps: int = 60,
                   lr: float = 0.2) -> Params:
    """Learn a convex combination of whole models on validation egs
    (the coarse variant; combine_models_per_component is the one the
    trainer uses)."""
    if len(param_list) == 1:
        return param_list[0]
    x, y = _valid_batch(net, egs_valid, cfg)
    stacked = {k: torch.stack([p[k] for p in param_list])
               for k in param_list[0]}

    def mix(logits: torch.Tensor) -> Params:
        w = torch.softmax(logits, 0)
        return {k: torch.tensordot(w, s, dims=1) for k, s in stacked.items()}

    logits = torch.zeros(len(param_list), device=net.device)
    for _ in range(steps):
        lg = logits.detach().requires_grad_()
        out = functional_call(net, mix(lg), (x,))
        (g,) = torch.autograd.grad(-objf_from_output(out, y), lg)
        logits = logits - lr * g
    logger.info("combine: weights %s",
                np.round(torch.softmax(logits, 0).cpu().numpy(), 3))
    with torch.no_grad():
        return mix(logits)


def train_nnet(net: Nnet, egs_train: Optional[Egs], egs_valid: Egs,
               cfg: Optional[TrainConfig] = None,
               step_fn: Optional[Callable] = None,
               metrics: Optional[MetricsWriter] = None,
               frames_per_second: float = 100.0, batcher=None) -> Tuple:
    """Initializes ``net`` from ``cfg.seed``, trains it on its device and
    leaves the final parameters in it.  ``step_fn(opt, x, labels, lr,
    weights=None, generator=None) -> (opt', objf)`` replaces the grouped
    ``Nnet.train_steps`` and takes one minibatch at a time (e.g.
    ``parallel.dp.make_dp_step``'s step); ``metrics`` gets a
    "train_epoch" record an epoch (train and valid logprob,
    audio-s/s); ``frames_per_second`` converts frames to audio seconds
    in that rate.  ``batcher`` overrides the in-memory ``EgsBatcher``,
    e.g. a ``train.sharded_egs`` ``StreamingEgsBatcher`` over shards on
    disk (then ``egs_train`` may be None).  Returns (final params in the
    JAX pytree layout, opt state)."""
    cfg = cfg or TrainConfig()
    with matmul_precision_scope(cfg):
        return _train_nnet(net, egs_train, egs_valid, cfg, step_fn, metrics,
                           frames_per_second, batcher)


def _train_nnet(net: Nnet, egs_train: Optional[Egs], egs_valid: Egs,
                cfg: TrainConfig, step_fn: Optional[Callable],
                metrics: Optional[MetricsWriter], frames_per_second: float,
                batcher) -> Tuple:
    net.init(torch_generator(cfg.seed, "init"))
    opt = net.init_opt()
    batcher = batcher or EgsBatcher(egs_train, cfg.minibatch_size, cfg.seed)
    total_iters = cfg.num_epochs * batcher.num_batches()
    dev = net.device
    it = 0
    history: List[Params] = []
    timer = Timer()
    k_scan = max(cfg.scan_steps, 1) if step_fn is None else 1
    for epoch in range(cfg.num_epochs):
        timer.reset()
        it0 = it
        objfs: List[torch.Tensor] = []
        frame_counts: List[float] = []
        pending: List[Tuple] = []

        def flush():
            """The pending minibatches as one group, or one by one when
            they are fewer than a group (the JAX loop's ``flush``)."""
            nonlocal opt, it
            groups = ([pending] if len(pending) >= k_scan
                      else [[b] for b in pending])
            for grp in groups:
                k = len(grp)
                lrs = [lr_at(cfg, (it + j) / max(total_iters - 1, 1))
                       for j in range(k)]
                gens = [torch_generator(cfg.seed, "train_step", it + j, dev)
                        for j in range(k)]
                if step_fn is not None:
                    (x, y, w), = grp
                    opt, objf = step_fn(opt, x, y, lrs[0], weights=w,
                                        generator=gens[0])
                    objf_k = objf.reshape(1)
                else:
                    opt, objf_k = net.train_steps(
                        opt, [b[0] for b in grp], [b[1] for b in grp], lrs,
                        weights=[b[2] for b in grp], generators=gens)
                objfs.append(objf_k)
                frame_counts.extend(float(b[2].sum()) for b in grp)
                it += k
            pending.clear()

        for batch in batcher.epoch(epoch):
            pending.append(batch)
            if len(pending) >= k_scan:
                flush()
        flush()
        # one transfer for the epoch's objf scalars
        objf_host = torch.cat(objfs).cpu().numpy() if objfs else []
        train_prob = (sum(float(o) * n for o, n in zip(objf_host,
                                                        frame_counts))
                      / max(sum(frame_counts), 1))
        valid_prob = _valid_objf(net, egs_valid, cfg)
        elapsed = max(timer.elapsed(), 1e-9)
        audio_ss = ((it - it0) * cfg.minibatch_size / frames_per_second
                    / elapsed)
        logger.info(
            "epoch %d: train logprob %.4f valid %.4f lr %.4g "
            "(%.0f audio-s/s)", epoch, train_prob, valid_prob,
            lr_at(cfg, it / max(total_iters - 1, 1)), audio_ss)
        if metrics:
            metrics.write("train_epoch", epoch=epoch,
                          train_logprob=train_prob,
                          valid_logprob=valid_prob,
                          audio_seconds_per_sec=audio_ss)
        history.append(_params(net))
        if len(history) > cfg.combine_num_models:
            history.pop(0)
        if cfg.checkpoint_dir:
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, f"epoch{epoch}.npz"),
                _per_component(net, history[-1]), opt,
                {"epoch": epoch, "iter": it})
    final = combine_models_per_component(net, history, egs_valid, cfg)
    _load(net, final)
    final_valid = _valid_objf(net, egs_valid, cfg)
    _load(net, history[-1])
    last_valid = _valid_objf(net, egs_valid, cfg)
    if final_valid < last_valid:
        logger.info("combine did not help (%.4f < %.4f); keeping last",
                    final_valid, last_valid)
        final = history[-1]
    _load(net, final)
    logger.info("final valid logprob %.4f", max(final_valid, last_valid))
    params = _per_component(net, final)
    if cfg.checkpoint_dir:
        save_checkpoint(os.path.join(cfg.checkpoint_dir, "final.npz"),
                        params, None, {"final": True})
    return params, opt
