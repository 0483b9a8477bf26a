"""Nnet = ordered component list + the minibatch train step; AmNnet =
Nnet + pdf priors.

Twin of ``kaldi_cnn_tpu/models/nnet.py``: ``Nnet.forward`` (unfused
eval), ``Nnet.predict`` with the fused conv+maxpool pair (also inside the
Switchboard CNN's pair of slices), the train step
(``train_forward`` -> objective derivative -> ``_backward_update``, the
reference's NnetUpdater::ComputeForMinibatch), the MMI step
(``discriminative_step``: the same walk from the numerator minus
denominator occupancies; on the card a replay of a graph per shape, as
the JAX package jits it per shape), ``objf``, and ``AmNnet`` with
``loglikes``/``loglikes_batch``
(ref: src/nnet2/nnet-nnet.cc, nnet-update.cc,
nnet-compute-discriminative.cc, am-nnet.cc, decodable-am-nnet.cc).

The backprop is the components' own, by hand, under ``torch.no_grad``;
the parameters live in the modules and each step updates them in place.
The train step's objf comes back as a device scalar, so a training loop
need not wait for the card at every step.  ``train_steps`` runs K steps
in order (the JAX package's ``lax.scan`` of ``train_step``): on the card
as replays of CUDA graphs captured once per shape
(``models/step_graphs.py``), on the CPU as K eager steps.  Given a
process ``group``, the train step is the data-parallel (mode A) step: ``x`` is this rank's row slice of
the global minibatch, the objective's sums and every update's row sums
span the group, and each rank computes the single-process step of the
global minibatch.  A ``generator`` (``torch.Generator`` on the rows'
device) feeds the Dropout components; without one they pass their
input through.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from kaldi_cnn_tpu_torch.core.mesh import reduce_sum
from kaldi_cnn_tpu_torch.models.components import (
    Conv2DComponent, DropoutComponent, IdentityComponent,
    Maxpooling3DComponent, SliceParallelComponent)
from kaldi_cnn_tpu_torch.models.ng_sgd import OnlineNaturalGradient
from kaldi_cnn_tpu_torch.models.step_graphs import (StepGraphs,
                                                   replays_collectives)
from kaldi_cnn_tpu_torch.ops.common import round_up
from kaldi_cnn_tpu_torch.ops.conv import conv2d_maxpool


def _fusable(c, nxt) -> bool:
    return (isinstance(c, Conv2DComponent) and c.fused
            and isinstance(nxt, Maxpooling3DComponent)
            and nxt.pool_c == 1
            and c.stride_t == 1 and c.stride_f == 1
            and nxt.in_t == c.out_t and nxt.in_f == c.out_f
            and nxt.in_c == c.num_filters
            and c.out_t % nxt.pool_t == 0
            and c.out_f % nxt.pool_f == 0)


def _fusable_slices(c, nxt) -> bool:
    """SliceParallel(Conv2D, Identity(d)) -> SliceParallel(Maxpool3D,
    Identity(d)) around a fusable conv/pool pair: the Switchboard CNN's
    front end, whose iVector columns pass both slices unchanged."""
    if not (isinstance(c, SliceParallelComponent)
            and isinstance(nxt, SliceParallelComponent)
            and len(c.parts) == 2 and len(nxt.parts) == 2):
        return False
    (conv, iv), (pool, iv2) = c.parts, nxt.parts
    return (isinstance(iv, IdentityComponent)
            and isinstance(iv2, IdentityComponent) and iv.dim == iv2.dim
            and _fusable(conv, pool))


def _storage_dtype(dt) -> torch.dtype:
    """The train step's activation dtype: None (float32 on every device,
    as the JAX package off the TPU), float32 or bfloat16."""
    if dt is None or dt in (torch.float32, "float32", "f32"):
        return torch.float32
    if dt in (torch.bfloat16, "bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"train_storage_dtype={dt!r} unsupported; use None, "
                     "'float32'/'f32', or 'bfloat16'/'bf16'")


def _group_lrs(lrs, k_steps: int) -> np.ndarray:
    """One float32 learning rate a step, from K of them or one for all."""
    if isinstance(lrs, torch.Tensor):
        lrs = lrs.cpu().numpy()
    return np.broadcast_to(np.asarray(lrs, np.float32), (k_steps,))


def objf_from_output(out: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Weighted mean log-probability of the labels (ref:
    nnet-compute-prob); differentiable in ``out``."""
    post = torch.clamp_min(out.to(torch.float32), 1e-20)
    picked = post.gather(1, labels.long()[:, None])[:, 0]
    if weights is None:
        return torch.log(picked).mean()
    return (torch.log(picked) * weights).sum() / weights.sum()


class Nnet(nn.Module):
    def __init__(self, components: Sequence[nn.Module],
                 ng_rank_in: int = 20, ng_rank_out: int = 80,
                 ng_update_period: int = 16,
                 train_storage_dtype=None):
        super().__init__()
        self.components = nn.ModuleList(components)
        # ranks and update period as the JAX package (the reference's
        # --precondition-rank-in 20 --precondition-rank-out 80)
        self.ng_in = OnlineNaturalGradient(rank=ng_rank_in,
                                           update_period=ng_update_period)
        self.ng_out = OnlineNaturalGradient(rank=ng_rank_out,
                                            update_period=ng_update_period)
        # dtype the TRAIN step stores activations and derivatives in
        # between components; cross-row reductions accumulate in f32
        self.train_storage_dtype = train_storage_dtype
        # train_steps' CUDA graphs, made at its first call on the card
        self._step_graphs: Optional[StepGraphs] = None

    @property
    def input_dim(self) -> int:
        for c in self.components:
            d = getattr(c, "input_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    @property
    def output_dim(self) -> int:
        for c in reversed(self.components):
            d = getattr(c, "output_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.parameters(),
                                    self.buffers())).device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Nnet":
        for c in self.components:
            c.init(generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Unfused eval forward through every component.  It records no
        graph unless a parameter requires a gradient (the model
        combination calls it through ``torch.func.functional_call``)."""
        for c in self.components:
            x = c(x)
        return x

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Inference forward.  Adjacent Conv2D(fused=True) +
        Maxpooling3D(pool_c=1) pairs run as ONE fused conv+maxpool kernel
        (ops.conv.conv2d_maxpool, bf16 operands with f32 accumulation as
        in the Pallas default), and so does such a pair inside adjacent
        slices with equal Identity widths beside it (the volume columns
        go to the kernel as a contiguous copy, the iVector columns pass
        unchanged); everything else runs unfused.  The JAX package fuses
        only the top-level pair."""
        comps = self.components
        i = 0
        while i < len(comps):
            c = comps[i]
            nxt = comps[i + 1] if i + 1 < len(comps) else None
            if _fusable(c, nxt):
                x = conv2d_maxpool(x, c.w, c.b, c, nxt.pool_t, nxt.pool_f)
                i += 2
                continue
            if _fusable_slices(c, nxt):
                conv, pool = c.parts[0], nxt.parts[0]
                d = conv.input_dim
                y = conv2d_maxpool(x[:, :d].contiguous(), conv.w, conv.b,
                                   conv, pool.pool_t, pool.pool_f)
                x = torch.cat([y, x[:, d:].to(y.dtype)], dim=1)
                i += 2
                continue
            x = c(x)
            i += 1
        return x

    # -- training ------------------------------------------------------------
    def init_opt(self) -> Tuple:
        """Per-component NG states ({} for a component not trained)."""
        return tuple(c.init_opt(self.ng_in, self.ng_out) if c.trainable
                     else {} for c in self.components)

    @torch.no_grad()
    def train_forward(self, x: torch.Tensor, store_dtype=torch.float32,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        """(output, activations, auxs); activations[i] is the input of
        component i, each stored in ``store_dtype`` and consumed as
        stored, so backprop's in/out pairs stay self-consistent.
        ``generator`` and ``group`` go to each component (Dropout draws
        from the one generator, component by component in order)."""
        acts = [x.to(store_dtype)]
        auxs = []
        for c in self.components:
            y, aux = c.train_forward(acts[-1], generator, group)
            acts.append(y.to(store_dtype))
            auxs.append(aux)
        return acts[-1], acts, auxs

    @torch.no_grad()
    def _backward_update(self, opt, acts, auxs, out_deriv, lr,
                         store_dtype=torch.float32, group=None) -> Tuple:
        """Backward walk from the derivative at the network output with
        the NG-SGD update of every trainable component (the reference's
        NnetUpdater::Backprop).  A component's backprop runs before its
        update, so it sees the old parameters, as in the JAX package."""
        new_opt = list(opt)
        deriv = out_deriv.to(store_dtype)
        for i in range(len(self.components) - 1, -1, -1):
            c = self.components[i]
            in_deriv = (c.backprop(acts[i], acts[i + 1], deriv, auxs[i])
                        if i > 0 else None)
            if c.trainable:
                new_opt[i] = c.update(opt[i], acts[i], deriv, lr,
                                      self.ng_in, self.ng_out, group)
            if in_deriv is not None:
                deriv = in_deriv.to(store_dtype)
        return tuple(new_opt)

    @torch.no_grad()
    def train_step(self, opt, x: torch.Tensor, labels: torch.Tensor,
                   lr: float, weights: Optional[torch.Tensor] = None,
                   group=None, generator: Optional[torch.Generator] = None):
        """One minibatch update of the parameters in place.  x [N, D],
        labels [N] int, optional weights [N]; with a process ``group``,
        this rank's rows of the group's minibatch.  Returns (opt', objf
        per frame as a device scalar)."""
        sd = _storage_dtype(self.train_storage_dtype)
        out, acts, auxs = self.train_forward(x, sd, generator, group)
        if weights is None:
            weights = torch.ones(x.shape[0], device=x.device)
        post = torch.clamp_min(out.to(torch.float32), 1e-20)
        picked = post.gather(1, labels.long()[:, None])[:, 0]
        num, wsum = reduce_sum([(torch.log(picked) * weights).sum(),
                                weights.sum()], group)
        wsum = torch.clamp_min(wsum, 1e-8)
        objf = num / wsum
        # derivative of sum_n w_n log out[n, label_n] / wsum wrt out
        out_deriv = torch.zeros_like(post).scatter_(
            1, labels.long()[:, None], (weights / wsum / picked)[:, None])
        return self._backward_update(opt, acts, auxs, out_deriv, lr,
                                     sd, group), objf

    def train_steps(self, opt, xs, labels, lrs, weights=None,
                    generators: Optional[Sequence[torch.Generator]] = None,
                    group=None):
        """K minibatch updates in order, the semantics of K
        ``train_step`` calls (the JAX package's ``train_steps``, K steps
        under one jit through ``lax.scan``).  xs [K, N, D] f32, labels
        [K, N] int, lrs [K] (or one lr for all), weights [K, N] or None
        for ones: arrays, tensors, or sequences of K per-step arrays;
        ``generators``: K generators on the net's device, one a step, for
        the Dropout components; ``group``: the process group of a mode-A
        data-parallel step (``train_step``'s).  Returns (opt', objf per
        step [K] as a device tensor).

        On a CUDA net each step is a replay of a CUDA graph captured once
        per shape, slot in the group and NG gates
        (``models/step_graphs.py``): the inputs cross in one copy, and
        the NG states are copied into the net's fixed storage and the
        returned ones out of it, so that any earlier ``opt`` may be
        handed in again, as on the CPU.  A group's all-reduces are
        captured in the graphs when it is an NCCL group; over a gloo
        group, whose collectives run on the host and cannot be captured,
        the steps run eagerly (``step_graphs.replays_collectives``).  A
        capture or replay that fails raises.  On the CPU it is the eager
        loop of ``train_step``."""
        if self.device.type != "cuda" or not replays_collectives(group):
            return self._train_steps_eager(opt, xs, labels, lrs, weights,
                                           generators, group)
        lrs = _group_lrs(lrs, len(xs))
        if weights is None:
            weights = np.ones((len(xs), len(labels[0])), np.float32)
        if self._step_graphs is None:
            self._step_graphs = StepGraphs(self)
        return self._step_graphs.run(
            opt, xs, labels, lrs, weights, generators,
            _storage_dtype(self.train_storage_dtype), group)

    def _train_steps_eager(self, opt, xs, labels, lrs, weights=None,
                           generators=None, group=None):
        """``train_steps`` as K eager ``train_step`` calls on the net's
        device (the plain version of the graphs)."""
        dev = self.device
        lrs = _group_lrs(lrs, len(xs))
        objfs = []
        for k in range(len(xs)):
            opt, objf = self.train_step(
                opt, torch.as_tensor(xs[k], device=dev),
                torch.as_tensor(labels[k], device=dev), float(lrs[k]),
                weights=(None if weights is None
                         else torch.as_tensor(weights[k], device=dev)),
                group=group,
                generator=None if generators is None else generators[k])
            objfs.append(objf)
        return opt, torch.stack(objfs)

    @property
    def capture_seconds(self) -> Dict[tuple, float]:
        """Seconds of each train-step graph's capture on the card:
        ("step", K, rows, slot k, whether it refreshes) and ("tail",
        rows)."""
        sg = getattr(self, "_step_graphs", None)
        return {} if sg is None else sg.capture_seconds

    def draws_masks(self) -> bool:
        """Whether a train step with a generator draws Dropout masks."""
        return any(isinstance(m, DropoutComponent) and m.proportion > 0
                   for m in self.modules())

    def discriminative_step(self, opt, x, num_post, den_post, lr: float,
                            generator: Optional[torch.Generator] = None,
                            group=None):
        """Lattice-based sequence-discriminative (MMI) update of the
        parameters in place (ref: nnet2/nnet-compute-discriminative.cc,
        MMI case).  x [N, D]; num_post/den_post [N, P]: numerator and
        denominator occupancies of x's rows (arrays or tensors); with a
        process ``group``, this rank's rows of the group's minibatch.
        Returns (opt', MMI objf per frame as a device scalar).

        On a CUDA net (with no group or an NCCL one) the step is a replay
        of a CUDA graph captured once per (rows, width, pdfs, NG gates,
        storage dtype, flags), as the JAX package jits it once per shape
        (``models/step_graphs.py``, a one-step group of its own kind):
        the inputs cross in one copy from a pinned buffer, so numpy
        inputs are the cheap ones, and a step whose gates open runs its
        eighs between its graph and a tail graph.  A capture or replay
        that fails raises.  Elsewhere it is
        ``discriminative_step_eager``."""
        if self.device.type != "cuda" or not replays_collectives(group):
            return self.discriminative_step_eager(
                opt, x, num_post, den_post, lr, generator, group)
        if self._step_graphs is None:
            self._step_graphs = StepGraphs(self)
        return self._step_graphs.run_discriminative(
            opt, x, num_post, den_post, float(lr), generator,
            _storage_dtype(self.train_storage_dtype), group)

    @torch.no_grad()
    def discriminative_step_eager(self, opt, x, num_post, den_post, lr,
                                  generator: Optional[torch.Generator] = None,
                                  group=None):
        """``discriminative_step`` run op by op on the net's device (the
        plain version of its graphs).  The objective's derivative at the
        softmax output is (num - den) / y over the numerator's frame
        count."""
        dev = self.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        num_post = torch.as_tensor(num_post, device=dev)
        den_post = torch.as_tensor(den_post, device=dev)
        sd = _storage_dtype(self.train_storage_dtype)
        out, acts, auxs = self.train_forward(x, sd, generator, group)
        y = torch.clamp_min(out.to(torch.float32), 1e-20)
        num = num_post.to(torch.float32)
        den = den_post.to(torch.float32)
        log_y = torch.log(y)
        n_frames, num_ll, den_ll = reduce_sum(
            [num.sum(), (num * log_y).sum(), (den * log_y).sum()], group)
        n_frames = torch.clamp_min(n_frames, 1e-8)
        objf = (num_ll - den_ll) / n_frames
        out_deriv = (num - den) / y / n_frames
        return self._backward_update(opt, acts, auxs, out_deriv, lr,
                                     sd, group), objf

    @torch.no_grad()
    def objf(self, x: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Diagnostic log-prob per frame (ref: nnet-compute-prob)."""
        return objf_from_output(self.forward(x), labels, weights)


class AmNnet:
    """Nnet + pdf priors.  Decoding uses pseudo log-likelihoods
    log p(pdf|x) - log prior(pdf) (ref: decodable-am-nnet.cc)."""

    def __init__(self, nnet: Nnet, num_pdfs: Optional[int] = None):
        self.nnet = nnet
        self.num_pdfs = num_pdfs or nnet.output_dim
        self.priors = np.full(self.num_pdfs, 1.0 / self.num_pdfs,
                              np.float64)

    def set_priors_from_counts(self, counts: np.ndarray,
                               smooth: float = 0.5) -> None:
        c = np.asarray(counts, np.float64) + smooth
        self.priors = c / c.sum()

    def _posteriors(self, X: np.ndarray, batch_size: int) -> np.ndarray:
        """predict over [T, D] in zero-padded batch_size slices."""
        T = X.shape[0]
        padded = round_up(T, batch_size)
        x = torch.zeros((padded, X.shape[1]), dtype=torch.float32,
                        device=self.nnet.device)
        x[:T] = torch.as_tensor(X, device=x.device)
        outs = [self.nnet.predict(x[i:i + batch_size])
                for i in range(0, padded, batch_size)]
        return torch.cat(outs)[:T].cpu().numpy()

    def _loglikes(self, post: np.ndarray) -> np.ndarray:
        return (np.log(np.maximum(post, 1e-20))
                - np.log(self.priors)[None, :]).astype(np.float32)

    def loglikes(self, feats: np.ndarray, batch_size: int = 512
                 ) -> np.ndarray:
        """[T, D] -> [T, num_pdfs] pseudo log-likelihoods."""
        return self._loglikes(self._posteriors(
            np.asarray(feats, np.float32), batch_size))

    def loglikes_batch(self, feats: Dict[str, np.ndarray],
                       batch_size: int = 4096) -> Dict[str, np.ndarray]:
        """Pseudo log-likelihoods for a keyed utterance set in ONE padded
        stream: frames of all utterances concatenate into [total, D], run
        through predict in batch_size slices, and split back."""
        keys = list(feats)
        if not keys:
            return {}
        lens = [int(feats[u].shape[0]) for u in keys]
        X = np.concatenate([np.asarray(feats[u], np.float32) for u in keys])
        ll = self._loglikes(self._posteriors(X, batch_size))
        out, off = {}, 0
        for u, n in zip(keys, lens):
            out[u] = ll[off:off + n]
            off += n
        return out
