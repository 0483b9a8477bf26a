"""nnet2 model utilities: feature transform, mixup, fix (twin of
``kaldi_cnn_tpu/models/utils.py``).

Clean-room equivalents of:
  - src/nnet2/get-feature-transform.{h,cc} (FeatureTransformEstimate):
    the LDA-like whitening preprocessing transform every train_*.sh
    inserts as a FixedAffineComponent in front of the net;
  - src/nnet2bin/nnet-am-mixup.cc (+ SumGroupComponent of
    nnet-component.cc): expand the final softmax into per-pdf mixtures
    summed by group — "Gaussian mixing-up" for nets;
  - src/nnet2bin/nnet-am-fix.cc (FixNnet): rescale input weights of
    saturated / dead nonlinearity units from activation statistics.

The port's differences: ``mixup_nnet`` returns a new ``Nnet`` holding
its parameters (the components it keeps are copies, so training one
net leaves the other alone), and ``fix_nnet`` rescales the net's
parameters in place and returns the number of units it adjusted.  The
numpy arithmetic is the JAX package's, so the mixup's perturbation and
the fix's factors come out the same.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.models.components import (
    AffineComponent, Component, FixedAffineComponent,
    RectifiedLinearComponent, SigmoidComponent, SoftmaxComponent,
    TanhComponent)
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.transform.lda import LdaEstimate

logger = get_logger(__name__)


# -- SumGroupComponent -------------------------------------------------------

class SumGroupComponent(Component):
    """y[:, g] = sum over x columns of group g
    (ref: nnet-component.cc SumGroupComponent); the backward gathers
    each column's group derivative."""

    def __init__(self, sizes: Tuple[int, ...]):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)

    @property
    def input_dim(self) -> int:
        return sum(self.sizes)

    @property
    def output_dim(self) -> int:
        return len(self.sizes)

    def _group_ids(self, device) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(len(self.sizes), device=device),
            torch.as_tensor(self.sizes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros((x.shape[0], len(self.sizes))).index_add_(
            1, self._group_ids(x.device), x)

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv[:, self._group_ids(out_deriv.device)]


# -- get-feature-transform ---------------------------------------------------

def estimate_feature_transform(x: np.ndarray, labels: np.ndarray,
                               dim: Optional[int] = None,
                               within_class_factor: float = 0.001,
                               device="cuda") -> FixedAffineComponent:
    """LDA-like whitening preprocessing transform from labeled egs
    (ref: FeatureTransformEstimate::Estimate — an LDA without
    dimensionality reduction by default, scaling within-class variance
    to within_class_factor so the net's input is decorrelated), as a
    FixedAffineComponent on ``device``."""
    num_classes = int(labels.max()) + 1
    lda = LdaEstimate(num_classes, x.shape[1])
    lda.accumulate(x, labels)
    out_dim = dim or x.shape[1]
    T, _ = lda.estimate(out_dim,
                        within_class_factor=np.sqrt(within_class_factor)
                        if within_class_factor != 1.0 else 1.0)
    return FixedAffineComponent.from_matrix(
        T[:, :-1].astype(np.float32), T[:, -1].astype(np.float32),
        device=device)


# -- mixup -------------------------------------------------------------------

def mixup_nnet(net: Nnet, target_components: int, seed: int = 0,
               perturb: float = 0.01) -> Nnet:
    """Expand [final affine -> softmax] into mixtures summed per pdf
    (ref: nnet-am-mixup.cc MixupNnet): rows of the final affine split
    proportionally to a uniform target, outputs regrouped by
    SumGroupComponent.  Returns the new net, on ``net``'s device."""
    assert isinstance(net.components[-1], SoftmaxComponent)
    aff_idx = len(net.components) - 2
    aff = net.components[aff_idx]
    assert isinstance(aff, AffineComponent)
    num_pdfs = aff.output_dim
    per = max(1, target_components // num_pdfs)
    sizes = tuple(per for _ in range(num_pdfs))
    rng = np.random.default_rng(seed)
    w = aff.w.detach().cpu().numpy()
    b = aff.b.detach().cpu().numpy()
    new_w = np.repeat(w, per, axis=0)
    new_b = np.repeat(b, per, axis=0)
    # perturb the copies and renormalize the bias so the summed prob is
    # initially unchanged: softmax groups of k identical rows sum to
    # k * p, so subtract log(k)
    noise = perturb * rng.standard_normal(new_w.shape).astype(w.dtype)
    new_w = new_w + noise * np.abs(new_w).mean()
    new_b = new_b - np.log(per)
    dev = aff.w.device
    new_aff = AffineComponent(aff.input_dim, num_pdfs * per,
                              max_change=aff.max_change, device=dev)
    with torch.no_grad():
        new_aff.w.copy_(torch.as_tensor(np.asarray(new_w, np.float32)))
        new_aff.b.copy_(torch.as_tensor(np.asarray(new_b, np.float32)))
    comps = [copy.deepcopy(c) for c in net.components[:aff_idx]]
    comps += [new_aff, SoftmaxComponent(num_pdfs * per),
              SumGroupComponent(sizes)]
    logger.info("mixup: %d pdfs x %d mixtures", num_pdfs, per)
    return Nnet(comps, ng_update_period=net.ng_in.update_period)


# -- nnet-fix ----------------------------------------------------------------

@torch.no_grad()
def fix_nnet(net: Nnet, x_sample: np.ndarray,
             max_average_deriv: float = 0.75,
             min_average_deriv: float = 0.05,
             relu_dead_fraction: float = 0.02,
             scale: float = 0.5) -> int:
    """Rescale input weights of pathological nonlinearity units from
    activation statistics on a sample batch (ref: nnet-am-fix.cc
    FixNnet: saturated sigmoid/tanh units get their incoming weights
    scaled down; dead ReLUs get theirs scaled up).  The statistics are
    of the eval forward's activations (``Nnet.forward``, component by
    component); the preceding Affine's ``w`` and ``b`` change in place.
    Returns the number of units adjusted."""
    acts = [torch.as_tensor(np.asarray(x_sample, np.float32),
                            device=net.device)]
    for c in net.components:
        acts.append(c(acts[-1]))
    n_fixed = 0
    for i, c in enumerate(net.components):
        prev = net.components[i - 1] if i > 0 else None
        if not isinstance(prev, AffineComponent):
            continue
        pre = acts[i].cpu().numpy()    # input to the nonlinearity
        if isinstance(c, (TanhComponent, SigmoidComponent)):
            # average |derivative| per unit: saturation -> ~0
            if isinstance(c, TanhComponent):
                deriv = 1.0 - np.tanh(pre) ** 2
            else:
                s = 1.0 / (1.0 + np.exp(-pre))
                deriv = 4.0 * s * (1.0 - s)  # normalized to max 1
            avg = deriv.mean(axis=0)
            bad = avg < min_average_deriv
        elif isinstance(c, RectifiedLinearComponent):
            frac = (pre > 0).mean(axis=0)
            bad = frac < relu_dead_fraction
        else:
            continue
        if bad.any():
            factor = np.where(
                bad, (1.0 / scale
                      if isinstance(c, RectifiedLinearComponent)
                      else scale), 1.0).astype(np.float32)
            f = torch.as_tensor(factor, device=prev.w.device)
            prev.w.mul_(f[:, None])
            prev.b.mul_(f)
            n_fixed += int(bad.sum())
    logger.info("nnet-fix: adjusted %d units", n_fixed)
    return n_fixed
