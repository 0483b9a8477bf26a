"""nnet2-style components as ``nn.Module``s.

Twin of ``kaldi_cnn_tpu/models/components.py``: every component of the
JAX package (the CNN recipes' Conv2D, Maxpool3D, Affine, Pnorm,
Normalize and Softmax; Identity and SliceParallel, which carry the
Switchboard CNN's iVector around its conv front end; and the nnet2
chain's Splice, FixedAffine, Tanh, Sigmoid, RectifiedLinear and
Dropout): the forward pass (``forward``, and ``train_forward`` that also
returns what the backward needs), ``backprop(in_value, out_value,
out_deriv, aux) -> in_deriv``, and for the trainable Affine and Conv2D
(and a SliceParallel holding one) ``init_opt``/``update`` with NG-SGD.
Field names and dims are the JAX package's; parameters are ``w [out,
in]`` and ``b [out]`` (FixedAffine keeps them as buffers: it is not
trained).  Minibatches are [N, dim] rows, float32 or (stored activations
in training) bfloat16; Conv2D and Maxpool3D read a row as a flattened
(time, freq, channel) volume.

``train_forward(x, generator=None, group=None)``: Dropout draws its mask
from ``generator`` (it passes its input through without one, as the JAX
component does without a key); under a process ``group`` it draws the
mask of the group's whole minibatch and keeps this rank's rows, so that
the data-parallel step equals the single-process step.

``update`` changes the parameters in place (the JAX package returns new
ones): the caller takes the backprop through a component before it
updates it, so the backprop still sees the old parameters.  Its
``group`` (a ``torch.distributed`` process group, or None) makes it the
data-parallel update: the rows are this rank's slice of the global
minibatch and every row sum and row sample spans the group
(``models/ng_sgd.py``).

Each component's ``init(generator)`` draws its parameters from the same
distributions as the JAX ``init`` (the numbers differ: torch's streams
are not jax.random's; ``kaldi_cnn_tpu_torch.convert`` loads JAX params).
"""

from __future__ import annotations

import math
from functools import cached_property
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn
from torch.nn import grad as conv_grad

from kaldi_cnn_tpu_torch.core.mesh import reduce_sum, row_span, strided_rows
from kaldi_cnn_tpu_torch.models.ng_sgd import (
    OnlineNaturalGradient, ng_affine_apply, ng_delta_from_stats)
from kaldi_cnn_tpu_torch.ops import common
from kaldi_cnn_tpu_torch.ops.conv import conv2d_reference, patch_indices
from kaldi_cnn_tpu_torch.ops.maxpool import (
    MaxPool3D, maxpool3d, maxpool3d_backward)


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator,
                             dtype=torch.float32, device=generator.device)


def _param(*shape, device) -> nn.Parameter:
    """A zero f32 parameter.  Training updates it by hand under no_grad;
    autograd reaches it only through ``torch.func.functional_call``."""
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


class Component(nn.Module):
    """Base: components without parameters draw nothing at init, are not
    trained, and keep nothing from the forward for the backward."""

    trainable = False

    def init(self, generator: torch.Generator) -> None:
        pass

    def train_forward(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        """(output, aux) for the backward."""
        return self(x), None


class AffineComponent(Component):
    """(ref: AffineComponent / AffineComponentPreconditionedOnline)."""

    def __init__(self, input_dim: int, output_dim: int,
                 param_stddev: Optional[float] = None,
                 bias_stddev: float = 1.0, max_change: float = 0.75,
                 trainable: bool = True, device="cuda"):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.param_stddev, self.bias_stddev = param_stddev, bias_stddev
        self.max_change, self.trainable = max_change, trainable
        self.w = _param(output_dim, input_dim, device=device)
        self.b = _param(output_dim, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        std = (self.param_stddev if self.param_stddev is not None
               else 1.0 / math.sqrt(self.input_dim))
        self.w.copy_(_normal(self.w.shape, std, generator))
        self.b.copy_(_normal(self.b.shape, self.bias_stddev, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.w.dtype) @ self.w.T + self.b

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv.to(self.w.dtype) @ self.w

    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        dev = self.w.device
        return {"ng_in": ng_in.init(self.input_dim + 1, dev),
                "ng_out": ng_out.init(self.output_dim, dev)}

    @torch.no_grad()
    def update(self, opt, in_value, out_deriv, lr, ng_in, ng_out,
               group=None):
        """NG-SGD step of w and b in place; returns the new opt state."""
        w, b, opt_in, opt_out = ng_affine_apply(
            ng_in, ng_out, opt["ng_in"], opt["ng_out"], in_value, out_deriv,
            self.w, self.b, lr, self.max_change, group)
        self.w.copy_(w)
        self.b.copy_(b)
        return {"ng_in": opt_in, "ng_out": opt_out}


class FixedAffineComponent(Component):
    """Non-trainable affine, e.g. the LDA-like preprocessing transform
    (ref: FixedAffineComponent from get-feature-transform).  ``w`` and
    ``b`` are buffers: the trainer and the model average leave them
    alone."""

    def __init__(self, input_dim: int, output_dim: int, device="cuda"):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.register_buffer("w", torch.zeros(output_dim, input_dim,
                                              device=device))
        self.register_buffer("b", torch.zeros(output_dim, device=device))

    @staticmethod
    def from_matrix(mat: np.ndarray, bias: Optional[np.ndarray] = None,
                    device="cuda") -> "FixedAffineComponent":
        out_dim, in_dim = mat.shape
        c = FixedAffineComponent(in_dim, out_dim, device=device)
        c.w.copy_(torch.as_tensor(np.asarray(mat, np.float32)))
        if bias is not None:
            c.b.copy_(torch.as_tensor(np.asarray(bias, np.float32)))
        return c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.w.dtype) @ self.w.T + self.b

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv.to(self.w.dtype) @ self.w


class TanhComponent(Component):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv * (1.0 - out_value * out_value)


class SigmoidComponent(Component):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv * out_value * (1.0 - out_value)


class RectifiedLinearComponent(Component):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(x, 0.0)

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv * (out_value > 0.0).to(out_deriv.dtype)


class DropoutComponent(Component):
    """Zeroes a ``proportion`` of the units in training and scales the
    rest by 1 / keep; the eval forward passes its input through."""

    def __init__(self, dim: int, proportion: float = 0.5):
        super().__init__()
        self.dim, self.proportion = dim, proportion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def train_forward(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        """(x * mask, mask), the mask in x's dtype (the storage dtype in
        training, as in the JAX package); (x, None) without a generator
        or at proportion 0.  Under ``group`` the uniforms are drawn for
        the group's whole minibatch and this rank keeps its rows."""
        if generator is None or self.proportion <= 0.0:
            return x, None
        keep = 1.0 - self.proportion
        offset, n_all = row_span(x.shape[0], group)
        u = torch.rand((n_all, x.shape[1]), generator=generator,
                       device=generator.device)
        u = u[offset:offset + x.shape[0]].to(x.device)
        mask = (u < keep).to(x.dtype) / torch.tensor(keep, dtype=x.dtype)
        return x * mask, mask

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv if aux is None else out_deriv * aux


class SpliceComponent(Component):
    """Frame splicing over time for whole-utterance inference (ref:
    SpliceComponent; in training the egs are pre-spliced like
    nnet-get-egs).  The frames past either edge repeat the edge frame."""

    def __init__(self, input_dim: int, left_context: int,
                 right_context: int):
        super().__init__()
        self.input_dim = input_dim
        self.left_context, self.right_context = left_context, right_context

    @property
    def output_dim(self) -> int:
        return self.input_dim * (self.left_context + self.right_context + 1)

    def _index(self, t: int, device) -> torch.Tensor:
        """[t * window] source frame of each spliced slot."""
        offs = torch.arange(-self.left_context, self.right_context + 1,
                            device=device)
        return torch.clamp(torch.arange(t, device=device)[:, None]
                           + offs[None, :], 0, t - 1).reshape(-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[0]
        return x[self._index(t, x.device)].reshape(t, -1)

    def backprop(self, in_value, out_value, out_deriv, aux):
        """Index-scatter transpose of the forward gather: each input
        frame sums the derivative of every spliced slot it filled, the
        edge-clip duplicates included (ref: nnet-component.cc
        SpliceComponent::Backprop)."""
        t = in_value.shape[0]
        od = out_deriv.reshape(-1, self.input_dim)
        return torch.zeros((t, self.input_dim), dtype=od.dtype,
                           device=od.device).index_add_(
            0, self._index(t, od.device), od)


class PnormComponent(Component):
    """Group p-norm nonlinearity (ref: PnormComponent); the group
    power-sum accumulates in f32."""

    def __init__(self, input_dim: int, output_dim: int, p: float = 2.0):
        super().__init__()
        assert input_dim % output_dim == 0
        self.input_dim, self.output_dim, self.p = input_dim, output_dim, p

    @property
    def group_size(self) -> int:
        return self.input_dim // self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(x.shape[0], self.output_dim, self.group_size)
        s = torch.pow(g.abs(), self.p).to(torch.float32).sum(dim=2)
        return torch.pow(s + 1e-20, 1.0 / self.p).to(x.dtype)

    def backprop(self, in_value, out_value, out_deriv, aux):
        n = in_value.shape[0]
        g = in_value.reshape(n, self.output_dim, self.group_size)
        y = torch.clamp_min(out_value, 1e-10)[:, :, None]
        dx = (out_deriv[:, :, None] * torch.sign(g)
              * torch.pow(g.abs() / y, self.p - 1.0))
        return dx.reshape(n, self.input_dim)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).to(torch.float32).mean(dim=1, keepdim=True)
                      + 1e-20)


class NormalizeComponent(Component):
    """Row RMS normalization (ref: NormalizeComponent: y = x / rms(x))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x / _rms(x)

    def backprop(self, in_value, out_value, out_deriv, aux):
        rms = _rms(in_value)
        dot = (out_deriv * in_value).to(torch.float32).sum(dim=1,
                                                           keepdim=True)
        return out_deriv / rms - in_value * dot / (self.dim * rms ** 3)


class SoftmaxComponent(Component):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x.to(torch.float32), dim=1)

    def backprop(self, in_value, out_value, out_deriv, aux):
        dot = (out_deriv * out_value).to(torch.float32).sum(dim=1,
                                                            keepdim=True)
        return out_value * (out_deriv - dot)


class Conv2DComponent(Component):
    """2-D convolution over the (time, freq) plane of spliced fbank
    volumes (the fork's Conv2DComponent).  Rows in: flattened
    [in_t, in_f, in_c]; rows out: flattened [out_t, out_f, num_filters].

    ``fused`` is the counterpart of the JAX ``use_pallas`` flag: it opts
    an adjacent Conv2D + Maxpool3D pair into ``Nnet.predict``'s fused
    conv+maxpool kernel.  The unfused ``forward`` is the plain im2col +
    matmul in f32.  The backprop and the update's statistics are
    convolutions (``torch.nn.grad``), as the JAX package leaves them to
    XLA's convolution."""

    def __init__(self, in_t: int, in_f: int, in_c: int, filt_t: int,
                 filt_f: int, num_filters: int, stride_t: int = 1,
                 stride_f: int = 1, param_stddev: Optional[float] = None,
                 max_change: float = 0.75, trainable: bool = True,
                 fused: bool = False, device="cuda"):
        super().__init__()
        self.in_t, self.in_f, self.in_c = in_t, in_f, in_c
        self.filt_t, self.filt_f = filt_t, filt_f
        self.num_filters = num_filters
        self.stride_t, self.stride_f = stride_t, stride_f
        self.param_stddev = param_stddev
        self.max_change, self.trainable = max_change, trainable
        self.fused = fused
        self.w = _param(num_filters, self.patch_dim, device=device)
        self.b = _param(num_filters, device=device)

    @property
    def out_t(self) -> int:
        return (self.in_t - self.filt_t) // self.stride_t + 1

    @property
    def out_f(self) -> int:
        return (self.in_f - self.filt_f) // self.stride_f + 1

    @property
    def patch_dim(self) -> int:
        return self.filt_t * self.filt_f * self.in_c

    @property
    def num_patches(self) -> int:
        return self.out_t * self.out_f

    @property
    def input_dim(self) -> int:
        return self.in_t * self.in_f * self.in_c

    @property
    def output_dim(self) -> int:
        return self.num_patches * self.num_filters

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        std = (self.param_stddev if self.param_stddev is not None
               else 1.0 / math.sqrt(self.patch_dim))
        self.w.copy_(_normal(self.w.shape, std, generator))
        self.b.copy_(_normal(self.b.shape, 0.1, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            # the JAX conv on bf16-stored activations: bf16 operands,
            # f32 accumulation, a bf16 result plus the bias in bf16
            y = conv2d_reference(x.to(torch.float32), self.w, 0.0, self,
                                 bf16=True).to(torch.bfloat16)
            y = y.reshape(x.shape[0], -1, self.num_filters)
            return (y + self.b.to(torch.bfloat16)).reshape(x.shape[0], -1)
        return conv2d_reference(x, self.w, self.b, self)

    # -- the convolutions of the backward, in NCHW over (t, f) ----------
    def _nchw(self, x: torch.Tensor) -> torch.Tensor:
        """[N, in_dim] rows -> [N, in_c, in_t, in_f] f32."""
        return x.to(torch.float32).reshape(
            -1, self.in_t, self.in_f, self.in_c).permute(0, 3, 1, 2)

    def _filters(self, w: torch.Tensor) -> torch.Tensor:
        """[K, patch_dim] in (dt, df, c) order -> [K, in_c, ft, ff]."""
        return w.reshape(-1, self.filt_t, self.filt_f,
                         self.in_c).permute(0, 3, 1, 2)

    def _deriv_nchw(self, out_deriv: torch.Tensor) -> torch.Tensor:
        return out_deriv.to(torch.float32).reshape(
            -1, self.out_t, self.out_f, self.num_filters).permute(0, 3, 1, 2)

    def _stride(self):
        return (self.stride_t, self.stride_f)

    def backprop(self, in_value, out_value, out_deriv, aux):
        n = in_value.shape[0]
        dx = conv_grad.conv2d_input(
            (n, self.in_c, self.in_t, self.in_f), self._filters(self.w),
            self._deriv_nchw(out_deriv), stride=self._stride())
        return dx.permute(0, 2, 3, 1).reshape(n, self.input_dim).to(
            out_deriv.dtype)

    @cached_property
    def _patch_multiplicity(self) -> np.ndarray:
        """[input_dim]: how many im2col patch rows each input element
        lands in (for ||patches||^2 without forming them)."""
        return np.bincount(self._patch_indices().ravel(),
                           minlength=self.input_dim).astype(np.float32)

    def _patch_indices(self) -> np.ndarray:
        return patch_indices(self.in_t, self.in_f, self.in_c, self.filt_t,
                             self.filt_f, self.stride_t, self.stride_f)

    # NG update treats each patch row as a data row, like the affine
    # layers (ref: Convolutional1dComponent::Update flattens patches)
    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        dev = self.w.device
        return {"ng_in": ng_in.init(self.patch_dim + 1, dev),
                "ng_out": ng_out.init(self.num_filters, dev)}

    @torch.no_grad()
    def update(self, opt, in_value, out_deriv, lr, ng_in, ng_out,
               group=None):
        """NG-SGD step over patch rows without forming the im2col
        matrix: G by a filter-gradient convolution, the input-side
        projections by a convolution with the basis rows as filters,
        ||patches||^2 from the patch multiplicity, the output-side
        statistics from the [F, F] Gram.  Updates w and b in place and
        returns the new opt state."""
        n = in_value.shape[0]
        offset, n_all = row_span(n, group)
        n_rows = n_all * self.num_patches
        x = self._nchw(in_value)
        d = self._deriv_nchw(out_deriv)
        d2 = out_deriv.to(torch.float32).reshape(-1, self.num_filters)
        state_in, state_out = opt["ng_in"], opt["ng_out"]

        gw = conv_grad.conv2d_weight(
            x, (self.num_filters, self.in_c, self.filt_t, self.filt_f), d,
            stride=self._stride())
        gw = gw.permute(0, 2, 3, 1).reshape(self.num_filters, self.patch_dim)

        u_i = state_in.u                                  # [Ri, patch+1]
        proj_in = (Fn.conv2d(x, self._filters(u_i[:, :-1]),
                             stride=self._stride())
                   + u_i[:, -1][None, :, None, None])     # [n, Ri, ot, of]
        x32 = in_value.to(torch.float32)
        dev = x32.device
        geometry = (self.in_t, self.in_f, self.in_c, self.filt_t,
                    self.filt_f, self.stride_t, self.stride_f)
        mult = common.device_constant(
            ("patch_multiplicity",) + geometry,
            lambda: self._patch_multiplicity, dev)
        u_o = state_out.u

        # deterministic-stride row samples on the flat patch-row space of
        # the global batch; a rank samples the frames it holds, which are
        # the contiguous samples [lo, hi).  The indices are made on the
        # device (no host copy, which a CUDA graph's capture cannot hold).
        s_i = min(n_rows, u_i.shape[0])
        stride = max(n_rows // s_i, 1)
        lo = min(s_i, -(-offset * self.num_patches // stride))
        hi = min(s_i, -(-(offset + n) * self.num_patches // stride))
        rows_i = torch.arange(lo, hi, device=dev) * stride
        pidx = common.device_constant(("patch_indices",) + geometry,
                                      self._patch_indices, dev)
        patches = torch.gather(
            x32[rows_i // self.num_patches - offset], 1,
            pidx[rows_i % self.num_patches])
        if lo == 0 and hi == s_i:
            xs = patches
        else:
            xs = x32.new_zeros((s_i, self.patch_dim))
            xs[lo:hi] = patches

        g, proj_sq_in, x_sq, m, xs, ds = reduce_sum([
            torch.cat([gw, d2.sum(dim=0)[:, None]], dim=1),
            (proj_in * proj_in).sum(dim=(0, 2, 3)),
            ((x32 * x32) @ mult).sum() + n * self.num_patches,
            d2.T @ d2,                                    # [F, F]
            xs,
            strided_rows(d2, n_rows, u_o.shape[0], offset * self.num_patches,
                         group)], group)
        d_sq = torch.trace(m)
        proj_sq_out = ((u_o @ m) * u_o).sum(dim=1)
        xs = torch.cat([xs, xs.new_ones((s_i, 1))], dim=1)

        delta, opt_in, opt_out = ng_delta_from_stats(
            ng_in, ng_out, state_in, state_out, g, x_sq, proj_sq_in, d_sq,
            proj_sq_out, xs, ds, n_rows)
        if self.max_change > 0:
            norm = torch.sqrt((delta * delta).sum()) * abs(lr)
            scale = torch.clamp_max(
                self.max_change / torch.clamp_min(norm, 1e-20), 1.0)
        else:
            scale = 1.0
        step = lr * scale
        self.w.add_(step * delta[:, :-1])
        self.b.add_(step * delta[:, -1])
        return {"ng_in": opt_in, "ng_out": opt_out}


class Maxpooling3DComponent(Component):
    """3-D max pooling over (time, freq, channel); pool sizes divide the
    dims (the fork's MaxpoolingComponent).  All three directions run
    kernel 3 (``ops.maxpool``) on a CUDA tensor: ``forward`` (through the
    autograd function when a gradient is wanted), ``train_forward`` with
    the int8/int32 window argmax as aux, and ``backprop`` along it (the
    first maximum of a window takes the whole derivative)."""

    def __init__(self, in_t: int, in_f: int, in_c: int, pool_t: int = 1,
                 pool_f: int = 1, pool_c: int = 1):
        super().__init__()
        assert in_t % pool_t == 0 and in_f % pool_f == 0 \
            and in_c % pool_c == 0
        self.in_t, self.in_f, self.in_c = in_t, in_f, in_c
        self.pool_t, self.pool_f, self.pool_c = pool_t, pool_f, pool_c

    @property
    def out_t(self):
        return self.in_t // self.pool_t

    @property
    def out_f(self):
        return self.in_f // self.pool_f

    @property
    def out_c(self):
        return self.in_c // self.pool_c

    @property
    def input_dim(self):
        return self.in_t * self.in_f * self.in_c

    @property
    def output_dim(self):
        return self.out_t * self.out_f * self.out_c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return MaxPool3D.apply(x, self)
        return maxpool3d(x, self)

    def train_forward(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        return maxpool3d(x, self, with_argmax=True)

    def backprop(self, in_value, out_value, out_deriv, aux):
        return maxpool3d_backward(out_deriv, aux, self)


class IdentityComponent(Component):
    """Pass-through (used as a branch of SliceParallelComponent)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    @property
    def input_dim(self) -> int:
        return self.dim

    @property
    def output_dim(self) -> int:
        return self.dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def backprop(self, in_value, out_value, out_deriv, aux):
        return out_deriv


class SliceParallelComponent(Component):
    """Apply sub-components to contiguous column slices of the input and
    concatenate their outputs: how the Switchboard CNN's iVector columns
    bypass the conv front end.  The parts live in ``parts`` (parameter
    names ``parts.{j}.w``); its NG state is ``{"parts": (...)}`` with
    ``{}`` for a part that is not trained, as in the JAX package.

    A column slice of a row-major minibatch is not contiguous, and the
    kernel wrappers take contiguous tensors only: each part gets its
    input and derivative slices as contiguous copies."""

    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    @property
    def input_dim(self) -> int:
        return sum(p.input_dim for p in self.parts)

    @property
    def output_dim(self) -> int:
        return sum(p.output_dim for p in self.parts)

    @property
    def trainable(self) -> bool:
        return any(p.trainable for p in self.parts)

    def _in_slices(self):
        out, o = [], 0
        for p in self.parts:
            out.append((o, o + p.input_dim))
            o += p.input_dim
        return out

    def _out_slices(self):
        out, o = [], 0
        for p in self.parts:
            out.append((o, o + p.output_dim))
            o += p.output_dim
        return out

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parts:
            p.init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([p(x[:, i0:i1].contiguous()) for p, (i0, i1)
                          in zip(self.parts, self._in_slices())], dim=1)

    def train_forward(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        """(output, the list of the parts' auxes)."""
        ys, auxs = [], []
        for p, (i0, i1) in zip(self.parts, self._in_slices()):
            y, aux = p.train_forward(x[:, i0:i1].contiguous(), generator,
                                     group)
            ys.append(y)
            auxs.append(aux)
        return torch.cat(ys, dim=1), auxs

    def backprop(self, in_value, out_value, out_deriv, aux):
        ds = []
        for p, (i0, i1), (o0, o1), a in zip(
                self.parts, self._in_slices(), self._out_slices(),
                aux or [None] * len(self.parts)):
            ds.append(p.backprop(in_value[:, i0:i1].contiguous(),
                                 out_value[:, o0:o1].contiguous(),
                                 out_deriv[:, o0:o1].contiguous(), a))
        return torch.cat(ds, dim=1)

    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        return {"parts": tuple(p.init_opt(ng_in, ng_out) if p.trainable
                               else {} for p in self.parts)}

    @torch.no_grad()
    def update(self, opt, in_value, out_deriv, lr, ng_in, ng_out,
               group=None):
        """NG-SGD step of each trained part in place; returns the new opt
        state."""
        new = []
        for p, oo, (i0, i1), (o0, o1) in zip(
                self.parts, opt["parts"], self._in_slices(),
                self._out_slices()):
            new.append(p.update(oo, in_value[:, i0:i1].contiguous(),
                                out_deriv[:, o0:o1].contiguous(), lr, ng_in,
                                ng_out, group) if p.trainable else oo)
        return {"parts": tuple(new)}


def param_tree(c: nn.Module, leaf, prefix: str = ""):
    """The JAX pytree layout of component ``c``'s parameters: a dict of its
    own parameters by name, or ``{"parts": (one tree a part)}`` for a
    SliceParallelComponent.  ``leaf(name, parameter)`` gives each value,
    with ``name`` relative to ``c`` (``"parts.0.w"``)."""
    if isinstance(c, SliceParallelComponent):
        return {"parts": tuple(param_tree(p, leaf, f"{prefix}parts.{j}.")
                               for j, p in enumerate(c.parts))}
    return {k: leaf(prefix + k, t)
            for k, t in c.named_parameters(recurse=False)}


def map_tree(tree, fn, prefix: str = ""):
    """``fn(name, leaf)`` over a component's tree in ``param_tree``'s
    layout (its params, or its NG states by side), in that layout, with
    ``name`` as ``param_tree`` gives it."""
    if "parts" in tree:
        return {"parts": tuple(map_tree(t, fn, f"{prefix}parts.{j}.")
                               for j, t in enumerate(tree["parts"]))}
    return {k: fn(prefix + k, v) for k, v in tree.items()}
