"""nnet2-style components as ``nn.Module``s: the inference subset.

Twin of ``kaldi_cnn_tpu/models/components.py`` (forward passes only; the
backprop and NG-SGD updates come with the training path).  Field names
and dims are the JAX package's; parameters are ``w [out, in]`` and
``b [out]``.  Minibatches are [N, dim] float32 rows; Conv2D and
Maxpool3D read a row as a flattened (time, freq, channel) volume.

Each component's ``init(generator)`` draws its parameters from the same
distributions as the JAX ``init`` (the numbers differ: torch's streams
are not jax.random's; ``kaldi_cnn_tpu_torch.convert`` loads JAX params).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from kaldi_cnn_tpu_torch.ops.conv import conv2d_reference, maxpool_reference


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator,
                             dtype=torch.float32, device=generator.device)


def _param(*shape, device) -> nn.Parameter:
    """A zero f32 parameter (inference only: no gradient)."""
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


class Component(nn.Module):
    """Base: components without parameters draw nothing at init."""

    def init(self, generator: torch.Generator) -> None:
        pass


class AffineComponent(Component):
    """(ref: AffineComponent / AffineComponentPreconditionedOnline)."""

    def __init__(self, input_dim: int, output_dim: int,
                 param_stddev: Optional[float] = None,
                 bias_stddev: float = 1.0, device="cpu"):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.param_stddev, self.bias_stddev = param_stddev, bias_stddev
        self.w = _param(output_dim, input_dim, device=device)
        self.b = _param(output_dim, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        std = (self.param_stddev if self.param_stddev is not None
               else 1.0 / math.sqrt(self.input_dim))
        self.w.copy_(_normal(self.w.shape, std, generator))
        self.b.copy_(_normal(self.b.shape, self.bias_stddev, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.T + self.b


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


class NormalizeComponent(Component):
    """Row RMS normalization (ref: NormalizeComponent: y = x / rms(x))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rms = torch.sqrt((x * x).to(torch.float32).mean(dim=1, keepdim=True)
                         + 1e-20)
        return x / rms


class SoftmaxComponent(Component):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x.to(torch.float32), dim=1)


class Conv2DComponent(Component):
    """2-D convolution over the (time, freq) plane of spliced fbank
    volumes (the fork's Conv2DComponent).  Rows in: flattened
    [in_t, in_f, in_c]; rows out: flattened [out_t, out_f, num_filters].

    ``fused`` is the counterpart of the JAX ``use_pallas`` flag: it opts
    an adjacent Conv2D + Maxpool3D pair into ``Nnet.predict``'s fused
    conv+maxpool kernel.  The unfused ``forward`` is the plain im2col +
    matmul in f32."""

    def __init__(self, in_t: int, in_f: int, in_c: int, filt_t: int,
                 filt_f: int, num_filters: int, stride_t: int = 1,
                 stride_f: int = 1, param_stddev: Optional[float] = None,
                 fused: bool = False, device="cpu"):
        super().__init__()
        self.in_t, self.in_f, self.in_c = in_t, in_f, in_c
        self.filt_t, self.filt_f = filt_t, filt_f
        self.num_filters = num_filters
        self.stride_t, self.stride_f = stride_t, stride_f
        self.param_stddev = param_stddev
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
        return conv2d_reference(x, self.w, self.b, self)


class Maxpooling3DComponent(Component):
    """3-D max pooling over (time, freq, channel); pool sizes divide the
    dims (the fork's MaxpoolingComponent)."""

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
        return maxpool_reference(x, self.in_t, self.in_f, self.in_c,
                                 self.pool_t, self.pool_f, self.pool_c)
