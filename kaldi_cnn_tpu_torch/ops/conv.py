"""Fused Conv2D + bias (+ReLU) + max-pool: the CUDA kernel and its plain
version.

Port of ``kaldi_cnn_tpu/ops/conv_pallas.py`` (``conv2d_maxpool_implicit``),
the inference path of an adjacent Conv2DComponent + Maxpooling3DComponent
(pool_c = 1) pair.  Layouts are the JAX package's: input rows are
flattened (t, f, c) volumes, index ``(t * in_f + f) * in_c + c``;
``w [F, K]`` with K in (dt, df, c) order; output rows in
``(ot', of', filter)`` order.

Two kernels in ``csrc/conv_maxpool.cu`` build each im2col patch from
input staged in shared memory and pool in registers, so the conv output
never reaches device memory.  With ``bf16=True`` (the Pallas default and
the serving path's mode: operands rounded to bfloat16, products summed in
f32) ``conv2d_maxpool`` launches the ``wgmma`` tensor-core kernel; with
``bf16=False`` it goes through ``conv2d_maxpool_f32``, the f32 kernel on
the CUDA cores.  Each wrapper counts its own launches.
``conv2d_maxpool_reference`` is the plain version of both: im2col gather,
matmul, bias, then a reshape and max.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from kaldi_cnn_tpu_torch.ops import common
from kaldi_cnn_tpu_torch.ops.maxpool import Pool3D, maxpool3d_reference


@lru_cache(maxsize=None)
def patch_indices(in_t, in_f, in_c, filt_t, filt_f, stride_t=1,
                  stride_f=1) -> np.ndarray:
    """[out_t * out_f, filt_t * filt_f * in_c] gather indices into a flat
    input row (twin of components._conv_patch_indices)."""
    out_t = (in_t - filt_t) // stride_t + 1
    out_f = (in_f - filt_f) // stride_f + 1
    ot = np.arange(out_t)[:, None, None, None, None]
    of = np.arange(out_f)[None, :, None, None, None]
    dt = np.arange(filt_t)[None, None, :, None, None]
    df = np.arange(filt_f)[None, None, None, :, None]
    c = np.arange(in_c)[None, None, None, None, :]
    idx = ((ot * stride_t + dt) * in_f + of * stride_f + df) * in_c + c
    idx = np.broadcast_to(idx, (out_t, out_f, filt_t, filt_f, in_c))
    return np.ascontiguousarray(
        idx.reshape(out_t * out_f, filt_t * filt_f * in_c)).astype(np.int64)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the nearest bfloat16 (ties to even), in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     conv, bf16: bool = False) -> torch.Tensor:
    """Plain Conv2D: [N, in_dim] -> [N, out_t * out_f * F] in
    (ot, of, filter) order, as im2col gather + one matmul + bias."""
    n = x.shape[0]
    geometry = (conv.in_t, conv.in_f, conv.in_c, conv.filt_t, conv.filt_f,
                conv.stride_t, conv.stride_f)
    idx = common.device_constant(("patch_indices",) + geometry,
                                 lambda: patch_indices(*geometry), x.device)
    if bf16:
        x, w = round_bf16(x), round_bf16(w)
    patches = x[:, idx]                               # [N, P, K]
    y = patches.reshape(-1, patches.shape[-1]) @ w.T + b
    return y.reshape(n, -1)


def conv2d_maxpool_reference(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, conv, pool_t: int = 1,
                             pool_f: int = 1, relu: bool = False,
                             bf16: bool = True) -> torch.Tensor:
    """The plain PyTorch version of ``conv2d_maxpool`` on any device.
    On a CUDA tensor it needs TF32 off for an f32 comparison (the caller
    sets ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    y = conv2d_reference(x, w, b, conv, bf16=bf16)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return maxpool3d_reference(
        y, Pool3D(conv.out_t, conv.out_f, conv.num_filters, pool_t, pool_f))


def _check(conv, pool_t, pool_f) -> None:
    if conv.stride_t != 1 or conv.stride_f != 1:
        raise ValueError("conv2d_maxpool takes stride 1 only")
    if conv.out_t % pool_t or conv.out_f % pool_f:
        raise ValueError("pool sizes must divide the conv output")


def _launch(fn: str, x, w, b, conv, pool_t, pool_f, relu) -> torch.Tensor:
    """Validate the operands and launch the C entry point ``fn``."""
    n, nf = x.shape[0], conv.num_filters
    if nf % 8:
        raise ValueError("the conv2d_maxpool kernels take num_filters a "
                         "multiple of 8")
    common.require(x, "x", torch.float32, (n, conv.input_dim))
    common.require(w, "w", torch.float32, (nf, conv.patch_dim))
    common.require(b, "b", torch.float32, (nf,))
    out = torch.empty(
        (n, (conv.out_t // pool_t) * (conv.out_f // pool_f) * nf),
        dtype=torch.float32, device=x.device)
    rc = getattr(common.library(), fn)(
        x.data_ptr(), n, w.data_ptr(), b.data_ptr(), conv.in_t, conv.in_f,
        conv.in_c, conv.filt_t, conv.filt_f, nf, pool_t, pool_f, int(relu),
        out.data_ptr(), common.stream_ptr(x.device))
    common.check_launch(fn, rc)
    return out


def conv2d_maxpool_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       conv, pool_t: int = 1, pool_f: int = 1,
                       relu: bool = False) -> torch.Tensor:
    """``conv2d_maxpool`` with f32 operands: the CUDA-core kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    _check(conv, pool_t, pool_f)
    if not common.on_cuda(x, w, b):
        return conv2d_maxpool_reference(x, w, b, conv, pool_t, pool_f,
                                        relu, bf16=False)
    out = _launch("kcnn_conv_maxpool", x, w, b, conv, pool_t, pool_f, relu)
    conv2d_maxpool_f32.launches += 1
    return out


def conv2d_maxpool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   conv, pool_t: int = 1, pool_f: int = 1,
                   relu: bool = False, bf16: bool = True) -> torch.Tensor:
    """Fused conv + bias (+relu) + max-pool: [N, in_dim] ->
    [N, (out_t/pool_t) * (out_f/pool_f) * F].  Requires stride 1.  With
    bf16 operands a CUDA tensor launches the tensor-core kernel, whose
    staged tiles must fit in shared memory (it raises otherwise)."""
    if not bf16:
        return conv2d_maxpool_f32(x, w, b, conv, pool_t, pool_f, relu)
    _check(conv, pool_t, pool_f)
    if not common.on_cuda(x, w, b):
        return conv2d_maxpool_reference(x, w, b, conv, pool_t, pool_f,
                                        relu, bf16=True)
    out = _launch("kcnn_conv_maxpool_wgmma", x, w, b, conv, pool_t, pool_f,
                  relu)
    conv2d_maxpool.launches += 1
    return out


common.counted(conv2d_maxpool)
common.counted(conv2d_maxpool_f32)
