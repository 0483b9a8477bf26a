"""3-D max pooling over flat (t, f, c) rows, with the window argmax, and
its backward: the CUDA kernels and their plain versions.

Port of ``kaldi_cnn_tpu/ops/maxpool_pallas.py`` (``maxpool3d_pallas``)
and of the training path of ``Maxpooling3DComponent``
(``components.py`` ``forward(train=True)`` and ``backprop`` with the
argmax aux).  Layouts are the JAX package's: input rows are flattened
(t, f, c) volumes, index ``(t * in_f + f) * in_c + c``; output rows are
(ot, of, oc) with ``out_x = in_x // pool_x``.  The argmax is the window
index ``(pt * pool_f + pf) * pool_c + pc`` of the first maximum, int8
when the window has fewer than 128 elements and int32 otherwise; a
window holding a NaN pools to NaN with the argmax ``window`` (no index),
so the backward routes nothing into it.

The kernels (``csrc/maxpool.cu``) read each window straight from the
input row: the forward writes the maxima (and the argmax), the backward
writes every input element once, the derivative at the argmax and 0
elsewhere.  Each direction has two kernels, and ``forward_kernel`` /
``backward_kernel`` pick one from the shape and the pointers before the
launch: the vectorised kernel (16-byte loads and stores along the
channels; ``maxpool3d.launches``, ``maxpool3d_backward.launches``) when
``pool_c == 1``, ``in_c`` is a multiple of 16 bytes' worth of elements
and the tensors are 16-byte aligned, as the CNN recipe's are, and the
scalar kernel (``maxpool3d_scalar``, ``maxpool3d_backward_scalar``, their
own counts) otherwise.
``maxpool3d_reference`` and ``maxpool3d_backward_reference`` are the
plain versions: a 7-D reshape with ``amax`` and ``argmax``, and a
where-scatter.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel
or raises.  ``MaxPool3D`` wraps both directions as an autograd function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kaldi_cnn_tpu_torch.ops import common


class Pool3D(NamedTuple):
    """The pooling geometry; ``Maxpooling3DComponent`` has the same
    fields and is passed in its place."""

    in_t: int
    in_f: int
    in_c: int
    pool_t: int = 1
    pool_f: int = 1
    pool_c: int = 1


def window(pool) -> int:
    return pool.pool_t * pool.pool_f * pool.pool_c


def argmax_dtype(pool) -> torch.dtype:
    return torch.int8 if window(pool) < 128 else torch.int32


def _dims(pool):
    """(out_t, out_f, out_c, in_dim, out_dim); pool sizes must divide."""
    if (pool.in_t % pool.pool_t or pool.in_f % pool.pool_f
            or pool.in_c % pool.pool_c):
        raise ValueError(f"pool sizes must divide the input dims: {pool}")
    ot, of = pool.in_t // pool.pool_t, pool.in_f // pool.pool_f
    oc = pool.in_c // pool.pool_c
    return ot, of, oc, pool.in_t * pool.in_f * pool.in_c, ot * of * oc


def _window_iota(pool, device) -> torch.Tensor:
    """Window index on the 7-D block view, broadcastable."""
    pt = torch.arange(pool.pool_t, device=device).view(1, 1, -1, 1, 1, 1, 1)
    pf = torch.arange(pool.pool_f, device=device).view(1, 1, 1, 1, -1, 1, 1)
    pc = torch.arange(pool.pool_c, device=device).view(1, 1, 1, 1, 1, 1, -1)
    return (pt * pool.pool_f + pf) * pool.pool_c + pc


def maxpool3d_reference(x: torch.Tensor, pool, with_argmax: bool = False):
    """Plain 3-D max pool: reshape, amax, and the first-index argmax."""
    ot, of, oc, _, _ = _dims(pool)
    n = x.shape[0]
    v = x.reshape(n, ot, pool.pool_t, of, pool.pool_f, oc, pool.pool_c)
    y = v.amax(dim=(2, 4, 6))
    if not with_argmax:
        return y.reshape(n, -1)
    # argmax over the window in (pt, pf, pc) order: torch.argmax keeps
    # the first maximum; a NaN window has no index (jnp's where/min)
    wins = v.permute(0, 1, 3, 5, 2, 4, 6).reshape(n, ot, of, oc, -1)
    idx = torch.where(y.isnan(), window(pool), wins.argmax(dim=-1))
    return y.reshape(n, -1), idx.to(argmax_dtype(pool)).reshape(n, -1)


def maxpool3d_backward_reference(out_deriv: torch.Tensor,
                                 argmax: torch.Tensor, pool) -> torch.Tensor:
    """Plain backward: the derivative at each window's argmax, else 0."""
    ot, of, oc, in_dim, _ = _dims(pool)
    n = out_deriv.shape[0]
    d = out_deriv.reshape(n, ot, 1, of, 1, oc, 1)
    idx = argmax.to(torch.int64).reshape(n, ot, 1, of, 1, oc, 1)
    dx = torch.where(_window_iota(pool, d.device) == idx, d,
                     d.new_zeros(()))
    return dx.reshape(n, in_dim)


def _check_values(t: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype}, the maxpool kernels "
                        "take float32 or bfloat16")


def forward_kernel(pool, dtype: torch.dtype, *pointers: int) -> str:
    """Which forward kernel takes ``pool`` on ``dtype`` values at these
    device addresses (the input's, the output's and the argmax's):
    ``"vector"`` when ``pool_c == 1``, ``in_c`` is a multiple of the
    16-byte vector's elements and every address is 16-byte aligned,
    ``"scalar"`` otherwise."""
    lanes = 16 // dtype.itemsize
    if (pool.pool_c == 1 and pool.in_c % lanes == 0
            and all(p % 16 == 0 for p in pointers)):
        return "vector"
    return "scalar"


def backward_kernel(pool, dtype: torch.dtype, *pointers: int) -> str:
    """Which backward kernel takes ``pool`` on ``dtype`` derivatives at
    these device addresses (the derivative's, the argmax's and the input
    derivative's): the forward's conditions, ``"vector"`` or
    ``"scalar"``."""
    return forward_kernel(pool, dtype, *pointers)


def _forward(fn: str, x: torch.Tensor, pool, with_argmax: bool):
    """Checks x, allocates the outputs and launches the forward kernel
    ``fn``: the maxima, and the argmax with ``with_argmax``."""
    *_, in_dim, out_dim = _dims(pool)
    n = x.shape[0]
    _check_values(x, "x")
    common.require(x, "x", x.dtype, (n, in_dim))
    out = torch.empty((n, out_dim), dtype=x.dtype, device=x.device)
    arg = (torch.empty((n, out_dim), dtype=argmax_dtype(pool),
                       device=x.device) if with_argmax else None)
    rc = getattr(common.library(), fn)(
        x.data_ptr(), n, pool.in_t, pool.in_f, pool.in_c,
        pool.pool_t, pool.pool_f, pool.pool_c, int(x.dtype == torch.bfloat16),
        out.data_ptr(), None if arg is None else arg.data_ptr(),
        0 if arg is None else arg.element_size(),
        common.stream_ptr(x.device))
    common.check_launch(fn, rc)
    return (out, arg) if with_argmax else out


def maxpool3d_scalar(x: torch.Tensor, pool, with_argmax: bool = False):
    """``maxpool3d`` through the scalar forward kernel, whatever the
    shape: one output element a thread."""
    _dims(pool)
    if not common.on_cuda(x):
        return maxpool3d_reference(x, pool, with_argmax)
    res = _forward("kcnn_maxpool_fwd", x, pool, with_argmax)
    maxpool3d_scalar.launches += 1
    return res


def maxpool3d(x: torch.Tensor, pool, with_argmax: bool = False):
    """[N, in_dim] -> [N, out_dim] maxima in x's dtype, and with
    ``with_argmax`` the [N, out_dim] window argmax.  The outputs come
    from PyTorch's allocator, 16-byte aligned, so x decides the kernel."""
    _dims(pool)
    if not common.on_cuda(x):
        return maxpool3d_reference(x, pool, with_argmax)
    if forward_kernel(pool, x.dtype, x.data_ptr()) == "scalar":
        return maxpool3d_scalar(x, pool, with_argmax)
    res = _forward("kcnn_maxpool_fwd_vec", x, pool, with_argmax)
    maxpool3d.launches += 1
    return res


common.counted(maxpool3d)
common.counted(maxpool3d_scalar)


def _backward(fn: str, out_deriv: torch.Tensor, argmax: torch.Tensor,
              pool) -> torch.Tensor:
    """Checks the operands, allocates the input derivative and launches
    the backward kernel ``fn``."""
    *_, in_dim, out_dim = _dims(pool)
    n = out_deriv.shape[0]
    _check_values(out_deriv, "out_deriv")
    common.require(out_deriv, "out_deriv", out_deriv.dtype, (n, out_dim))
    common.require(argmax, "argmax", argmax_dtype(pool), (n, out_dim))
    dx = torch.empty((n, in_dim), dtype=out_deriv.dtype,
                     device=out_deriv.device)
    rc = getattr(common.library(), fn)(
        out_deriv.data_ptr(), argmax.data_ptr(), argmax.element_size(), n,
        pool.in_t, pool.in_f, pool.in_c, pool.pool_t, pool.pool_f,
        pool.pool_c, int(out_deriv.dtype == torch.bfloat16), dx.data_ptr(),
        common.stream_ptr(out_deriv.device))
    common.check_launch(fn, rc)
    return dx


def maxpool3d_backward_scalar(out_deriv: torch.Tensor, argmax: torch.Tensor,
                              pool) -> torch.Tensor:
    """``maxpool3d_backward`` through the scalar backward kernel, whatever
    the shape: one output element a thread."""
    _dims(pool)
    if not common.on_cuda(out_deriv, argmax):
        return maxpool3d_backward_reference(out_deriv, argmax, pool)
    dx = _backward("kcnn_maxpool_bwd", out_deriv, argmax, pool)
    maxpool3d_backward_scalar.launches += 1
    return dx


def maxpool3d_backward(out_deriv: torch.Tensor, argmax: torch.Tensor,
                       pool) -> torch.Tensor:
    """[N, out_dim] derivative and argmax -> [N, in_dim] derivative in
    out_deriv's dtype.  The output comes from PyTorch's allocator, so the
    derivative and the argmax decide the kernel."""
    _dims(pool)
    if not common.on_cuda(out_deriv, argmax):
        return maxpool3d_backward_reference(out_deriv, argmax, pool)
    if backward_kernel(pool, out_deriv.dtype, out_deriv.data_ptr(),
                       argmax.data_ptr()) == "scalar":
        return maxpool3d_backward_scalar(out_deriv, argmax, pool)
    dx = _backward("kcnn_maxpool_bwd_vec", out_deriv, argmax, pool)
    maxpool3d_backward.launches += 1
    return dx


common.counted(maxpool3d_backward)
common.counted(maxpool3d_backward_scalar)


class MaxPool3D(torch.autograd.Function):
    """``maxpool3d`` with its gradient: the forward keeps the argmax and
    the backward routes the incoming gradient along it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pool) -> torch.Tensor:
        y, arg = maxpool3d(x, pool, with_argmax=True)
        ctx.pool = pool
        ctx.save_for_backward(arg)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (arg,) = ctx.saved_tensors
        return maxpool3d_backward(grad.contiguous(), arg, ctx.pool), None
