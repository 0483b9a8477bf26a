"""Parity of the port's max pooling (kernel 3's plain versions) with the
JAX package: the forward and its argmax against
``Maxpooling3DComponent.forward(train=True)`` and ``maxpool3d_pallas`` in
interpret mode, the backward against ``backprop`` with the aux, and the
autograd function against the manual backward."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.models.components import Maxpooling3DComponent as JPool
from kaldi_cnn_tpu.ops.maxpool_pallas import maxpool3d_pallas
from kaldi_cnn_tpu_torch.models.components import Maxpooling3DComponent
from kaldi_cnn_tpu_torch.ops import maxpool as mp

# (in_t, in_f, in_c, pool_t, pool_f, pool_c): the recipe's pool on a
# narrow conv output, pool_c > 1, and a 128-element window (int32 argmax)
SHAPES = [(4, 6, 4, 2, 3, 1), (4, 6, 8, 2, 3, 2), (4, 8, 16, 4, 4, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on the CPU's cores at once:
    one torch thread each keeps the many small ops here from contending
    for cores (OpenMP spinning made them over 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, rows=5, seed=0):
    in_dim = shape[0] * shape[1] * shape[2]
    return np.random.default_rng(seed).normal(
        size=(rows, in_dim)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_argmax_match_jax(shape):
    jc = JPool(*shape)
    x = _input(shape)
    want, want_aux = jc.forward({}, jnp.asarray(x), train=True)
    got, arg = mp.maxpool3d(torch.as_tensor(x), mp.Pool3D(*shape),
                            with_argmax=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert arg.dtype == (torch.int8 if np.prod(shape[3:]) < 128
                         else torch.int32)
    assert str(np.asarray(want_aux).dtype) == str(arg.dtype).split(".")[1]
    np.testing.assert_array_equal(arg.numpy(),
                                  np.asarray(want_aux).reshape(5, -1))
    np.testing.assert_array_equal(
        mp.maxpool3d(torch.as_tensor(x), mp.Pool3D(*shape)).numpy(),
        np.asarray(maxpool3d_pallas(jnp.asarray(x), jc)))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax(shape):
    jc, pool = JPool(*shape), mp.Pool3D(*shape)
    x = _input(shape, seed=1)
    y, aux = jc.forward({}, jnp.asarray(x), train=True)
    d = np.random.default_rng(2).normal(size=y.shape).astype(np.float32)
    want = np.asarray(jc.backprop({}, jnp.asarray(x), y, jnp.asarray(d), aux))
    _, arg = mp.maxpool3d(torch.as_tensor(x), pool, with_argmax=True)
    got = mp.maxpool3d_backward(torch.as_tensor(d), arg, pool)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_keep_the_first_index_and_nan_matches_jax():
    shape = (4, 6, 4, 2, 3, 1)
    jc, pool = JPool(*shape), mp.Pool3D(*shape)
    x = np.round(_input(shape, rows=3, seed=3))      # many ties
    x[1, :] = np.nan                                  # one NaN row
    x[2, 7] = np.nan                                  # one NaN window
    want, want_aux = jc.forward({}, jnp.asarray(x), train=True)
    got, arg = mp.maxpool3d(torch.as_tensor(x), pool, with_argmax=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(arg.numpy(),
                                  np.asarray(want_aux).reshape(3, -1))
    assert (arg[1] == 6).all() and int(arg[2].max()) == 6
    d = np.ones(got.shape, np.float32)
    want_dx = jc.backprop({}, jnp.asarray(x), want, jnp.asarray(d), want_aux)
    np.testing.assert_array_equal(
        mp.maxpool3d_backward(torch.as_tensor(d), arg, pool).numpy(),
        np.asarray(want_dx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_is_the_manual_backward(dtype):
    shape = (4, 6, 8, 2, 3, 2)
    comp = Maxpooling3DComponent(*shape)
    x = torch.as_tensor(_input(shape, seed=4)).to(dtype).requires_grad_()
    y = comp(x)
    d = torch.as_tensor(np.random.default_rng(5).normal(size=y.shape)
                        .astype(np.float32)).to(dtype)
    (g,) = torch.autograd.grad(y, x, d)
    y2, aux = comp.train_forward(x.detach())
    assert y.dtype == y2.dtype == dtype and torch.equal(y, y2)
    assert torch.equal(g, comp.backprop(x.detach(), y2, d, aux))
