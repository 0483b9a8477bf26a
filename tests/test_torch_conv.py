"""Parity of the port's fused conv+maxpool with the JAX package: the
plain version against the Pallas implicit-GEMM kernel (interpret mode on
the CPU) and the unfused XLA component chain, and the wrapper's checks
and dispatch.  The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py).  Shapes follow tests/test_conv_pallas.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.models.components import (
    Conv2DComponent as JConv, Maxpooling3DComponent as JPool)
from kaldi_cnn_tpu.ops.conv_pallas import conv2d_maxpool_implicit
from kaldi_cnn_tpu_torch.models.components import (
    Conv2DComponent, Maxpooling3DComponent)
from kaldi_cnn_tpu_torch.ops import conv as tc

SHAPES = [(8, 12, 2, 3, 5, 16, 3, 4), (6, 10, 1, 2, 3, 8, 1, 2),
          (11, 36, 3, 4, 7, 40, 2, 3)]
TOL = 2e-4          # rtol = atol for f32 against f32
BF16_REL = 0.02     # bf16 operands: max err / max|f32 ref|


def _case(shape, rows=9, seed=0):
    in_t, in_f, in_c, ft, ff, nf, pt, pf = shape
    jconv = JConv(in_t=in_t, in_f=in_f, in_c=in_c, filt_t=ft, filt_f=ff,
                  num_filters=nf)
    p = jax.device_get(jconv.init(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).normal(
        size=(rows, jconv.input_dim)).astype(np.float32)
    conv = Conv2DComponent(in_t, in_f, in_c, ft, ff, nf, device="cpu")
    return jconv, conv, p, x, pt, pf


def _t(a):
    return torch.as_tensor(np.array(a))


def _chain(jconv, p, x, pt, pf, relu):
    y = jconv.forward(p, jnp.asarray(x))[0]
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(JPool(jconv.out_t, jconv.out_f, jconv.num_filters,
                            pt, pf, 1).forward({}, y)[0])


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_pallas(shape, relu):
    """Against conv2d_maxpool_implicit in interpret mode, f32 and bf16
    operands (the Pallas default)."""
    jconv, conv, p, x, pt, pf = _case(shape)
    for bf16 in (False, True):
        pallas = np.asarray(conv2d_maxpool_implicit(
            jnp.asarray(x), p["w"], p["b"], jconv, pt, pf, relu=relu,
            block=8, bf16=bf16))
        got = tc.conv2d_maxpool(_t(x), _t(p["w"]), _t(p["b"]), conv, pt,
                                pf, relu=relu, bf16=bf16).numpy()
        np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_xla_chain(shape, relu):
    """Against the unfused Conv2DComponent -> Maxpooling3DComponent chain
    (the WSJ input volume among the shapes); bf16 operands stay within
    bf16 mantissa tolerance of it."""
    jconv, conv, p, x, pt, pf = _case(shape)
    chain = _chain(jconv, p, x, pt, pf, relu)
    got = tc.conv2d_maxpool_reference(_t(x), _t(p["w"]), _t(p["b"]), conv,
                                      pt, pf, relu=relu, bf16=False).numpy()
    np.testing.assert_allclose(got, chain, rtol=TOL, atol=TOL)
    got16 = tc.conv2d_maxpool(_t(x), _t(p["w"]), _t(p["b"]), conv, pt, pf,
                              relu=relu, bf16=True).numpy()
    assert np.abs(got16 - chain).max() / np.abs(chain).max() < BF16_REL


def test_components_match_jax():
    shape = SHAPES[0]
    jconv, conv, p, x, pt, pf = _case(shape, rows=5, seed=1)
    with torch.no_grad():
        conv.w.copy_(_t(p["w"]))
        conv.b.copy_(_t(p["b"]))
    y = conv(_t(x))
    want = np.asarray(jconv.forward(p, jnp.asarray(x))[0])
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    jpool = JPool(jconv.out_t, jconv.out_f, jconv.num_filters, pt, pf, 2)
    pool = Maxpooling3DComponent(conv.out_t, conv.out_f, conv.num_filters,
                                 pt, pf, 2)
    np.testing.assert_array_equal(
        pool(y).numpy(), np.asarray(jpool.forward({}, jnp.asarray(
            y.numpy()))[0]))
    assert pool.output_dim == jpool.output_dim
    assert conv.output_dim == jconv.output_dim
    np.testing.assert_array_equal(
        tc.patch_indices(8, 12, 2, 3, 5), jconv._patch_indices())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    conv = Conv2DComponent(6, 10, 1, 2, 3, 8, stride_t=2, device="cpu")
    x, w, b = torch.zeros(2, 60), torch.zeros(8, 6), torch.zeros(8)
    with pytest.raises(ValueError, match="stride"):
        tc.conv2d_maxpool(x, w, b, conv, 1, 1)
    conv = Conv2DComponent(6, 10, 1, 2, 3, 8, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tc.conv2d_maxpool(x, w, b, conv, 2, 3)     # out 5 x 8
    with pytest.raises(ValueError, match="devices"):
        tc.conv2d_maxpool(x, w, b.to("meta"), conv, 1, 2)


def test_cpu_tensors_take_the_plain_version():
    jconv, conv, p, x, pt, pf = _case(SHAPES[1])
    before = tc.conv2d_maxpool.launches
    got = tc.conv2d_maxpool(_t(x), _t(p["w"]), _t(p["b"]), conv, pt, pf)
    assert tc.conv2d_maxpool.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tc.conv2d_maxpool_reference(
            _t(x), _t(p["w"]), _t(p["b"]), conv, pt, pf).numpy())


def test_bf16_rounding_is_round_to_nearest_even():
    v = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -1.0 - 2.0 ** -9])
    np.testing.assert_array_equal(
        tc.round_bf16(v).numpy(),
        np.asarray(jnp.asarray(v.numpy()).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
