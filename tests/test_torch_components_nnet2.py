"""Parity of the port's nnet2 chain components (FixedAffine, Tanh,
Sigmoid, RectifiedLinear, Dropout, Splice) with the JAX package's on the
same numpy inputs, on the CPU: forward and backprop within 1e-5, Dropout
at proportion 0 and with the JAX mask given to the port's backprop, and
the port's own Dropout mask (kept fraction, 1 / keep scale, the same
seed giving the same mask)."""

import jax
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models import components as TC

ATOL = 1e-5
N = 9                   # rows (frames, for Splice)


def _pair(name):
    """(JAX component, its params, port component on the CPU, in dim)."""
    rng = np.random.default_rng(11)
    if name == "FixedAffine":
        mat = rng.normal(size=(5, 7)).astype(np.float32)
        bias = rng.normal(size=5).astype(np.float32)
        j = JC.FixedAffineComponent.from_matrix(mat, bias)
        return (j, j.init(None), TC.FixedAffineComponent.from_matrix(
            mat, bias, device="cpu"), 7)
    if name == "Splice":
        return (JC.SpliceComponent(input_dim=3, left_context=2,
                                   right_context=1), {},
                TC.SpliceComponent(input_dim=3, left_context=2,
                                   right_context=1), 3)
    if name == "Dropout":
        return (JC.DropoutComponent(dim=6, proportion=0.5), {},
                TC.DropoutComponent(dim=6, proportion=0.5), 6)
    cls = {"Tanh": "TanhComponent", "Sigmoid": "SigmoidComponent",
           "RectifiedLinear": "RectifiedLinearComponent"}[name]
    return getattr(JC, cls)(dim=6), {}, getattr(TC, cls)(dim=6), 6


@pytest.mark.parametrize("name", ["FixedAffine", "Tanh", "Sigmoid",
                                  "RectifiedLinear", "Dropout", "Splice"])
def test_forward_and_backprop_match_jax(name):
    jc, jp, tc, d_in = _pair(name)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, d_in)).astype(np.float32) * 2
    y_j, aux_j = jc.forward(jp, x)
    y_j = np.asarray(y_j)
    deriv = rng.normal(size=y_j.shape).astype(np.float32)
    dx_j = np.asarray(jc.backprop(jp, x, y_j, deriv, aux_j))

    xt = torch.from_numpy(x)
    y_t = tc(xt)
    y_tr, aux_t = tc.train_forward(xt)
    dx_t = tc.backprop(xt, y_tr, torch.from_numpy(deriv), aux_t)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(y_tr.numpy(), y_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dx_t.numpy(), dx_j, atol=ATOL, rtol=0)
    assert dx_t.shape == (N, d_in)


def test_splice_backprop_accumulates_edge_duplicates():
    """Frame 0 fills every slot that reaches past the left edge: three at
    t = 0, two at t = 1 and one at t = 2."""
    tc = TC.SpliceComponent(input_dim=1, left_context=2, right_context=0)
    x = torch.arange(4, dtype=torch.float32)[:, None]
    dx = tc.backprop(x, tc(x), torch.ones(4, 3), None)
    assert dx[:, 0].tolist() == [6.0, 3.0, 2.0, 1.0]


def test_dropout_at_proportion_zero_matches_jax():
    jc = JC.DropoutComponent(dim=6, proportion=0.0)
    tc = TC.DropoutComponent(dim=6, proportion=0.0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    deriv = rng.normal(size=(N, 6)).astype(np.float32)
    y_j, mask_j = jc.forward({}, x, train=True, key=jax.random.PRNGKey(0))
    dx_j = jc.backprop({}, x, y_j, deriv, mask_j)
    y_t, aux = tc.train_forward(torch.from_numpy(x),
                                torch_generator(0, "dropout"))
    dx_t = tc.backprop(torch.from_numpy(x), y_t, torch.from_numpy(deriv),
                       aux)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))


def test_dropout_backprop_with_the_jax_mask():
    jc = JC.DropoutComponent(dim=6, proportion=0.3)
    tc = TC.DropoutComponent(dim=6, proportion=0.3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    deriv = rng.normal(size=(N, 6)).astype(np.float32)
    y_j, mask_j = jc.forward({}, x, train=True, key=jax.random.PRNGKey(7))
    mask = np.asarray(mask_j)
    assert 0 < (mask == 0).sum() < mask.size
    dx_j = np.asarray(jc.backprop({}, x, y_j, deriv, mask_j))
    dx_t = tc.backprop(torch.from_numpy(x),
                       torch.from_numpy(np.array(y_j)),
                       torch.from_numpy(deriv),
                       torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(dx_t.numpy(), dx_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(x * mask, np.asarray(y_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_mask_keeps_its_fraction_scaled(dtype):
    p, n, dim = 0.3, 500, 200
    tc = TC.DropoutComponent(dim=dim, proportion=p)
    x = torch.ones((n, dim), dtype=dtype)
    y, mask = tc.train_forward(x, torch_generator(9, "train_step", 4))
    keep = 1.0 - p
    assert mask.dtype == dtype and y.dtype == dtype
    scale = float(1.0 / torch.tensor(keep, dtype=dtype))
    assert set(torch.unique(mask.float()).tolist()) == {0.0, scale}
    frac = float((mask != 0).float().mean())
    sd = (keep * p / mask.numel()) ** 0.5
    assert abs(frac - keep) < 5 * sd
    torch.testing.assert_close(y, x * mask, atol=0, rtol=0)
    _, again = tc.train_forward(x, torch_generator(9, "train_step", 4))
    _, other = tc.train_forward(x, torch_generator(9, "train_step", 5))
    assert torch.equal(mask, again) and not torch.equal(mask, other)
    # eval forward and no generator: the input unchanged
    assert torch.equal(tc(x), x)
    assert tc.train_forward(x)[1] is None
