"""Parity of the port's NG-SGD and of its components' backprop and
update with the JAX package, on the same numpy inputs.  NG states are
compared through the projector u^T diag(d) u and rho: eigenvectors are
defined only up to sign."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu.models import ng_sgd as jng
from kaldi_cnn_tpu_torch.convert import opt_from_jax
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models import ng_sgd as tng

RTOL = 1e-4          # f32 math in other summation orders, and eigh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on the CPU's cores at once:
    one torch thread each keeps the many small ops here from contending
    for cores (OpenMP spinning made them over 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def assert_state_close(got: tng.NGState, want, rtol=RTOL):
    """Compare the Fisher estimate F = u^T diag(d) u + rho (I - u^T u)
    by rho and the projector u^T diag(d - rho) u, its entries within
    rtol of the largest.  Eigenvector signs are free, and a row of u
    whose d equals rho (no energy in that direction yet) is an arbitrary
    unit vector that F, and so the preconditioner, does not see."""
    def proj(s):
        u = np.asarray(s.u, np.float64)
        e = np.asarray(s.d, np.float64) - np.float64(s.rho)
        return u.T @ (e[:, None] * u)
    assert got.t == int(want.t)
    np.testing.assert_allclose(float(got.rho), float(want.rho), rtol=rtol)
    pw = proj(want)
    np.testing.assert_allclose(proj(got), pw, rtol=0,
                               atol=rtol * np.abs(pw).max())


def _params(jc, seed):
    return {k: np.asarray(v) for k, v in
            jax.device_get(jc.init(jax.random.PRNGKey(seed))).items()}


def _load(tc, p):
    with torch.no_grad():
        for k, v in p.items():
            getattr(tc, k).copy_(_t(v))


def _pair(name):
    """(JAX component, port component, params) at a small size."""
    if name == "affine":
        jc, tc = JC.AffineComponent(24, 10), TC.AffineComponent(
            24, 10, device="cpu")
    elif name == "conv2d":
        args = (6, 12, 2, 3, 5, 8)
        jc, tc = JC.Conv2DComponent(*args), TC.Conv2DComponent(*args,
                                                              device="cpu")
    elif name == "maxpool":
        args = (4, 6, 8, 2, 3, 2)
        jc, tc = (JC.Maxpooling3DComponent(*args),
                  TC.Maxpooling3DComponent(*args))
    elif name == "pnorm":
        jc, tc = JC.PnormComponent(24, 6), TC.PnormComponent(24, 6)
    elif name == "normalize":
        jc, tc = JC.NormalizeComponent(24), TC.NormalizeComponent(24)
    else:
        jc, tc = JC.SoftmaxComponent(24), TC.SoftmaxComponent(24)
    p = _params(jc, 1)
    _load(tc, p)
    return jc, tc, p


@pytest.mark.parametrize("name", ["affine", "conv2d", "maxpool", "pnorm",
                                  "normalize", "softmax"])
def test_backprop_matches_jax(name):
    jc, tc, p = _pair(name)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(7, tc.input_dim if hasattr(tc, "input_dim")
                          else tc.dim)) * 2).astype(np.float32)
    y, aux = jc.forward(p, jnp.asarray(x), train=True)
    d = rng.normal(size=y.shape).astype(np.float32)
    want = np.asarray(jc.backprop(p, jnp.asarray(x), y, jnp.asarray(d), aux))
    ty, taux = tc.train_forward(_t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-6)
    got = tc.backprop(_t(x), ty, _t(d), taux)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["affine", "conv2d"])
def test_update_matches_jax(name):
    """Three successive NG-SGD updates from identical params and states:
    params within RTOL, states by projector."""
    jc, tc, p = _pair(name)
    ng_in = jng.OnlineNaturalGradient(rank=6, update_period=2,
                                      warmup_updates=1)
    ng_out = jng.OnlineNaturalGradient(rank=5, update_period=2,
                                       warmup_updates=1)
    t_in = tng.OnlineNaturalGradient(rank=6, update_period=2,
                                     warmup_updates=1)
    t_out = tng.OnlineNaturalGradient(rank=5, update_period=2,
                                      warmup_updates=1)
    jopt = jc.init_opt(ng_in, ng_out)
    topt = tc.init_opt(t_in, t_out)
    rng = np.random.default_rng(5)
    for step in range(3):
        x = rng.normal(size=(16, tc.input_dim)).astype(np.float32)
        d = rng.normal(size=(16, tc.output_dim)).astype(np.float32)
        p, jopt = jc.update(p, jopt, jnp.asarray(x), jnp.asarray(d), 0.05,
                            ng_in, ng_out)
        topt = tc.update(topt, _t(x), _t(d), 0.05, t_in, t_out)
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       np.asarray(p[k]), rtol=RTOL,
                                       atol=1e-6)
        for side in ("ng_in", "ng_out"):
            assert_state_close(topt[side], jopt[side])


def _ng_pair(**kw):
    return jng.OnlineNaturalGradient(**kw), tng.OnlineNaturalGradient(**kw)


def test_fused_ng_delta_and_stats_match_jax():
    rng = np.random.default_rng(7)
    (ji, ti), (jo, to) = _ng_pair(rank=6, eta=0.2), _ng_pair(rank=5, eta=0.2)
    js_in, js_out = ji.init(13), jo.init(9)
    ts_in, ts_out = ti.init(13, "cpu"), to.init(9, "cpu")
    for _ in range(4):
        x = rng.normal(size=(40, 13)).astype(np.float32)
        d = rng.normal(size=(40, 9)).astype(np.float32)
        want, js_in, js_out = jng.fused_ng_delta(
            ji, jo, js_in, js_out, jnp.asarray(x), jnp.asarray(d))
        got, ts_in2, ts_out2 = tng.fused_ng_delta(ti, to, ts_in, ts_out,
                                                  _t(x), _t(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-6)
        # ng_delta_from_stats is the algebraic core of fused_ng_delta
        g = _t(d).T @ _t(x)
        pi, po = _t(x) @ ts_in.u.T, _t(d) @ ts_out.u.T
        core, _, _ = tng.ng_delta_from_stats(
            ti, to, ts_in, ts_out, g, (_t(x) ** 2).sum(),
            (pi * pi).sum(0), (_t(d) ** 2).sum(), (po * po).sum(0),
            ti.sample_rows(_t(x)), to.sample_rows(_t(d)), 40)
        np.testing.assert_allclose(core.numpy(), got.numpy(), rtol=1e-6,
                                   atol=1e-7)
        ts_in, ts_out = ts_in2, ts_out2
        assert_state_close(ts_in, js_in)
        assert_state_close(ts_out, js_out)


def test_ng_affine_apply_matches_jax():
    rng = np.random.default_rng(8)
    (ji, ti), (jo, to) = (_ng_pair(rank=6, update_period=2),
                          _ng_pair(rank=5, update_period=2))
    js_in, js_out = ji.init(25), jo.init(12)
    ts_in, ts_out = ti.init(25, "cpu"), to.init(12, "cpu")
    w = rng.normal(size=(12, 24)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    jw, jb, tw, tb = jnp.asarray(w), jnp.asarray(b), _t(w), _t(b)
    for _ in range(5):
        x = rng.normal(size=(48, 24)).astype(np.float32)
        d = rng.normal(size=(48, 12)).astype(np.float32)
        jw, jb, js_in, js_out = jng.ng_affine_apply(
            ji, jo, js_in, js_out, jnp.asarray(x), jnp.asarray(d), jw, jb,
            0.05, 0.4)
        tw, tb, ts_in, ts_out = tng.ng_affine_apply(
            ti, to, ts_in, ts_out, _t(x), _t(d), tw, tb, 0.05, 0.4)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL,
                                   atol=1e-6)
        assert_state_close(ts_in, js_in)
        assert_state_close(ts_out, js_out)


def test_precondition_matches_jax_and_keeps_the_norm():
    rng = np.random.default_rng(9)
    jn, tn = _ng_pair(rank=4, eta=0.5)
    js, ts = jn.init(16), tn.init(16, "cpu")
    for _ in range(6):
        x = rng.normal(size=(32, 16)).astype(np.float32)
        x[:, 0] *= 20.0
        jx, js = jn.precondition(js, jnp.asarray(x))
        tx, ts = tn.precondition(ts, _t(x))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=1e-5)
        assert float(tx.norm()) == pytest.approx(float(np.linalg.norm(x)),
                                                 rel=1e-4)
    assert_state_close(ts, js)


def test_ng_affine_apply_matches_fused():
    """Port twin of the JAX test of the same name: the factored affine
    update equals the materialized fused_ng_delta([x|1], d) path."""
    rng = np.random.default_rng(1234)
    ng_in = tng.OnlineNaturalGradient(rank=6, eta=0.2, update_period=2)
    ng_out = tng.OnlineNaturalGradient(rank=5, eta=0.2, update_period=2)
    din, dout, n = 24, 12, 48
    st_in, st_out = ng_in.init(din + 1, "cpu"), ng_out.init(dout, "cpu")
    w = _t(rng.normal(size=(dout, din)))
    b = _t(rng.normal(size=(dout,)))
    lr, max_change = 0.05, 0.4
    for _ in range(6):
        x = _t(rng.normal(size=(n, din)))
        d = _t(rng.normal(size=(n, dout)))
        in_ext = torch.cat([x, torch.ones(n, 1)], dim=1)
        delta, ref_in, ref_out = tng.fused_ng_delta(
            ng_in, ng_out, st_in, st_out, in_ext, d)
        norm = torch.sqrt((delta * delta).sum()) * abs(lr)
        scale = torch.clamp_max(max_change / torch.clamp_min(norm, 1e-20),
                                1.0)
        ref_w = w + lr * scale * delta[:, :-1]
        ref_b = b + lr * scale * delta[:, -1]
        new_w, new_b, st_in2, st_out2 = tng.ng_affine_apply(
            ng_in, ng_out, st_in, st_out, x, d, w, b, lr, max_change)
        np.testing.assert_allclose(new_w.numpy(), ref_w.numpy(), rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(new_b.numpy(), ref_b.numpy(), rtol=5e-3,
                                   atol=5e-4)
        for got, ref in ((st_in2, ref_in), (st_out2, ref_out)):
            np.testing.assert_allclose(got.u.numpy(), ref.u.numpy(),
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(got.d.numpy(), ref.d.numpy(),
                                       rtol=2e-4, atol=2e-4)
        w, b, st_in, st_out = new_w, new_b, st_in2, st_out2


def test_update_gate_is_decided_on_the_host():
    ng = tng.OnlineNaturalGradient(rank=3, update_period=4,
                                   warmup_updates=2)
    st = ng.init(8, "cpu")
    x = torch.randn(10, 8, generator=torch.Generator().manual_seed(0))
    us = []
    for _ in range(8):
        new = ng.maybe_update_from_sample(st, ng.sample_rows(x),
                                          (x * x).sum() / 10)
        us.append(new.u is not st.u)
        assert isinstance(new.t, int) and new.t == st.t + 1
        st = new
    # warm-up steps 0, 1, then every 4th step count
    assert us == [True, True, False, False, True, False, False, False]
    bad = ng.maybe_update_from_sample(st._replace(t=0),
                                      torch.full((3, 8), float("nan")),
                                      torch.tensor(1.0))
    assert torch.equal(bad.u, st.u) and torch.equal(bad.d, st.d)
