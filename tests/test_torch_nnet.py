"""Parity of the port's CNN acoustic model with the JAX package: the
components, Nnet.predict (unfused and with the fused conv+maxpool pair),
AmNnet loglikes, and params_from_jax."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet
from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.ops import conv as tc

CFG = dict(in_t=6, in_f=12, in_c=2, filt_t=3, filt_f=5, num_filters=16,
           pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=2,
           pnorm_input_dim=64, pnorm_output_dim=16, num_pdfs=20)


def _jax_params(net, seed=0):
    """JAX init with the output affine redrawn (its init is all zero)."""
    p = [dict(d) for d in jax.device_get(net.init(jax.random.PRNGKey(seed)))]
    rng = np.random.default_rng(seed)
    p[-2]["w"] = (rng.normal(size=p[-2]["w"].shape) * 0.3
                  ).astype(np.float32)
    return tuple(p)


def _pair(fused):
    jnet = j_make_convnet(JCfg(**CFG), use_pallas=fused)
    tnet = make_convnet(ConvnetConfig(**CFG), fused=fused, device="cpu")
    p = _jax_params(jnet)
    params_from_jax(tnet, p)
    x = np.random.default_rng(7).normal(
        size=(11, jnet.input_dim)).astype(np.float32)
    return jnet, tnet, p, x


@pytest.mark.parametrize("fused,rtol,atol", [(False, 1e-4, 1e-6),
                                             (True, 2e-2, 2e-3)])
def test_predict_matches_jax(fused, rtol, atol):
    """Unfused: f32 throughout, against JAX use_pallas=False.  Fused: the
    conv+maxpool pair rounds its operands to bf16, against JAX
    use_pallas=True (the Pallas kernel in interpret mode)."""
    jnet, tnet, p, x = _pair(fused)
    want = np.asarray(jnet.predict(p, jnp.asarray(x)))
    got = tnet.predict(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (11, CFG["num_pdfs"])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_forward_is_the_unfused_predict():
    _, tnet, _, x = _pair(True)
    x = torch.as_tensor(x)
    before = tc.conv2d_maxpool.launches
    fused = tnet.predict(x)
    for c in tnet.components:
        if isinstance(c, TC.Conv2DComponent):
            c.fused = False
    np.testing.assert_array_equal(tnet.forward(x).numpy(),
                                  tnet.predict(x).numpy())
    assert np.abs(fused.numpy() - tnet.forward(x).numpy()).max() < 2e-3
    assert tc.conv2d_maxpool.launches == before       # CPU: plain version


@pytest.mark.parametrize("name", ["affine", "pnorm", "normalize",
                                  "softmax"])
def test_components_match_jax(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 24)).astype(np.float32) * 3
    if name == "affine":
        jc = JC.AffineComponent(24, 10)
        tcomp = TC.AffineComponent(24, 10, device="cpu")
        p = jax.device_get(jc.init(jax.random.PRNGKey(1)))
        with torch.no_grad():
            tcomp.w.copy_(torch.as_tensor(np.array(p["w"])))
            tcomp.b.copy_(torch.as_tensor(np.array(p["b"])))
    elif name == "pnorm":
        jc, tcomp, p = JC.PnormComponent(24, 6), TC.PnormComponent(24, 6), {}
    elif name == "normalize":
        jc, tcomp, p = JC.NormalizeComponent(24), TC.NormalizeComponent(24), {}
    else:
        jc, tcomp, p = JC.SoftmaxComponent(24), TC.SoftmaxComponent(24), {}
    want = np.asarray(jc.forward(p, jnp.asarray(x))[0])
    np.testing.assert_allclose(tcomp(torch.as_tensor(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_loglikes_batch_matches_jax():
    jnet, tnet, p, _ = _pair(True)
    rng = np.random.default_rng(11)
    feats = {f"u{i}": rng.normal(size=(n, jnet.input_dim)).astype(
        np.float32) for i, n in enumerate((13, 1, 30))}
    counts = rng.integers(1, 50, size=CFG["num_pdfs"])
    jam, tam = JAmNnet(jnet, CFG["num_pdfs"]), AmNnet(tnet, CFG["num_pdfs"])
    jam.set_priors_from_counts(counts)
    params_from_jax(tam, p, priors=jam.priors)
    want = jam.loglikes_batch(p, feats, batch_size=16)
    got = tam.loglikes_batch(feats, batch_size=16)
    assert list(got) == list(want)
    for u in feats:
        assert got[u].dtype == np.float32
        np.testing.assert_allclose(got[u], want[u], rtol=0, atol=1e-3)
        # one padded stream == per-utterance scoring
        np.testing.assert_allclose(tam.loglikes(feats[u], batch_size=8),
                                   got[u], rtol=0, atol=1e-5)
    tam2 = AmNnet(tnet, CFG["num_pdfs"])
    tam2.set_priors_from_counts(counts)
    np.testing.assert_array_equal(tam2.priors, jam.priors)


def test_params_from_jax_round_trips_and_checks():
    jnet, tnet, p, _ = _pair(False)
    back = params_to_numpy(tnet)
    assert len(back) == len(p)
    for a, b in zip(back, p):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bad = [dict(d) for d in p]
    bad[0]["w"] = bad[0]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tnet, bad)
    with pytest.raises(ValueError, match="components"):
        params_from_jax(tnet, p[:-1])
    with pytest.raises(TypeError, match="AmNnet"):
        params_from_jax(tnet, p, priors=np.ones(CFG["num_pdfs"]))


def test_init_mirrors_jax_distributions():
    net = make_convnet(ConvnetConfig(**CFG), device="cpu").init(
        torch_generator(0, "i"))
    conv, aff, out = net.components[0], net.components[2], net.components[-2]
    assert conv.w.std().item() == pytest.approx(1 / np.sqrt(30), rel=0.2)
    assert conv.b.std().item() == pytest.approx(0.1, rel=0.4)
    assert aff.w.std().item() == pytest.approx(
        1 / np.sqrt(aff.input_dim), rel=0.1)
    assert aff.b.std().item() == pytest.approx(1.0, rel=0.3)
    assert float(out.w.abs().max()) == 0.0             # param_stddev=0
    again = make_convnet(ConvnetConfig(**CFG), device="cpu").init(
        torch_generator(0, "i"))
    for a, b in zip(params_to_numpy(net), params_to_numpy(again)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert net.input_dim == 6 * 12 * 2 and net.output_dim == 20
