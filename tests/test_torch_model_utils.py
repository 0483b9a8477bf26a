"""Parity of the port's ``models/utils.py`` (SumGroupComponent,
``estimate_feature_transform``, ``mixup_nnet``, ``fix_nnet``) with the
JAX package's on the inputs of ``tests/test_model_utils.py``, and a
``.mdl`` holding all six nnet2 chain components written by the JAX
package, read by the port (the same loglikes) and written back byte for
byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.io import kaldi_model as jkm
from kaldi_cnn_tpu.lang.topology import HmmTopology
from kaldi_cnn_tpu.lang.transition_model import (MonophoneContextDependency,
                                                 TransitionModel)
from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet, Nnet as JNnet
from kaldi_cnn_tpu.models import utils as JU
from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.io import kaldi_model as tkm
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models import utils as TU
from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet

LOGLIKE_ATOL = 1e-4


def _params(net, seed):
    return tuple({k: np.asarray(v, np.float32) for k, v in d.items()}
                 for d in jax.device_get(net.init(jax.random.PRNGKey(seed))))


def _port_net(jnet, params):
    """The port's twin of a JAX net of Affine/Tanh/ReLU/Softmax, on the
    CPU, holding ``params``."""
    comps = []
    for c in jnet.components:
        if isinstance(c, JC.AffineComponent):
            comps.append(TC.AffineComponent(c.input_dim, c.output_dim,
                                            max_change=c.max_change,
                                            device="cpu"))
        else:
            comps.append(getattr(TC, type(c).__name__)(dim=c.dim))
    net = Nnet(comps, ng_update_period=jnet.ng_in.update_period)
    params_from_jax(net, params)
    return net


def test_sum_group_component(rng):
    j = JU.SumGroupComponent(sizes=(2, 3, 1))
    t = TU.SumGroupComponent(sizes=(2, 3, 1))
    x = rng.normal(size=(4, 6)).astype(np.float32)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    y_j, _ = j.forward({}, jnp.asarray(x))
    y_t = t(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)
    dx_j = j.backprop({}, x, y_j, jnp.asarray(d), None)
    dx_t = t.backprop(torch.from_numpy(x), y_t, torch.from_numpy(d), None)
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))
    assert (t.input_dim, t.output_dim) == (6, 3)


def test_estimate_feature_transform(rng):
    centers = rng.normal(size=(5, 12)).astype(np.float32) * 3
    y = rng.integers(0, 5, 600)
    x = (centers[y] + rng.normal(size=(600, 12))).astype(np.float32)
    p = JU.estimate_feature_transform(x, y).init(None)
    ft = TU.estimate_feature_transform(x, y, device="cpu")
    assert isinstance(ft, TC.FixedAffineComponent)
    np.testing.assert_allclose(ft.w.numpy(), np.asarray(p["w"]), atol=1e-4)
    np.testing.assert_allclose(ft.b.numpy(), np.asarray(p["b"]), atol=1e-4)
    assert list(ft.parameters()) == []          # buffers: not trained


def _mixup_net():
    return JNnet([JC.AffineComponent(input_dim=10, output_dim=20),
                  JC.TanhComponent(dim=20),
                  JC.AffineComponent(input_dim=20, output_dim=6,
                                     param_stddev=0.3),
                  JC.SoftmaxComponent(dim=6)])


@pytest.mark.parametrize("perturb", [0.0, 0.01])
def test_mixup_nnet_matches_jax(rng, perturb):
    jnet = _mixup_net()
    params = _params(jnet, 1)
    net = _port_net(jnet, params)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    before = net.predict(torch.from_numpy(x)).numpy()
    jnet2, jparams2 = JU.mixup_nnet(jnet, params, target_components=18,
                                    seed=5, perturb=perturb)
    net2 = TU.mixup_nnet(net, target_components=18, seed=5,
                         perturb=perturb)
    assert [type(c).__name__ for c in net2.components] == [
        type(c).__name__ for c in jnet2.components]
    got = params_to_numpy(net2)
    for g, w in zip(got, jparams2):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    after = net2.predict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        after, np.asarray(jnet2.predict(jparams2, jnp.asarray(x))),
        atol=1e-5)
    if perturb == 0.0:
        np.testing.assert_allclose(after, before, atol=1e-4)
    # the copy trains on its own: the source net's parameters stay
    opt = net2.init_opt()
    labels = torch.as_tensor(rng.integers(0, 6, 32))
    net2.train_step(opt, torch.from_numpy(x), labels, 0.1)
    np.testing.assert_array_equal(params_to_numpy(net)[0]["w"],
                                  params[0]["w"])


@pytest.mark.parametrize("kind", ["tanh", "relu"])
def test_fix_nnet_matches_jax(rng, kind):
    nonlin = (JC.TanhComponent(dim=10) if kind == "tanh"
              else JC.RectifiedLinearComponent(dim=10))
    jnet = JNnet([JC.AffineComponent(input_dim=8, output_dim=10), nonlin,
                  JC.AffineComponent(input_dim=10, output_dim=4,
                                     param_stddev=0.0),
                  JC.SoftmaxComponent(dim=4)])
    params = [dict(p) for p in _params(jnet, 0)]
    if kind == "tanh":       # blow up the first affine: tanh saturates
        params[0]["w"] = params[0]["w"] * 100.0
    else:                    # three units never fire
        params[0]["b"] = params[0]["b"].copy()
        params[0]["b"][[1, 4, 7]] = -1e3
    params = tuple(params)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    fixed = JU.fix_nnet(jnet, params, x)
    net = _port_net(jnet, params)
    n = TU.fix_nnet(net, x)
    got = params_to_numpy(net)
    changed = np.flatnonzero(np.asarray(fixed[0]["b"]) != params[0]["b"])
    assert n == len(changed) > 0
    for k in ("w", "b"):
        np.testing.assert_allclose(got[0][k], np.asarray(fixed[0][k]),
                                   rtol=1e-6, atol=0)


def _tm():
    topo = HmmTopology([1, 2, 3])
    return TransitionModel(topo, MonophoneContextDependency(topo))


def test_mdl_with_every_nnet2_component(tmp_path):
    """Splice -> FixedAffine -> Affine -> ReLU -> Affine -> Tanh ->
    Sigmoid -> Dropout -> Affine -> Softmax, written by the JAX package."""
    rng = np.random.default_rng(8)
    mat = rng.normal(size=(12, 16)).astype(np.float32) * 0.3
    jnet = JNnet([
        JC.SpliceComponent(input_dim=4, left_context=1, right_context=2),
        JC.FixedAffineComponent.from_matrix(mat, rng.normal(size=12)
                                            .astype(np.float32)),
        JC.AffineComponent(12, 10), JC.RectifiedLinearComponent(dim=10),
        JC.AffineComponent(10, 10), JC.TanhComponent(dim=10),
        JC.SigmoidComponent(dim=10),
        JC.DropoutComponent(dim=10, proportion=0.25),
        JC.AffineComponent(10, 9), JC.SoftmaxComponent(dim=9)])
    params = _params(jnet, 3)
    priors = rng.dirichlet(np.ones(9)).astype(np.float32)
    a, b = str(tmp_path / "a.mdl"), str(tmp_path / "b.mdl")
    jkm.write_am_nnet(a, _tm(), jnet, params, priors)
    tm, net, tparams, pri = tkm.read_am_nnet(a, device="cpu")
    assert [type(c).__name__ for c in net.components] == [
        type(c).__name__ for c in jnet.components]
    assert net.components[7].proportion == 0.25
    for g, w in zip(params_to_numpy(net), params):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    feats = rng.normal(size=(23, 4)).astype(np.float32)
    jam = JAmNnet(jnet, 9)
    jam.priors = priors.astype(np.float64)
    am = AmNnet(net, 9)
    am.priors = np.asarray(pri, np.float64)
    np.testing.assert_allclose(am.loglikes(feats), jam.loglikes(params, feats),
                               atol=LOGLIKE_ATOL)
    tkm.write_am_nnet(b, tm, net, None, pri)
    assert open(a, "rb").read() == open(b, "rb").read()
