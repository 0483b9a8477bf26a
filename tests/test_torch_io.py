"""Parity of the port's ``io/`` with the JAX package's, on the CPU: the
verbatim twins (``io/wave.py``, ``io/kaldi_io.py``) by source text and by
files written by one package and read by the other; and the ``.mdl``
model files (a small CNN: Conv2D, Maxpool, Affine, Pnorm, Normalize,
Softmax; a GMM), written by each package and read by the other with
bit-equal parameters, the port's loglikes within LOGLIKE_ATOL of the JAX
package's, and the nnet2 chain's components read as the port's own."""

import os

import jax
import numpy as np
import pytest

from kaldi_cnn_tpu.gmm.am_gmm import AmDiagGmm as JAmGmm
from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm as JDiagGmm
from kaldi_cnn_tpu.io import kaldi_io as jio
from kaldi_cnn_tpu.io import kaldi_model as jkm
from kaldi_cnn_tpu.io import wave as jwave
from kaldi_cnn_tpu.lang.topology import HmmTopology
from kaldi_cnn_tpu.lang.transition_model import (MonophoneContextDependency,
                                                 TransitionModel)
from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet, Nnet as JNnet
from kaldi_cnn_tpu_torch.convert import params_to_numpy
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_cnn_tpu_torch.io import kaldi_io as tio
from kaldi_cnn_tpu_torch.io import kaldi_model as tkm
from kaldi_cnn_tpu_torch.io import wave as twave
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models.nnet import AmNnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGLIKE_ATOL = 1e-4       # unfused f32 loglikes, port vs JAX
CFG = dict(in_t=6, in_f=12, in_c=3, filt_t=3, filt_f=5, num_filters=8,
           pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=1,
           pnorm_input_dim=32, pnorm_output_dim=8, num_pdfs=9)


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


@pytest.mark.parametrize("path", ["io/wave.py", "io/kaldi_io.py"])
def test_io_twins_are_verbatim(path):
    assert _source(f"kaldi_cnn_tpu_torch/{path}") == _source(
        f"kaldi_cnn_tpu/{path}").replace("from kaldi_cnn_tpu.",
                                         "from kaldi_cnn_tpu_torch.")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wave_and_ark_files_cross_read(tmp_path, writer):
    rng = np.random.default_rng(3)
    w, r = (twave, jwave) if writer == "port" else (jwave, twave)
    samples = np.round(rng.normal(size=(2, 700)) * 3000)
    w.write_wave(str(tmp_path / "a.wav"), samples, 8000)
    got, rate = r.read_wave(str(tmp_path / "a.wav"))
    assert rate == 8000.0
    np.testing.assert_array_equal(got, samples.astype(np.float32))
    w, r = (tio, jio) if writer == "port" else (jio, tio)
    data = {"u1": rng.normal(size=(5, 3)).astype(np.float32),
            "u2": rng.normal(size=4),
            "u3": np.arange(6, dtype=np.int32)}
    w.write_ark(str(tmp_path / "a.ark"), data, str(tmp_path / "a.scp"))
    for read in (lambda: r.read_ark(str(tmp_path / "a.ark")),
                 lambda: r.read_scp(str(tmp_path / "a.scp"))):
        back = dict(read())
        assert list(back) == list(data)
        for k in data:
            assert back[k].dtype == data[k].dtype
            np.testing.assert_array_equal(back[k], data[k])


def make_tm():
    topo = HmmTopology([1, 2, 3])
    return TransitionModel(topo, MonophoneContextDependency(topo))


@pytest.fixture(scope="module")
def jax_cnn():
    """A JAX CNN with seeded parameters (the output affine drawn at
    random, so that the posteriors vary), priors and a transition model."""
    net = j_make_convnet(JCfg(**CFG), use_pallas=False)
    params = [dict(d) for d in jax.device_get(net.init(jax.random.PRNGKey(4)))]
    params = [{k: np.asarray(v, np.float32) for k, v in d.items()}
              for d in params]
    params[-2]["w"] = np.random.default_rng(4).normal(
        size=params[-2]["w"].shape).astype(np.float32)
    priors = np.random.default_rng(0).dirichlet(np.ones(9)).astype(
        np.float32)
    x = np.random.default_rng(1).normal(size=(23, net.input_dim)).astype(
        np.float32)
    return net, tuple(params), priors, x


def _jax_loglikes(net, params, priors, x):
    am = JAmNnet(net, len(priors))
    am.priors = np.asarray(priors, np.float64)
    return np.asarray(am.loglikes(params, x))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cnn_mdl_cross_read(tmp_path, jax_cnn, writer):
    """A .mdl written by one package reads in the other: the same
    components and transition model, bit-equal parameters and priors,
    and loglikes within LOGLIKE_ATOL (the port unfused)."""
    net, params, priors, x = jax_cnn
    path = str(tmp_path / "cnn.mdl")
    tm = make_tm()
    jkm.write_am_nnet(path, tm, net, params, priors)
    if writer == "port":       # read by the port, written again by it
        tm1, tnet, _, pri = tkm.read_am_nnet(path, device="cpu")
        tkm.write_am_nnet(path, tm1, tnet, priors=pri)
        tm2, jnet2, jparams2, priors2 = jkm.read_am_nnet(path)
        assert [type(c).__name__ for c in jnet2.components] == [
            type(c).__name__ for c in net.components]
        got_params = jparams2
    else:
        tm2, tnet, tparams, priors2 = tkm.read_am_nnet(path, device="cpu")
        assert [type(c).__name__ for c in tnet.components] == [
            type(c).__name__ for c in net.components]
        assert tnet.components[0].fused     # the counterpart of use_pallas
        got_params = params_to_numpy(tnet)
        for a, b in zip(tparams, got_params):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert tm2.tuples == tm.tuples
    np.testing.assert_array_equal(tm2.log_probs.astype(np.float32),
                                  tm.log_probs.astype(np.float32))
    np.testing.assert_array_equal(priors2, priors)
    assert len(got_params) == len(params)
    for a, b in zip(got_params, params):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    want = _jax_loglikes(net, params, priors, x)
    if writer == "port":
        got = _jax_loglikes(jnet2, jparams2, priors2, x)
    else:
        tnet.components[0].fused = False
        am = AmNnet(tnet, len(priors2))
        am.priors = np.asarray(priors2, np.float64)
        got = am.loglikes(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGLIKE_ATOL)


def test_port_mdl_rewrites_byte_identical(tmp_path, jax_cnn):
    net, params, priors, _ = jax_cnn
    a, b = str(tmp_path / "a.mdl"), str(tmp_path / "b.mdl")
    jkm.write_am_nnet(a, make_tm(), net, params, priors)
    tm, tnet, tparams, pri = tkm.read_am_nnet(a, device="cpu")
    tkm.write_am_nnet(b, tm, tnet, tparams, pri)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("comp", [
    "TanhComponent", "SigmoidComponent", "RectifiedLinearComponent",
    "DropoutComponent", "FixedAffineComponent", "SpliceComponent"])
def test_unported_component_raises_not_implemented(tmp_path, comp):
    """The six components the port once refused (with
    NotImplementedError) now read: a JAX-written model that starts with
    one loads as the port's class with the same parameters, and writes
    back byte for byte."""
    first = {"TanhComponent": lambda: JC.TanhComponent(dim=4),
             "SigmoidComponent": lambda: JC.SigmoidComponent(dim=4),
             "RectifiedLinearComponent":
                 lambda: JC.RectifiedLinearComponent(dim=4),
             "DropoutComponent": lambda: JC.DropoutComponent(
                 dim=4, proportion=0.5),
             "FixedAffineComponent": lambda: JC.FixedAffineComponent.
                 from_matrix(np.eye(4, dtype=np.float32),
                             np.zeros(4, np.float32)),
             "SpliceComponent": lambda: JC.SpliceComponent(
                 input_dim=4, left_context=0, right_context=0)}[comp]()
    net = JNnet([first, JC.AffineComponent(4, 9), JC.SoftmaxComponent(9)])
    params = [{}, {"w": np.zeros((9, 4), np.float32),
                   "b": np.zeros(9, np.float32)}, {}]
    path, back = str(tmp_path / "x.mdl"), str(tmp_path / "y.mdl")
    jkm.write_am_nnet(path, make_tm(), net, params)
    tm, tnet, tparams, pri = tkm.read_am_nnet(path, device="cpu")
    assert type(tnet.components[0]).__name__ == comp
    assert type(tnet.components[0]) is getattr(TC, comp)
    if comp == "FixedAffineComponent":
        np.testing.assert_array_equal(params_to_numpy(tnet)[0]["w"],
                                      np.eye(4, dtype=np.float32))
    tkm.write_am_nnet(back, tm, tnet, None, pri)
    assert open(path, "rb").read() == open(back, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gmm_mdl_cross_read(tmp_path, writer):
    rng = np.random.default_rng(7)
    tm = make_tm()
    parts = [(rng.dirichlet(np.ones(3)), rng.normal(size=(3, 5)),
              rng.uniform(0.5, 2.0, size=(3, 5))) for _ in range(tm.num_pdfs)]
    path = str(tmp_path / "gmm.mdl")
    w, r, G, A = ((jkm, tkm, JDiagGmm, JAmGmm) if writer == "jax"
                  else (tkm, jkm, DiagGmm, AmDiagGmm))
    w.write_gmm_model(path, tm, A([G(*p) for p in parts]))
    tm2, am2 = r.read_gmm_model(path)
    assert tm2.tuples == tm.tuples
    assert type(am2).__module__.startswith(
        "kaldi_cnn_tpu_torch" if writer == "jax" else "kaldi_cnn_tpu.")
    for g, (wt, mu, var) in zip(am2.gmms, parts):
        for got, want in ((g.weights, wt), (g.means, mu), (g.vars, var)):
            np.testing.assert_array_equal(got, want.astype(np.float32))
    feats = rng.normal(size=(6, 5)).astype(np.float32)
    want = JAmGmm([JDiagGmm(*p) for p in parts])
    np.testing.assert_allclose(am2.loglikes(feats), want.loglikes(feats),
                               rtol=1e-5, atol=1e-4)
