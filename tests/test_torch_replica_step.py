"""Mode B in one process: the port's ``make_replica_step`` (R = 4, the
CPU) against the JAX package's on a 4-device CPU mesh, on
``tests/test_parallel_modes.py``'s small net and data: each replica's
parameters (rtol 1e-4 / atol 1e-5) and NG states (by projector,
``assert_state_close``) after 5 steps, and the reference semantics:
the replicas diverge, averaging reconciles them and the objective
rises by more than 0.3."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from kaldi_cnn_tpu.parallel import dp as jdp
from kaldi_cnn_tpu_torch.convert import opt_from_jax, params_from_jax
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models.components import param_tree
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.parallel import dp
from test_parallel_modes import _data, _net
from test_torch_ngsgd import assert_state_close

R, ROWS, STEPS, LR = 4, 64, 5, 0.1


def port_net() -> Nnet:
    """``test_parallel_modes._net`` in the port."""
    return Nnet([
        TC.AffineComponent(12, 32, device="cpu"),
        TC.PnormComponent(32, 8),
        TC.NormalizeComponent(8),
        TC.AffineComponent(8, 8, param_stddev=0.0, device="cpu"),
        TC.SoftmaxComponent(8),
    ], ng_update_period=2)


@pytest.fixture(scope="module")
def runs():
    """The JAX and port replicas after STEPS steps on the same rows."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(1234)
    jnet = _net()
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    x, y = _data(rng, n=R * ROWS)
    x_r, y_r = x.reshape(R, ROWS, -1), y.reshape(R, ROWS)
    mesh = JMesh(np.array(jax.devices()[:R]), ("data",))
    jstep = jdp.make_replica_step(jnet, mesh, R)
    jp = jdp.stack_replicas(params, R)
    jo = jdp.stack_replicas(jnet.init_opt(), R)
    jobjf = []
    for _ in range(STEPS):
        jp, jo, o = jstep(jp, jo, x_r, y_r, LR)
        jobjf.append(np.asarray(o))
    net = port_net()
    params_from_jax(net, params)
    step = dp.make_replica_step(net, None, R)
    p0 = tuple(param_tree(c, lambda _, t: t.detach().clone())
               for c in net.components)
    tp = dp.stack_replicas(p0, R)
    to = dp.stack_replicas(opt_from_jax(jax.device_get(jnet.init_opt()),
                                        device="cpu"), R)
    tobjf = []
    for _ in range(STEPS):
        tp, to, o = step(tp, to, x_r, y_r, LR)
        tobjf.append(o.numpy())
    return dict(jnet=jnet, net=net, params=params, x=x, y=y, x_r=x_r,
                y_r=y_r, jp=jax.device_get(jp), jo=jax.device_get(jo),
                jobjf=np.array(jobjf), tp=tp, to=to, tobjf=np.array(tobjf),
                step=step)


def test_each_replica_matches_jax(runs):
    np.testing.assert_allclose(runs["tobjf"], runs["jobjf"], rtol=1e-5,
                               atol=1e-5)
    for r in range(R):
        for c, (tc, jc) in enumerate(zip(runs["tp"][r], runs["jp"])):
            for k in tc:
                np.testing.assert_allclose(
                    tc[k].numpy(), np.asarray(jc[k])[r], rtol=1e-4,
                    atol=1e-5, err_msg=f"replica {r} component {c} {k}")


def test_each_replica_ng_state_matches_jax(runs):
    compared = 0
    for r in range(R):
        for to, jo in zip(runs["to"][r], runs["jo"]):
            for side in to:
                want = jax.tree_util.tree_map(lambda a: np.asarray(a)[r],
                                              jo[side])
                assert_state_close(to[side], want)
                compared += 1
    assert compared == R * 4


def test_replicas_diverge_and_averaging_reconciles(runs):
    """The reference semantics of tests/test_parallel_modes.py: after
    each 5 steps the replicas differ, their mean is one model, and 6
    such rounds raise the objective by more than 0.3."""
    net, step = runs["net"], runs["step"]
    x, y, x_r, y_r = runs["x"], runs["y"], runs["x_r"], runs["y_r"]
    dp.set_params(net, runs["params"])
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    objf0 = float(net.objf(xt, yt))
    p0 = tuple(param_tree(c, lambda _, t: t.detach().clone())
               for c in net.components)
    tp = dp.stack_replicas(p0, R)
    to = dp.stack_replicas(net.init_opt(), R)
    for outer in range(6):
        for s in range(5):
            tp, to, _ = step(tp, to, x_r, y_r, LR,
                             indices_r=[outer * 5 + s] * R)
        w = [p[0]["w"] for p in tp]
        assert all(not torch.equal(w[0], w[r]) for r in range(1, R))
        avg = dp.average_replicas(tp)
        tp = dp.stack_replicas(avg, R)
        to = dp.stack_replicas(dp.average_replicas(to), R)
        assert all(torch.equal(tp[0][0]["w"], tp[r][0]["w"])
                   for r in range(1, R))
    dp.set_params(net, dp.average_replicas(tp))
    assert float(net.objf(xt, yt)) > objf0 + 0.3
