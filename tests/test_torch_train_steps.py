"""Parity of the port's multi-step training (``Nnet.train_steps``,
``TrainConfig.scan_steps``) with the JAX package's (``Nnet.train_steps``
through ``lax.scan``, ``train_nnet``'s groups) on the same numpy inputs,
and the CPU run of what the card runs as CUDA graphs: a group cut
around every refreshing step (``models/step_graphs.py``'s ``Plan``)
equal to the eager steps bit for bit."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.train.egs import Egs as JEgs
from kaldi_cnn_tpu.train.trainer import (TrainConfig as JTrainConfig,
                                         train_nnet as j_train_nnet)
from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.models import components as C
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.ng_sgd import NGState
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.models.step_graphs import Plan, ng_states
from kaldi_cnn_tpu_torch.ops import common
from kaldi_cnn_tpu_torch.ops import conv as tconv
from kaldi_cnn_tpu_torch.ops import fbank as tfbank
from kaldi_cnn_tpu_torch.ops import maxpool as tmp
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet
from test_torch_ngsgd import assert_state_close
from test_torch_train import CFG, _assert_params_close, _nets

# the trainer's default group, so that the JAX net's scanned group
# compiles once for the module
K = 8
# a short NG warm-up and period, so that a group has open and closed gates
WARMUP, PERIOD = 2, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test process (the suite runs several at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _short_gates(*nets):
    for net in nets:
        for ng in (net.ng_in, net.ng_out):
            ng.warmup_updates, ng.update_period = WARMUP, PERIOD
    return nets


@pytest.fixture(scope="module")
def jax_net():
    """One JAX net with the short gates and its initial parameters for the
    module: its jits (init, the scanned group of K steps, the single
    step, the objf) compile once."""
    jnet, _, p = _nets()
    _short_gates(jnet)
    return jnet, p


def _port_net(p):
    """The port's net of ``CFG`` on the CPU with the JAX parameters ``p``
    and the short gates."""
    net = make_convnet(ConvnetConfig(**CFG), fused=False, device="cpu")
    params_from_jax(net, p)
    return _short_gates(net)[0]


def _groups(n_groups, seed=9, rows=64, dim=144, pdfs=20):
    """n_groups of K minibatches: xs [K, N, D], labels, weights (the last
    rows of each minibatch at weight 0, as the batcher's padding), lrs."""
    r = np.random.default_rng(seed)
    out = []
    for g in range(n_groups):
        w = np.ones((K, rows), np.float32)
        w[:, -5:] = 0.0
        out.append((r.normal(size=(K, rows, dim)).astype(np.float32),
                    r.integers(0, pdfs, (K, rows)).astype(np.int32), w,
                    (0.05 * 0.9 ** (g * K + np.arange(K))).astype(
                        np.float32)))
    return out


def test_train_steps_matches_jax(jax_net):
    """K = 8 steps a group on a conv + maxpool + affine net, NG warm-up 2
    and period 3: after one group objf 1e-5, parameters rtol 1e-4 and
    the NG states by projector; over 3 groups (24 steps) every step's
    objf 1e-4 and then parameters rtol 2e-3 (``test_torch_swbd.py``'s
    20-step bounds)."""
    jnet, p = jax_net
    tnet = _port_net(p)
    jopt, topt = jnet.init_opt(), tnet.init_opt()
    for g, (xs, ys, ws, lrs) in enumerate(_groups(3)):
        p, jopt, jobjf = jnet.train_steps(
            p, jopt, jnp.asarray(xs), jnp.asarray(ys), lrs,
            weights=jnp.asarray(ws))
        topt, tobjf = tnet.train_steps(topt, xs, ys, lrs, weights=ws)
        assert tobjf.shape == (K,)
        np.testing.assert_allclose(tobjf.numpy(), np.asarray(jobjf),
                                   rtol=0, atol=1e-5 if g == 0 else 1e-4)
        if g == 0:
            _assert_params_close(tnet, p, 1e-4)
            for got, want in zip(topt, jopt):
                for side in got:
                    assert_state_close(got[side], want[side])
    _assert_params_close(tnet, p, 2e-3, atol=2e-4)
    assert [s.t for _, s in ng_states(topt)] == [3 * K] * 8


def test_train_steps_takes_per_step_arrays_one_lr_and_generators(jax_net):
    """Sequences of per-step arrays and one learning rate for the group
    give the [K, ...] arrays' result; with K generators a Dropout net's
    group equals K ``train_step`` calls with those generators (masks,
    parameters and the generators' states after)."""
    net = _port_net(jax_net[1])
    other = copy.deepcopy(net)
    xs, ys, ws, _ = _groups(1)[0]
    opt_a, objf_a = net.train_steps(net.init_opt(), xs, ys, 0.05,
                                    weights=ws)
    opt_b, objf_b = other.train_steps(other.init_opt(), list(xs), list(ys),
                                      [0.05] * K, weights=list(ws))
    assert torch.equal(objf_a, objf_b)
    for a, b in zip(net.parameters(), other.parameters()):
        assert torch.equal(a, b)

    dnn = Nnet([C.AffineComponent(144, 64, device="cpu"),
                C.RectifiedLinearComponent(64), C.DropoutComponent(64, 0.3),
                C.AffineComponent(64, 20, device="cpu"),
                C.SoftmaxComponent(20)])
    dnn.init(torch_generator(3, "init"))
    ref = copy.deepcopy(dnn)
    gens = [torch_generator(3, "train_step", k) for k in range(K)]
    gens_ref = [torch_generator(3, "train_step", k) for k in range(K)]
    _, objfs = dnn.train_steps(dnn.init_opt(), xs, ys, 0.05, weights=ws,
                               generators=gens)
    opt = ref.init_opt()
    for k in range(K):
        opt, objf = ref.train_step(opt, torch.as_tensor(xs[k]),
                                   torch.as_tensor(ys[k]), 0.05,
                                   weights=torch.as_tensor(ws[k]),
                                   generator=gens_ref[k])
        assert float(objfs[k]) == float(objf)
    for a, b in zip(dnn.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(gens, gens_ref))
    assert dnn.draws_masks() and not net.draws_masks()


@pytest.mark.parametrize("t0,k_steps", [(0, 6), (5, 6), (64, 3)])
def test_cut_steps_equal_eager_steps_bit_for_bit(jax_net, t0, k_steps):
    """What the card replays, run eagerly on the CPU: K steps on inputs at
    fixed addresses, each refreshing step cut around its eighs (its
    Grams stashed in the states' slots, eigh, then the tail that
    finishes the states), the NG states in fixed storage.  Objfs,
    parameters and states equal K eager ``train_step`` calls, bit for
    bit, in the warm-up, across the period and with no refresh at
    all."""
    net = _port_net(jax_net[1])
    if t0 >= 64:
        for ng in (net.ng_in, net.ng_out):
            ng.update_period = 100          # no gate opens in the group
    ref = copy.deepcopy(net)
    xs, ys, ws, lrs = (a[:k_steps] for a in _groups(1)[0])
    opt = tuple({k: v._replace(t=t0) for k, v in o.items()}
                for o in net.init_opt())
    storage = [NGState(s.u.clone(), s.d.clone(), s.rho.clone(), s.t)
               for _, s in ng_states(opt)]
    slots = {}
    plan = Plan(net, {"x": torch.as_tensor(xs),
                      "y": torch.as_tensor(ys).long(),
                      "w": torch.as_tensor(ws), "lr": torch.as_tensor(lrs)},
                storage, slots)
    plan.run_eager(opt)
    want = opt
    for k in range(k_steps):
        want, objf = ref.train_step(want, torch.as_tensor(xs[k]),
                                    torch.as_tensor(ys[k]), float(lrs[k]),
                                    weights=torch.as_tensor(ws[k]))
        assert float(plan.objf[k]) == float(objf), k
    for a, b in zip(net.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    for got, (_, w) in zip(storage, ng_states(want)):
        assert (torch.equal(got.u, w.u) and torch.equal(got.d, w.d)
                and torch.equal(got.rho, w.rho))
    # a slot for every state exactly when some step refreshed
    assert len(slots) == (0 if t0 >= 64 else len(storage))


@pytest.mark.parametrize("t0", [0, 64])
def test_cut_discriminative_steps_equal_eager_steps_bit_for_bit(jax_net,
                                                                t0):
    """What the card replays for ``Nnet.discriminative_step``: one-step
    plans of the discriminative kind, one a length (40 and 56 rows in
    turn), on one fixed storage of the NG states, each refreshing step
    cut around its eighs.  Objfs, parameters and states equal
    ``discriminative_step_eager`` calls bit for bit, in the NG warm-up
    and past it (period 3: open and closed gates)."""
    net = _port_net(jax_net[1])
    ref = copy.deepcopy(net)
    r = np.random.default_rng(5)
    opt = tuple({k: v._replace(t=t0) for k, v in o.items()}
                for o in net.init_opt())
    storage = [NGState(s.u.clone(), s.d.clone(), s.rho.clone(), s.t)
               for _, s in ng_states(opt)]
    plans, want, lr = {}, opt, 0.002
    for n in (40, 56, 40, 56, 40):
        x = r.normal(size=(n, 144)).astype(np.float32)
        num = np.eye(20, dtype=np.float32)[r.integers(0, 20, n)]
        den = r.random((n, 20)).astype(np.float32)
        den /= den.sum(axis=1, keepdims=True)
        if n not in plans:
            plans[n] = Plan(net, {"x": torch.zeros(1, n, 144),
                                  "num": torch.zeros(1, n, 20),
                                  "den": torch.zeros(1, n, 20),
                                  "lr": torch.zeros(1)}, storage, {})
        plan = plans[n]
        for k, v in (("x", x), ("num", num), ("den", den),
                     ("lr", np.float32([lr]))):
            plan.inputs[k].copy_(torch.as_tensor(v).reshape(
                plan.inputs[k].shape))
        plan.run_eager(opt)
        opt = plan.opt(opt, 1)
        want, objf = ref.discriminative_step_eager(want, x, num, den, lr)
        assert float(plan.objf[0]) == float(objf), n
    for a, b in zip(net.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    for got, (_, w) in zip(storage, ng_states(want)):
        assert (torch.equal(got.u, w.u) and torch.equal(got.d, w.d)
                and torch.equal(got.rho, w.rho) and got.t + 5 == w.t)


def _trainer_data(n=700, dim=144, pdfs=20, seed=11):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(pdfs, dim)).astype(np.float32)
    y = r.integers(0, pdfs, n).astype(np.int32)
    x = (centers[y] + r.normal(size=(n, dim))).astype(np.float32)
    return x, y, np.ones(n, np.float32)


def test_train_nnet_scan_steps_matches_jax_and_per_step(jax_net,
                                                        monkeypatch):
    """``train_nnet(scan_steps=8)`` over 2 epochs of 10 minibatches (one
    group of 8 and a trailing partial group of 2 run step by step, the
    last minibatch padded at weight 0), with the short NG gates: the same
    as the port's ``scan_steps=1`` bit for bit, and within rtol 2e-3 of
    the JAX ``train_nnet(scan_steps=8)`` (``tests/test_nnet_train.py``'s
    scan-vs-per-step check, across packages)."""
    jnet = jax_net[0]
    x, y, w = _trainer_data()
    kw = dict(num_epochs=2, minibatch_size=64, initial_learning_rate=0.05,
              final_learning_rate=0.01, combine_num_models=2, seed=4)
    tr, va = slice(100, None), slice(None, 100)
    jparams, jopt = j_train_nnet(jnet, JEgs(x[tr], y[tr], w[tr]),
                                 JEgs(x[va], y[va], w[va]),
                                 JTrainConfig(scan_steps=8, **kw))
    jinit = jax.device_get(jnet.init(jax.random.PRNGKey(
        int(stage_key(4, "init")[1]))))
    groups = []

    def run(scan):
        net = make_convnet(ConvnetConfig(**CFG), fused=False, device="cpu")
        _short_gates(net)
        monkeypatch.setattr(net, "init",
                            lambda gen: params_from_jax(net, jinit))
        steps = net.train_steps

        def counted(opt, xs, *a, **k):
            groups.append((scan, len(xs)))
            return steps(opt, xs, *a, **k)

        monkeypatch.setattr(net, "train_steps", counted)
        params, opt = train_nnet(net, Egs(x[tr], y[tr], w[tr]),
                                 Egs(x[va], y[va], w[va]),
                                 TrainConfig(scan_steps=scan, **kw))
        return net, params, opt

    net8, p8, opt8 = run(8)
    net1, p1, opt1 = run(1)
    assert [k for s, k in groups if s == 8] == [8, 1, 1] * 2
    assert [k for s, k in groups if s == 1] == [1] * 20
    for a, b in zip(params_to_numpy(net8), params_to_numpy(net1)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for (_, a), (_, b) in zip(ng_states(opt8), ng_states(opt1)):
        assert torch.equal(a.u, b.u) and a.t == b.t == 20
    for got, want in zip(p8, jax.device_get(jparams)):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-3, atol=2e-4)
    _assert_params_close(net8, jparams, 2e-3, atol=2e-4)
    assert [o["ng_in"].t for o in opt8 if o] == \
        [int(o["ng_in"].t) for o in jopt if o]


def test_kernel_wrappers_register_their_launch_counts():
    """Every kernel wrapper with a launch count is registered, so that a
    CUDA graph's replay can add the launches it captured; the counts
    read and restore as a tuple."""
    wrappers = [tmp.maxpool3d, tmp.maxpool3d_scalar, tmp.maxpool3d_backward,
                tmp.maxpool3d_backward_scalar, tconv.conv2d_maxpool,
                tconv.conv2d_maxpool_f32, tfbank.fbank_frames,
                tfbank.fbank_frames_mixed, tfbank.fbank_frames_table]
    assert all(any(f is g for g in common.COUNTED) for f in wrappers)
    saved = common.launch_counts()
    tmp.maxpool3d.launches += 3
    assert common.launch_counts() != saved
    common.restore_launch_counts(saved)
    assert common.launch_counts() == saved
