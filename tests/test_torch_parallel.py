"""The port's data parallelism against the JAX package's on the same
numpy inputs: ``shard_utterances`` and ``local_slice``, the model
averages, the mode-A step of two gloo ranks against ``make_dp_step`` on
the 8-device virtual mesh, and ``train_multihost`` over two ranks (mode
A, and two replicas averaged every 2 steps) against JAX's
``train_multihost`` on that mesh, at PERF.md's limits: objf 1e-3,
parameters 1e-3 relative (Frobenius, a tensor); the tensor-parallel
step of two gloo ranks (data 1 x model 2) against the single-process
step and JAX's ``make_dp_tp_step`` on the 4 x 2 mesh at JAX's own bar
(objf 1e-5, parameters rtol 1e-4 / atol 1e-5); and
``initialize_distributed`` without a coordinator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from kaldi_cnn_tpu.core.mesh import local_slice as j_local_slice
from kaldi_cnn_tpu.core.mesh import make_mesh as j_make_mesh
from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.parallel import dp as jdp
from kaldi_cnn_tpu.parallel import multihost as jmh
from kaldi_cnn_tpu.train.egs import Egs as JEgs
from kaldi_cnn_tpu.train.trainer import TrainConfig as JTrainConfig
from kaldi_cnn_tpu_torch.core.mesh import local_slice
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig
from kaldi_cnn_tpu_torch.parallel import dp, rank_check
from kaldi_cnn_tpu_torch.parallel.multihost import (MultihostConfig,
                                                    run_ranks,
                                                    shard_utterances)
from rank_jobs import run_jobs
from test_torch_ranks import (CFG, DIM, LR, RANK_TIMEOUT_S, STEPS,
                              init_params, minibatch, mode_a_rank,
                              multihost_rank)

OBJF_ATOL = 1e-3
PARAM_REL = 1e-3


def assert_params_rel(got, want, rel=PARAM_REL):
    for g, w in zip(got, jax.device_get(want), strict=True):
        assert sorted(g) == sorted(w)
        for k in g:
            w_k = np.asarray(w[k], np.float64)
            err = np.linalg.norm(np.asarray(g[k], np.float64) - w_k)
            assert err <= rel * max(np.linalg.norm(w_k), 1e-30), (k, err)


@pytest.mark.parametrize("n,procs", [(10, 3), (7, 2), (16, 4), (5, 1),
                                     (0, 2)])
def test_shard_utterances_and_local_slice_match_jax(n, procs):
    utts = [f"u{(i * 7) % (n or 1):03d}-{i}" for i in range(n)]
    for pid in range(procs):
        cfg = dict(num_processes=procs, process_id=pid)
        assert shard_utterances(utts, MultihostConfig(**cfg)) == \
            jmh.shard_utterances(utts, jmh.MultihostConfig(**cfg))
        assert local_slice(n, procs, pid) == j_local_slice(n, procs, pid)


def test_averages_match_jax():
    """average_params over a list, and stack_replicas / average_replicas
    over a list of replicas where JAX stacks a leading axis."""
    r = np.random.default_rng(2)
    trees = [({"w": r.normal(size=(3, 4)).astype(np.float32),
               "b": r.normal(size=3).astype(np.float32)}, {},
              {"parts": ({"w": r.normal(size=(2, 2)).astype(np.float32)},
                         {})}) for _ in range(3)]
    got = dp.average_params([jax.tree_util.tree_map(torch.as_tensor, t)
                             for t in trees])
    want = jdp.average_params(trees)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stacked = dp.stack_replicas(trees[0], 3)
    jstacked = jdp.stack_replicas(trees[0], 3)
    for i, t in enumerate(stacked):
        for g, w in zip(jax.tree_util.tree_leaves(t),
                        jax.tree_util.tree_leaves(jstacked), strict=True):
            np.testing.assert_array_equal(g, np.asarray(w)[i])
    got = dp.average_replicas(trees)
    want = jdp.average_replicas(jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *trees))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


# train_multihost over two ranks: (replicas, average_every)
MULTIHOST_CASES = [(1, 0), (2, 2)]


def _multihost_data():
    """(x, y, w, TrainConfig kwargs): 2 epochs of 4 minibatches of 64
    rows around 20 class centres."""
    r = np.random.default_rng(11)
    centers = r.normal(size=(CFG["num_pdfs"], DIM)).astype(np.float32)
    y = r.integers(0, CFG["num_pdfs"], 200).astype(np.int32)
    x = (centers[y] + r.normal(size=(200, DIM))).astype(np.float32)
    w = np.ones(200, np.float32)
    tcfg = dict(num_epochs=2, minibatch_size=64, initial_learning_rate=0.05,
                final_learning_rate=0.01, seed=4)
    return x, y, w, tcfg


def _jax_init():
    """The JAX net's init at train_multihost's (seed 4, "init") key."""
    return jax.device_get(j_make_convnet(JCfg(**CFG)).init(
        jax.random.PRNGKey(int(stage_key(4, "init")[1]))))


@pytest.fixture(scope="module")
def rank_runs():
    """The ranks' side of the mode-A and train_multihost tests, run in
    one spawn of two gloo ranks: {"mode_a": each rank's (params, NG
    states, objfs), (replicas, average_every): each rank's (params, NG
    states)}."""
    mx, my, mw, tcfg = _multihost_data()
    jobs = [(mode_a_rank, (init_params(), *minibatch(), STEPS))] + [
        (multihost_rank, (_jax_init(), mx, my, mw, tcfg,
                          dict(num_replicas=r, average_every=a)))
        for r, a in MULTIHOST_CASES]
    r0, r1 = run_ranks(run_jobs, 2, jobs, timeout_s=2 * RANK_TIMEOUT_S)
    return {"mode_a": (r0[0], r1[0]),
            **{case: (r0[i], r1[i])
               for i, case in enumerate(MULTIHOST_CASES, 1)}}


def test_mode_a_two_ranks_match_jax_dp_step(rank_runs):
    """Three mode-A steps: two gloo ranks each holding half of the
    minibatch against JAX's make_dp_step sharding it over 8 virtual
    devices, from the same initial weights."""
    init = init_params()
    x, y, w = minibatch()
    ranks = rank_runs["mode_a"]
    jnet = j_make_convnet(JCfg(**CFG))
    step = jdp.make_dp_step(jnet, j_make_mesh())
    params, opt, objfs = init, jnet.init_opt(), []
    for _ in range(STEPS):
        params, opt, objf = step(params, opt, x, y, LR, weights=w)
        objfs.append(float(objf))
    for p, _, o in ranks:
        np.testing.assert_allclose(o, objfs, rtol=0, atol=OBJF_ATOL)
        assert_params_rel(p, params)


@pytest.mark.parametrize("replicas,average_every", MULTIHOST_CASES)
def test_train_multihost_two_ranks_match_jax(rank_runs, replicas,
                                             average_every):
    """train_multihost for 2 epochs of 4 minibatches of 64 rows: two
    ranks in mode A (one replica), or two replicas of one rank averaged
    every 2 steps, against JAX's train_multihost on the 8-device mesh
    laid out as (replicas, 8 / replicas), the port's init replaced by
    the JAX init."""
    x, y, w, tcfg = _multihost_data()
    mh = dict(num_replicas=replicas, average_every=average_every)
    jnet = j_make_convnet(JCfg(**CFG))
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(replicas, -1),
                 ("replica", "data"))
    jparams, _ = jmh.train_multihost(
        jnet, JEgs(x, y, w), JEgs(x, y, w), JTrainConfig(**tcfg),
        jmh.MultihostConfig(**mh), mesh=mesh)
    (p0, o0), (p1, o1) = rank_runs[(replicas, average_every)]
    for p in (p0, p1):
        assert_params_rel(p, jparams)
    for a, b in zip(jax.tree_util.tree_leaves((p0, o0)),
                    jax.tree_util.tree_leaves((p1, o1)), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dp_tp_step_two_ranks_match_single_and_jax():
    """STEPS tensor-parallel steps over two gloo ranks, the two model
    shards of one data slot (every Affine layer of the net splits: its
    output dims are even), against the single-process steps on the whole
    minibatch and against JAX's make_dp_tp_step on the 4 x 2 (data x
    model) virtual mesh, within JAX's own bar for its step: objf 1e-5,
    parameters rtol 1e-4 / atol 1e-5; the two ranks bit-equal."""
    init = init_params()
    x, y, w = minibatch()
    res = rank_check.tp_two_ranks_vs_one(
        ConvnetConfig(**CFG), (init, x, y, w), STEPS, LR, device="cpu",
        timeout_s=RANK_TIMEOUT_S)
    assert res["ranks_equal"] and res["sharded"] == 2
    assert res["objf_err"] <= rank_check.TP_OBJF_ATOL
    assert res["param_excess"] <= 0.0
    jnet = j_make_convnet(JCfg(**CFG))
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2),
                 ("data", "model"))
    step = jdp.make_dp_tp_step(jnet, mesh)
    params, opt, objfs = init, jnet.init_opt(), []
    for _ in range(STEPS):
        params, opt, objf = step(params, opt, x, y, LR, weights=w)
        objfs.append(float(objf))
    np.testing.assert_allclose(res["objfs"], objfs, rtol=0,
                               atol=rank_check.TP_OBJF_ATOL)
    for g, want in zip(res["params"], jax.device_get(params), strict=True):
        assert sorted(g) == sorted(want)
        for k in g:
            np.testing.assert_allclose(g[k], np.asarray(want[k]),
                                       rtol=rank_check.TP_RTOL,
                                       atol=rank_check.TP_ATOL)


def test_initialize_distributed_without_coordinator_is_a_no_op():
    assert dp.initialize_distributed(None) is None
    assert jdp.initialize_distributed(None) is None
    assert not torch.distributed.is_initialized()
