"""The port's data parallelism over ``torch.distributed`` ranks on the
CPU (gloo, ranks spawned by ``multihost.run_ranks`` with a file
rendezvous: no port), against the port itself in one process: the
mode-A step of two ranks against the single-process step of the whole
minibatch (the train step, the MMI step, and a Dropout net's step with
one generator), replica averaging, the lattice decode split over ranks,
and the Librispeech recipe over two ranks.

This module imports no JAX: the spawned ranks import it to find their
worker functions, and ``test_torch_parallel.py`` reuses them."""

import copy

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kaldi_cnn_tpu_torch.convert import (opt_to_numpy, params_from_jax,
                                         params_to_numpy)
from kaldi_cnn_tpu_torch.core.mesh import make_mesh, shard_batch
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.parallel.dp import average_params, make_dp_step
from kaldi_cnn_tpu_torch.parallel.multihost import (
    MultihostConfig, initialize, make_replica_average, run_ranks,
    train_multihost)
from kaldi_cnn_tpu_torch.recipes import librispeech, synthetic
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig

# a small conv net: conv 3x5 over 6x12x2 volumes, 16 filters, pool 2x2,
# one hidden pnorm layer; every update kind (Conv2D, Affine) is in it
CFG = dict(in_t=6, in_f=12, in_c=2, filt_t=3, filt_f=5, num_filters=16,
           pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=1,
           pnorm_input_dim=64, pnorm_output_dim=16, num_pdfs=20)
DIM = 6 * 12 * 2
LR = 0.05
STEPS = 3
RANK_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch and one BLAS thread: the suite runs several test
    processes at once (the GMM bootstrap's numpy ran 3x slower with
    OpenBLAS's threads contending)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def init_params(seed=0, cfg=CFG):
    """Seeded initial parameters in the JAX layout, the output affine
    drawn at random too (its init is zero)."""
    net = make_convnet(ConvnetConfig(**cfg), fused=False, device="cpu")
    net.init(torch_generator(seed, "init"))
    p = [dict(d) for d in params_to_numpy(net)]
    p[-2]["w"] = (np.random.default_rng(seed).normal(size=p[-2]["w"].shape)
                  * 0.3).astype(np.float32)
    return tuple(p)


def minibatch(n=64, seed=7):
    """n rows, zero-weight padding in the last 5."""
    r = np.random.default_rng(seed)
    w = np.ones(n, np.float32)
    w[-5:] = 0.0
    return (r.normal(size=(n, DIM)).astype(np.float32),
            r.integers(0, CFG["num_pdfs"], n).astype(np.int32), w)


def _net(init, cfg=CFG):
    net = make_convnet(ConvnetConfig(**cfg), fused=False, device="cpu")
    params_from_jax(net, init)
    return net


def mode_a_rank(rank, init, x, y, w, steps, num_replicas=1):
    """One rank's ``steps`` mode-A steps on its rows of (x, y, w):
    (params, NG states, objf per step)."""
    torch.set_num_threads(1)
    mesh = make_mesh(num_replicas, "cpu")
    net = _net(init)
    step = make_dp_step(net, mesh)
    xs, ys, ws = shard_batch(mesh, (x, y, w))
    opt, objfs = net.init_opt(), []
    for _ in range(steps):
        opt, objf = step(opt, xs, ys, LR, ws)
        objfs.append(float(objf))
    return params_to_numpy(net), opt_to_numpy(opt), objfs


def single_process(init, x, y, w, steps):
    """The same steps of ``Nnet.train_step`` on the whole minibatch."""
    net = _net(init)
    opt, objfs = net.init_opt(), []
    for _ in range(steps):
        opt, objf = net.train_step(opt, torch.as_tensor(x),
                                   torch.as_tensor(y), LR,
                                   weights=torch.as_tensor(w))
        objfs.append(float(objf))
    return params_to_numpy(net), opt_to_numpy(opt), objfs


def multihost_rank(rank, init, x, y, w, tcfg, mh, cfg=CFG):
    """``train_multihost`` on the global egs (x, y, w), ``net.init``
    replaced by ``init``: (params, NG states)."""
    torch.set_num_threads(1)
    mesh = make_mesh(mh["num_replicas"], "cpu")
    net = make_convnet(ConvnetConfig(**cfg), fused=False, device="cpu")
    net.init = lambda gen: params_from_jax(net, init)
    egs = Egs(x, y, w)
    _, opt = train_multihost(net, egs, egs, TrainConfig(**tcfg),
                             MultihostConfig(**mh), mesh=mesh)
    return params_to_numpy(net), opt_to_numpy(opt)


def leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return [v for t in tree for v in leaves(t)]
    if hasattr(tree, "_fields"):
        return [np.asarray(v) for v in tree]
    return [np.asarray(tree)]


def assert_bit_equal(a, b):
    for u, v in zip(leaves(a), leaves(b), strict=True):
        np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def mode_a():
    init = init_params()
    x, y, w = minibatch()
    return init, (x, y, w), run_ranks(mode_a_rank, 2, init, x, y, w, STEPS,
                                      timeout_s=RANK_TIMEOUT_S)


def test_mode_a_two_ranks_give_the_single_process_step(mode_a):
    """Two gloo ranks, each with half of one minibatch (sampled NG rows on
    both, zero-weight padding on rank 1), three steps: the single-process
    step on the whole minibatch within 1e-4 relative in parameters, NG
    projectors and objf; the two ranks bit-equal."""
    from test_torch_ngsgd import assert_state_close
    init, (x, y, w), ranks = mode_a
    want_p, want_o, want_objf = single_process(init, x, y, w, STEPS)
    (p0, o0, objf0), (p1, o1, objf1) = ranks
    assert_bit_equal((p0, o0, objf0), (p1, o1, objf1))
    np.testing.assert_allclose(objf0, want_objf, rtol=1e-4)
    for got, want in zip(p0, want_p):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6)
    for got, want in zip(o0, want_o):
        assert sorted(got) == sorted(want)
        for side in got:
            assert_state_close(got[side], want[side])


def test_mode_a_at_world_size_one_is_the_single_process_step():
    """A process group of one rank changes no bit: its packed all-reduces
    are the identity, and its strided row samples are the slices the
    single-process step takes (the card's recipe runs so, over NCCL)."""
    init = init_params(2)
    x, y, w = minibatch(seed=4)
    (got,) = run_ranks(mode_a_rank, 1, init, x, y, w, STEPS,
                       timeout_s=RANK_TIMEOUT_S)
    assert_bit_equal(got, single_process(init, x, y, w, STEPS))


def replica_rank(rank, init, x, y, w):
    """Two replicas of one rank each: one step on its own rows, then the
    replica average."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, "cpu")
    net = _net(init)
    sl = slice(rank * len(y) // 2, (rank + 1) * len(y) // 2)
    make_dp_step(net, mesh)(net.init_opt(), x[sl], y[sl], LR, w[sl])
    # a copy: on the CPU, params_to_numpy's arrays share the parameters'
    # memory
    before = copy.deepcopy(params_to_numpy(net))
    make_replica_average(mesh)(net)
    return before, params_to_numpy(net)


def test_replica_average_is_the_mean_of_the_streams():
    """Two ranks as two replicas: each steps on its half alone (its own
    single-process step), and the average leaves both with the mean of
    the two streams' parameters."""
    init = init_params(1)
    x, y, w = minibatch(seed=9)
    (b0, a0), (b1, a1) = run_ranks(replica_rank, 2, init, x, y, w,
                                   timeout_s=RANK_TIMEOUT_S)
    assert_bit_equal(a0, a1)
    for r, before in enumerate((b0, b1)):
        sl = slice(r * 32, (r + 1) * 32)
        want, _, _ = single_process(init, x[sl], y[sl], w[sl], 1)
        assert_bit_equal(before, want)
    mean = average_params([b0, b1])
    for got, want in zip(a0, mean):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7)


def mmi_batch(n=64, seed=5):
    """n rows with a one-hot numerator and a random denominator."""
    r = np.random.default_rng(seed)
    P = CFG["num_pdfs"]
    num = np.zeros((n, P), np.float32)
    num[np.arange(n), r.integers(0, P, n)] = 1.0
    return (r.normal(size=(n, DIM)).astype(np.float32), num,
            r.dirichlet(np.ones(P), size=n).astype(np.float32))


def disc_steps(net, x, num, den, steps, group=None):
    """``steps`` discriminative steps: (params, NG states, objfs)."""
    opt, objfs = net.init_opt(), []
    for _ in range(steps):
        opt, objf = net.discriminative_step(
            opt, torch.as_tensor(x), torch.as_tensor(num),
            torch.as_tensor(den), LR, group=group)
        objfs.append(float(objf))
    return params_to_numpy(net), opt_to_numpy(opt), objfs


def dropout_net():
    """Affine -> Tanh -> Dropout(0.4) -> Affine -> Softmax over DIM."""
    from kaldi_cnn_tpu_torch.models.components import (
        AffineComponent, DropoutComponent, SoftmaxComponent, TanhComponent)
    from kaldi_cnn_tpu_torch.models.nnet import Nnet
    net = Nnet([AffineComponent(DIM, 24, device="cpu"),
                TanhComponent(24), DropoutComponent(24, 0.4),
                AffineComponent(24, CFG["num_pdfs"], device="cpu"),
                SoftmaxComponent(CFG["num_pdfs"])])
    return net.init(torch_generator(3, "init"))


def dropout_steps(net, x, y, steps, step_fn=None):
    """``steps`` train steps, step s with generator (11, "mh_step", s)."""
    opt, objfs = net.init_opt(), []
    for s in range(steps):
        gen = torch_generator(11, "mh_step", s)
        if step_fn is None:
            opt, objf = net.train_step(opt, torch.as_tensor(x),
                                       torch.as_tensor(y), LR,
                                       generator=gen)
        else:
            opt, objf = step_fn(opt, x, y, LR, None, gen)
        objfs.append(float(objf))
    return params_to_numpy(net), opt_to_numpy(opt), objfs


def disc_rank(rank, init, x, num, den, steps):
    """One rank's mode-A discriminative steps on its rows of (x, num,
    den), then a Dropout net's mode-A train steps on its rows of x."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, "cpu")
    xs, ns, ds = shard_batch(mesh, (x, num, den))
    disc = disc_steps(_net(init), xs, ns, ds, steps, mesh.data_group)
    net = dropout_net()
    y = num.argmax(axis=1).astype(np.int32)
    xs, ys = shard_batch(mesh, (x, y))
    drop = dropout_steps(net, xs, ys, steps, make_dp_step(net, mesh))
    return disc, drop


@pytest.fixture(scope="module")
def disc_two_ranks():
    init = init_params(4)
    x, num, den = mmi_batch()
    return init, (x, num, den), run_ranks(disc_rank, 2, init, x, num, den,
                                          STEPS, timeout_s=RANK_TIMEOUT_S)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_discriminative_step_at_world_size_one_is_bit_equal():
    """The MMI step over a group of one rank changes no bit."""
    init = init_params(5)
    x, num, den = mmi_batch(seed=6)
    ((got, _),) = run_ranks(disc_rank, 1, init, x, num, den, STEPS,
                            timeout_s=RANK_TIMEOUT_S)
    assert_bit_equal(got, disc_steps(_net(init), x, num, den, STEPS))


def test_discriminative_step_over_two_ranks(disc_two_ranks):
    """Two gloo ranks, each with half of the frames: the single-process
    MMI step within PARAM_REL (relative Frobenius, as chip_smoke.py) in
    every parameter tensor, objf within 1e-4; the ranks bit-equal."""
    from test_torch_ngsgd import assert_state_close
    init, (x, num, den), ((d0, _), (d1, _)) = disc_two_ranks
    assert_bit_equal(d0, d1)
    want_p, want_o, want_objf = disc_steps(_net(init), x, num, den, STEPS)
    np.testing.assert_allclose(d0[2], want_objf, rtol=0, atol=1e-4)
    for got, want in zip(d0[0], want_p):
        for k in want:
            assert _rel(got[k], want[k]) < 1e-3, k
    for got, want in zip(d0[1], want_o):
        for side in got:
            assert_state_close(got[side], want[side])


def test_dropout_mode_a_over_two_ranks_is_the_single_process_step(
        disc_two_ranks):
    """Each rank draws the global minibatch's mask from the shared
    generator and keeps its rows: the single-process steps with the same
    generators (within 1e-4), the ranks bit-equal."""
    _, (x, num, _), ((_, r0), (_, r1)) = disc_two_ranks
    assert_bit_equal(r0, r1)
    y = num.argmax(axis=1).astype(np.int32)
    want_p, _, want_objf = dropout_steps(dropout_net(), x, y, STEPS)
    np.testing.assert_allclose(r0[2], want_objf, rtol=1e-4)
    for got, want in zip(r0[0], want_p):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6)
    # the mask mattered: without the generator the steps differ
    net = dropout_net()
    opt, objf = net.train_step(net.init_opt(), torch.as_tensor(x),
                               torch.as_tensor(y), LR)
    assert abs(float(objf) - want_objf[0]) > 1e-4


def tiny_graph():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    lang = Lang.create(lex)
    return CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())


def random_loglikes(num_pdfs, lengths=(31, 47, 140, 22, 60), seed=3):
    r = np.random.default_rng(seed)
    return {f"utt{i:02d}": r.normal(-8.0, 2.0, (t, num_pdfs)).astype(
        np.float32) for i, t in enumerate(lengths)}


DECODE = dict(acoustic_scale=0.1, beam=12.0, lattice_beam=4.0,
              max_active=64, batch_size=2, device="cpu")


def decode_rank(rank, lls):
    torch.set_num_threads(1)
    mesh = make_mesh(1, "cpu")
    return decode_utterances(tiny_graph(), lls, group=mesh.world_group,
                             **DECODE)


def test_decode_utterances_over_two_ranks_equals_one_process():
    """Each rank decodes the utterances at its sorted positions and
    returns every lattice: key for key the lattices of the call without a
    group."""
    g = tiny_graph()
    lls = random_loglikes(int(g.e_pdf.max()) + 1)
    want = decode_utterances(g, lls, **DECODE)
    assert min(lat.num_arcs for lat in want.values()) > 0
    got0, got1 = run_ranks(decode_rank, 2, lls, timeout_s=RANK_TIMEOUT_S)
    for got in (got0, got1):
        assert sorted(got) == sorted(want)
        for u in want:
            a, b = got[u], want[u]
            assert (a.num_states, a.start) == (b.num_states, b.start)
            for k in ("state_time", "arc_src", "arc_dst", "arc_ilabel",
                      "arc_olabel", "arc_graph", "arc_acoustic",
                      "final_graph"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                              err_msg=f"{u} {k}")


def test_initialize_refuses_a_group_it_cannot_take():
    """Several processes need a coordinator; an initialized group of
    another backend or size is refused."""
    with pytest.raises(ValueError, match="coordinator"):
        initialize(MultihostConfig(num_processes=2), "cpu")


def test_replicas_without_averaging_are_refused():
    """Several replicas need average_every > 0: unaveraged, each would
    train its own model on its own rows.  ``initialize`` refuses the
    config before it makes a group, and ``train_multihost`` over two gloo
    ranks as two replicas refuses on both ranks before any step."""
    with pytest.raises(ValueError, match="average_every > 0"):
        initialize(MultihostConfig(num_replicas=2), "cpu")
    x, y, w = minibatch()
    with pytest.raises(Exception, match="average_every > 0"):
        run_ranks(multihost_rank, 2, init_params(), x, y, w,
                  dict(num_epochs=1, minibatch_size=16),
                  dict(num_replicas=2, average_every=0),
                  timeout_s=RANK_TIMEOUT_S)


@pytest.mark.parametrize("replicas", [1, 2])
def test_rank_check_holds_two_ranks_to_world_size_one(replicas):
    """``parallel/rank_check.py``, the card's two-rank check, on the CPU
    at the small net: the two ranks bit-equal, and within 1e-4 of world
    size 1 in objf and parameters."""
    from kaldi_cnn_tpu_torch.parallel import rank_check
    cfg = ConvnetConfig(**CFG)
    res = rank_check.two_ranks_vs_one(
        cfg, rank_check.seeded_case(cfg, 3, 64), STEPS, LR, replicas, "cpu",
        timeout_s=RANK_TIMEOUT_S)
    assert res["ranks_equal"]
    assert res["objf_err"] <= 1e-4 and res["param_rel"] <= 1e-4
    assert res["launches"] == ((0, 0), (0, 0))


def one_batch(graph, lls, **kw):
    """The recipe's decode in one batch padded to the longest utterance,
    where its buckets of 128 frames make the CPU frame loop run up to
    2.5x the frames: each utterance's search is its own row's, so no
    lattice changes."""
    kw.update(batch_size=len(lls), bucket_frames=-(-max(
        ll.shape[0] for ll in lls.values()) // 32) * 32)
    return decode_utterances(graph, lls, **kw)


def recipe_rank(rank, kw):
    """librispeech.run as rank ``rank`` of 2: (its result without the
    timings, the transition-id -> pdf maps its decode graphs got, the pdf
    counts its priors came from)."""
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    torch.set_num_threads(1)
    maps, counts = [], []

    class Recorded(CompiledGraph):
        def __init__(self, fst, tid2pdf):
            maps.append(np.asarray(tid2pdf))
            super().__init__(fst, tid2pdf)

    set_priors = AmNnet.set_priors_from_counts

    def recorded_priors(am, c, *a, **k):
        counts.append(np.asarray(c))
        return set_priors(am, c, *a, **k)

    librispeech.CompiledGraph = Recorded
    librispeech.decode_utterances = one_batch
    AmNnet.set_priors_from_counts = recorded_priors
    with threadpool_limits(1):
        res = librispeech.run(
            mh=MultihostConfig(num_processes=2, process_id=rank),
            device="cpu", **kw)
    return ({k: v for k, v in res.items()
             if k not in ("seconds", "train_audio_ss")}, maps, counts)


def test_recipe_over_two_ranks_trains_one_model(tmp_path):
    """librispeech.run over 2 gloo ranks: rank 0 bootstraps on the whole
    training set, so both ranks decode with one tree and one num_pdfs
    (ROADMAP 3.15); each rank's egs go to its own store under egs_dir
    (3.17); both take their priors from the pdf counts of both stores
    (3.16); and they return the same result."""
    egs_dir = str(tmp_path / "egs")
    (r0, m0, c0), (r1, m1, c1) = run_ranks(
        recipe_rank, 2, dict(num_utts=24, nnet_epochs=2, num_filters=8,
                             seed=71, egs_dir=egs_dir), timeout_s=300.0)
    assert len(m0) == len(m1) == 1
    np.testing.assert_array_equal(m0[0], m1[0])
    assert r0 == r1
    assert (r0["num_devices"], r0["backend"]) == (2, "gloo")
    assert r0["tree_leaves"] > int(m0[0].max())
    assert r0["words"] > 0 and r0["missing_utts"] == 0
    from kaldi_cnn_tpu_torch.train.sharded_egs import ShardedEgs
    stores = [ShardedEgs(f"{egs_dir}/rank{k}") for k in (0, 1)]
    assert min(len(st) for st in stores) > 0
    want = sum(np.bincount(st.load_shard(i)[1], minlength=len(c0[0]))
               for st in stores for i in range(st.num_shards))
    assert len(c0) == len(c1) == 1
    np.testing.assert_array_equal(c0[0], want)
    np.testing.assert_array_equal(c1[0], want)
