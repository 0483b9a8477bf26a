"""Parity of the port's training path with the JAX package on the same
numpy inputs: the train step, an objf trajectory, the bf16 storage
twin, the egs batches, checkpoints both ways, ``train_nnet``, the
equal-alignment labels, and the recipe's train -> decode."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.gmm.train import align_equal as j_align_equal
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import (Lang, compile_training_graph,
                                     make_hclg_from_arpa)
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.recipes.wsj import make_cnn_egs as j_make_cnn_egs
from kaldi_cnn_tpu.train import checkpoint as jck
from kaldi_cnn_tpu.train.egs import Egs as JEgs, EgsBatcher as JBatcher
from kaldi_cnn_tpu.train import trainer as jtr
from kaldi_cnn_tpu.train.trainer import (TrainConfig as JTrainConfig,
                                         train_nnet as j_train_nnet)
from kaldi_cnn_tpu_torch.convert import (opt_from_jax, opt_to_numpy,
                                         params_from_jax, params_to_numpy)
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.gmm.train import align_equal
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.ng_sgd import NGState
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj
from kaldi_cnn_tpu_torch.train import checkpoint as tck
from kaldi_cnn_tpu_torch.train.egs import Egs, EgsBatcher
from kaldi_cnn_tpu_torch.train import trainer as ttr
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet
from test_torch_ngsgd import assert_state_close

CFG = dict(in_t=6, in_f=12, in_c=2, filt_t=3, filt_f=5, num_filters=16,
           pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=2,
           pnorm_input_dim=64, pnorm_output_dim=16, num_pdfs=20)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on the CPU's cores at once:
    one torch thread each keeps the many small ops here from contending
    for cores (OpenMP spinning made them over 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(net, seed=0):
    """JAX init with the output affine redrawn (its init is all zero)."""
    p = [dict(d) for d in jax.device_get(net.init(jax.random.PRNGKey(seed)))]
    p[-2]["w"] = (np.random.default_rng(seed).normal(size=p[-2]["w"].shape)
                  * 0.3).astype(np.float32)
    return tuple(p)


def _data(n=64, seed=7, dim=144, pdfs=20):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, dim)).astype(np.float32),
            r.integers(0, pdfs, n).astype(np.int32))


def _nets():
    jnet = j_make_convnet(JCfg(**CFG))
    tnet = make_convnet(ConvnetConfig(**CFG), fused=False, device="cpu")
    p = _jax_params(jnet)
    params_from_jax(tnet, p)
    return jnet, tnet, p


def _assert_params_close(tnet, jparams, rtol, atol=1e-6):
    for got, want in zip(params_to_numpy(tnet), jax.device_get(jparams)):
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=rtol, atol=atol)


def test_train_step_matches_jax():
    """One step of a small conv net: params rtol 1e-4, NG states by
    projector, objf to 1e-5; weighted and unweighted."""
    jnet, tnet, p = _nets()
    x, y = _data()
    w = np.ones(64, np.float32)
    w[-5:] = 0.0                                   # zero-weight padding
    jopt = jnet.init_opt()
    jp, jopt2, jobjf = jnet.train_step(p, jopt, jnp.asarray(x),
                                       jnp.asarray(y), 0.05,
                                       weights=jnp.asarray(w))
    topt, tobjf = tnet.train_step(tnet.init_opt(), torch.as_tensor(x),
                                  torch.as_tensor(y), 0.05,
                                  weights=torch.as_tensor(w))
    assert float(tobjf) == pytest.approx(float(jobjf), abs=1e-5)
    _assert_params_close(tnet, jp, 1e-4)
    for got, want in zip(topt, jopt2):
        assert sorted(got) == sorted(want)
        for side in got:
            assert_state_close(got[side], want[side])
    # unweighted == all-ones weights
    _, tnet2, _ = _nets()
    _, objf_nw = tnet2.train_step(tnet2.init_opt(), torch.as_tensor(x),
                                  torch.as_tensor(y), 0.05)
    _, _, jobjf_nw = jnet.train_step(p, jnet.init_opt(), jnp.asarray(x),
                                  jnp.asarray(y), 0.05)
    assert float(objf_nw) == pytest.approx(float(jobjf_nw), abs=1e-5)


def test_objf_trajectory_matches_jax():
    """20 steps: objf within 1e-4 at every step, NG update every step
    during the warm-up, held NG states and params close at the end."""
    jnet, tnet, p = _nets()
    x, y = _data(n=96, seed=8)
    jopt, topt = jnet.init_opt(), tnet.init_opt()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for s in range(20):
        p, jopt, jo = jnet.train_step(p, jopt, jx, jy, 0.05)
        topt, to = tnet.train_step(topt, tx, ty, 0.05)
        assert float(to) == pytest.approx(float(jo), abs=1e-4), s
    _assert_params_close(tnet, p, 2e-3, atol=2e-4)
    assert float(tnet.objf(tx, ty)) == pytest.approx(
        float(jnet.objf(p, jx, jy)), abs=1e-4)


def test_train_step_bf16_storage_matches_f32():
    """Port twin of the JAX test of the same name, from the same JAX
    init: bf16-stored activations train to where the f32 run does."""
    cfg = dict(
        in_t=6, in_f=12, in_c=1, filt_t=3, filt_f=5, num_filters=16,
        pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=1,
        pnorm_input_dim=64, pnorm_output_dim=16, num_pdfs=8)
    init = jax.device_get(j_make_convnet(JCfg(**cfg)).init(
        jax.random.PRNGKey(7)))

    def run(storage):
        net = make_convnet(ConvnetConfig(**cfg), fused=False,
                           device="cpu")
        net.train_storage_dtype = storage
        params_from_jax(net, init)
        opt = net.init_opt()
        r = np.random.default_rng(7)
        x = torch.as_tensor(r.normal(size=(64, net.input_dim))
                            .astype(np.float32))
        labels = torch.as_tensor(r.integers(0, cfg["num_pdfs"], 64))
        objfs = []
        for _ in range(50):
            opt, objf = net.train_step(opt, x, labels, 0.05)
            objfs.append(float(objf))
        return objfs

    f32 = run("float32")
    bf16 = run("bfloat16")
    assert all(np.isfinite(bf16))
    assert bf16[-1] > bf16[0] + 0.4
    assert abs(bf16[-1] - f32[-1]) < 0.05


def test_train_storage_dtype_validation():
    net = make_convnet(ConvnetConfig(**CFG), device="cpu")
    x, y = _data(n=4)
    net.train_storage_dtype = "float16"
    with pytest.raises(ValueError, match="unsupported"):
        net.train_step(net.init_opt(), torch.as_tensor(x),
                       torch.as_tensor(y), 0.1)


def test_egs_batches_match_jax():
    r = np.random.default_rng(3)
    x = r.normal(size=(45, 6)).astype(np.float32)
    y = r.integers(0, 9, 45).astype(np.int32)
    w = np.ones(45, np.float32)
    tb = EgsBatcher(Egs(x, y, w), 16, seed=5)
    jb = JBatcher(JEgs(x, y, w), 16, seed=5)
    assert tb.num_batches() == jb.num_batches() == 3
    for epoch in range(2):
        got, want = list(tb.epoch(epoch)), list(jb.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    assert got[-1][2].sum() == 45 - 32            # zero-weight padding


def _opt_equal(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for side in g:
            for a, b in zip(g[side], w[side]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoints_load_both_ways(tmp_path):
    """A JAX checkpoint loads into the port and a port checkpoint into
    JAX: same params, NG states and meta."""
    jnet, tnet, p = _nets()
    x, y = _data()
    jopt = jnet.init_opt()
    p, jopt, _ = jnet.train_step(p, jopt, jnp.asarray(x), jnp.asarray(y),
                                 0.05)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, p, jopt, {"epoch": 3})
    tparams, topt, meta = tck.load_checkpoint(
        path, params_to_numpy(tnet), tnet.init_opt())
    assert meta == {"epoch": 3}
    for a, b in zip(tparams, jax.device_get(p)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert isinstance(topt[0]["ng_in"], NGState)
    assert topt[0]["ng_in"].t == 1
    _opt_equal(topt, jax.device_get(jopt))
    # the loaded state runs in the port
    params_from_jax(tnet, tparams)
    tnet.train_step(opt_from_jax(topt, "cpu"), torch.as_tensor(x),
                    torch.as_tensor(y), 0.05)

    path = str(tmp_path / "port.npz")
    ttopt = tnet.init_opt()
    ttopt, _ = tnet.train_step(ttopt, torch.as_tensor(x),
                               torch.as_tensor(y), 0.05)
    tck.save_checkpoint(path, params_to_numpy(tnet), ttopt, {"iter": 2})
    jp, jo, meta = jck.load_checkpoint(path, p, jopt)
    assert meta == {"iter": 2}
    for a, b in zip(jp, params_to_numpy(tnet)):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    _opt_equal(opt_to_numpy(ttopt), jo)
    assert int(jo[0]["ng_in"].t) == ttopt[0]["ng_in"].t == 1
    jnet.train_step(jp, jo, jnp.asarray(x), jnp.asarray(y), 0.05)


@pytest.fixture(scope="module")
def jax_train_nnet():
    """The JAX package's train_nnet, 2 epochs on a small conv net at
    matmul_precision "float32" (on the CPU its default arithmetic), with
    its metrics records: (net config, egs arrays, TrainConfig kwargs,
    params, opt, the JAX init the port takes, the records)."""
    import io
    from kaldi_cnn_tpu.core.logging import MetricsWriter as JWriter
    cfg = dict(CFG, num_hidden_layers=1)
    r = np.random.default_rng(11)
    centers = r.normal(size=(20, 144)).astype(np.float32)
    y = r.integers(0, 20, 600).astype(np.int32)
    x = (centers[y] + r.normal(size=(600, 144))).astype(np.float32)
    w = np.ones(600, np.float32)
    kw = dict(num_epochs=2, minibatch_size=64, initial_learning_rate=0.05,
              final_learning_rate=0.01, combine_num_models=2, seed=4)
    jnet = j_make_convnet(JCfg(**cfg))
    out = io.StringIO()
    jparams, jopt = j_train_nnet(jnet, JEgs(x[100:], y[100:], w[100:]),
                                 JEgs(x[:100], y[:100], w[:100]),
                                 JTrainConfig(matmul_precision="float32",
                                              **kw),
                                 metrics=JWriter(stream=out))
    jinit = jax.device_get(jnet.init(jax.random.PRNGKey(
        int(stage_key(4, "init")[1]))))
    return cfg, (x, y, w), kw, jparams, jopt, jinit, _records(out)


def test_train_nnet_matches_jax(monkeypatch, jax_train_nnet):
    """Two epochs of train_nnet on a small conv net, the port's init
    replaced by the JAX init: final params within rtol 2e-3."""
    cfg, (x, y, w), kw, jparams, jopt, jinit, _ = jax_train_nnet
    tnet = make_convnet(ConvnetConfig(**cfg), fused=False, device="cpu")
    monkeypatch.setattr(tnet, "init",
                        lambda gen: params_from_jax(tnet, jinit))
    tparams, topt = train_nnet(tnet, Egs(x[100:], y[100:], w[100:]),
                               Egs(x[:100], y[:100], w[:100]),
                               TrainConfig(**kw))
    for got, want in zip(tparams, jax.device_get(jparams)):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-3, atol=2e-4)
    _assert_params_close(tnet, jparams, 2e-3, atol=2e-4)
    assert [o["ng_in"].t for o in topt if o] == \
        [int(o["ng_in"].t) for o in jopt if o]


# -------------------------------- TrainConfig.matmul_precision, step_fn=

def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _small_run(n=320, seed=11):
    """(train egs, valid egs, TrainConfig kwargs) of a short training:
    1 epoch of 4 minibatches of 64 rows."""
    r = np.random.default_rng(seed)
    centers = r.normal(size=(20, 144)).astype(np.float32)
    y = r.integers(0, 20, n).astype(np.int32)
    x = (centers[y] + r.normal(size=(n, 144))).astype(np.float32)
    w = np.ones(n, np.float32)
    kw = dict(num_epochs=1, minibatch_size=64, initial_learning_rate=0.05,
              final_learning_rate=0.01, combine_num_models=2, seed=4)
    return (x[64:], y[64:], w[64:]), (x[:64], y[:64], w[:64]), kw


def _small_net():
    return make_convnet(ConvnetConfig(**dict(CFG, num_hidden_layers=1)),
                        fused=False, device="cpu")


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of this process alone (and its mesh)."""
    from kaldi_cnn_tpu_torch.parallel.multihost import (MultihostConfig,
                                                        initialize)
    mesh = initialize(MultihostConfig(), "cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_matmul_precision_none_keeps_the_flags_and_the_bits(monkeypatch):
    """None leaves the process's flags as they stand, inside the training
    and after it, and trains the bits of the float32 path (on the CPU,
    "float32" is the default state)."""
    tr, va, kw = _small_run()
    seen = []
    steps = Nnet.train_steps
    monkeypatch.setattr(Nnet, "train_steps", lambda self, *a, **k: (
        seen.append(_flags()), steps(self, *a, **k))[1])
    before = _flags()
    runs = {}
    for prec in (None, "float32"):
        net = _small_net()
        runs[prec], _ = train_nnet(net, Egs(*tr), Egs(*va),
                                   TrainConfig(matmul_precision=prec, **kw))
        assert _flags() == before
    assert seen[0] == before
    for a, b in zip(runs[None], runs["float32"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("entry", ["train_nnet", "train_multihost"])
@pytest.mark.parametrize("prec,want", [
    ("float32", ("highest", False, False)),
    ("tensorfloat32", ("high", True, True)),
    ("bfloat16", ("medium", True, True))])
def test_matmul_precision_sets_and_restores_the_flags(
        world_of_one, monkeypatch, entry, prec, want):
    """A JAX precision name is in force inside ``train_nnet`` and
    ``train_multihost`` (world size 1 over gloo) and the flags are put
    back after a normal return and after an exception."""
    from kaldi_cnn_tpu_torch.parallel.multihost import train_multihost
    tr, va, kw = _small_run(n=192)
    cfg = TrainConfig(matmul_precision=prec, **kw)
    seen = []
    step, steps = Nnet.train_step, Nnet.train_steps

    def record(fn):
        return lambda self, *a, **k: (seen.append(_flags()),
                                      fn(self, *a, **k))[1]

    monkeypatch.setattr(Nnet, "train_step", record(step))
    monkeypatch.setattr(Nnet, "train_steps", record(steps))

    def run():
        net = _small_net()
        if entry == "train_nnet":
            return train_nnet(net, Egs(*tr), Egs(*va), cfg)
        return train_multihost(net, Egs(*tr), Egs(*va), cfg,
                               mesh=world_of_one)

    before = _flags()
    run()
    assert seen and set(seen) == {want}
    assert _flags() == before

    def boom(self, *a, **k):
        assert _flags() == want
        raise RuntimeError("boom")

    monkeypatch.setattr(Nnet, "train_step", boom)
    monkeypatch.setattr(Nnet, "train_steps", boom)
    with pytest.raises(RuntimeError, match="boom"):
        run()
    assert _flags() == before


def test_matmul_precision_unknown_raises():
    tr, va, kw = _small_run(n=128)
    with pytest.raises(ValueError, match="matmul_precision"):
        train_nnet(_small_net(), Egs(*tr), Egs(*va),
                   TrainConfig(matmul_precision="fp8", **kw))
    from kaldi_cnn_tpu_torch.train.trainer import MATMUL_PRECISIONS
    assert sorted(MATMUL_PRECISIONS) == ["bfloat16", "float32",
                                         "tensorfloat32"]


def _records(stream):
    import json
    return [json.loads(line) for line in stream.getvalue().splitlines()]


def test_train_nnet_float32_and_metrics_match_jax(monkeypatch,
                                                 jax_train_nnet):
    """``matmul_precision="float32"`` in both packages: final params
    within the file's train_nnet bar (rtol 2e-3); the ``metrics``
    records have the JAX package's names and keys."""
    import io
    from kaldi_cnn_tpu_torch.core.logging import MetricsWriter
    cfg, (x, y, w), kw, jparams, _, jinit, want = jax_train_nnet
    tnet = make_convnet(ConvnetConfig(**cfg), fused=False, device="cpu")
    monkeypatch.setattr(tnet, "init",
                        lambda gen: params_from_jax(tnet, jinit))
    tout = io.StringIO()
    tparams, _ = train_nnet(tnet, Egs(x[100:], y[100:], w[100:]),
                            Egs(x[:100], y[:100], w[:100]),
                            TrainConfig(matmul_precision="float32", **kw),
                            metrics=MetricsWriter(stream=tout))
    for got_p, want_p in zip(tparams, jax.device_get(jparams)):
        for k in got_p:
            np.testing.assert_allclose(got_p[k].numpy(),
                                       np.asarray(want_p[k]),
                                       rtol=2e-3, atol=2e-4)
    got = _records(tout)
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == \
        ["train_epoch"] * 2
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["epoch"] for r in got] == [0, 1]


def test_train_nnet_step_fn_is_the_default_path(world_of_one, monkeypatch):
    """``step_fn=make_dp_step(...)`` (world size 1 over gloo, a step a
    minibatch) trains the default path's bits on the CPU; with a clock
    that reads 1 s an epoch, ``frames_per_second`` sets the audio-s/s
    in the metrics (minibatches x rows / frames_per_second)."""
    import io
    from kaldi_cnn_tpu_torch.core.logging import MetricsWriter
    from kaldi_cnn_tpu_torch.parallel.dp import make_dp_step

    class Second:
        def reset(self):
            pass

        def elapsed(self):
            return 1.0

    monkeypatch.setattr(ttr, "Timer", Second)
    tr, va, kw = _small_run()
    runs, records = {}, {}
    for mode, fps in (("default", 100.0), ("step_fn", 50.0)):
        net = _small_net()
        out = io.StringIO()
        runs[mode], _ = train_nnet(
            net, Egs(*tr), Egs(*va), TrainConfig(**kw),
            step_fn=(make_dp_step(net, world_of_one)
                     if mode == "step_fn" else None),
            metrics=MetricsWriter(stream=out), frames_per_second=fps)
        records[mode] = _records(out)
    for a, b in zip(runs["default"], runs["step_fn"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert [r["audio_seconds_per_sec"] for r in records["default"]] == \
        [4 * 64 / 100.0]
    assert [r["audio_seconds_per_sec"] for r in records["step_fn"]] == \
        [4 * 64 / 50.0]
    assert (records["default"][0]["train_logprob"]
            == records["step_fn"][0]["train_logprob"])


@pytest.mark.parametrize("name", ["combine_models",
                                  "combine_models_per_component"])
def test_model_combination_matches_jax(name):
    """Both combiners, from the same two models and valid egs: the mixed
    params within rtol 1e-4 (the gradient comes from jax.grad on one
    side and torch.autograd through the maxpool kernel's autograd
    function on the other)."""
    jnet, tnet, p0 = _nets()
    p1 = _jax_params(jnet, seed=1)
    x, y = _data(n=48, seed=12)
    jegs, tegs = JEgs(x, y, np.ones(48)), Egs(x, y, np.ones(48))
    want = getattr(jtr, name)(jnet, [p0, p1], jegs,
                              JTrainConfig(minibatch_size=16))
    named = [{f"components.{i}.{k}": torch.as_tensor(np.array(v))
              for i, d in enumerate(p) for k, v in d.items()}
             for p in (p0, p1)]
    got = getattr(ttr, name)(tnet, named, tegs,
                             TrainConfig(minibatch_size=16))
    for i, d in enumerate(jax.device_get(want)):
        for k, v in d.items():
            np.testing.assert_allclose(got[f"components.{i}.{k}"].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def digits():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 4, 1, 3, seed=37)
    return corpus, Lang.create(lex), wp


def _equal_alignments(corpus, lang, volumes, fn, graph_cls):
    t2p = lang.trans_model.trans_id_to_pdf_array()
    return {u: fn(graph_cls(compile_training_graph(
        lang, corpus.transcripts[u]), t2p), volumes[u].shape[0])
        for u in sorted(volumes)}


def test_align_equal_and_egs_match_jax(digits):
    corpus, lang, _ = digits
    vol = wsj.compute_fbank_volumes(corpus, 12, device="cpu", dither=0.0)
    ali = _equal_alignments(corpus, lang, vol, align_equal, CompiledGraph)
    jali = _equal_alignments(corpus, lang, vol, j_align_equal, JGraph)
    for u in vol:
        assert ali[u] is not None and len(ali[u]) == len(vol[u])
        np.testing.assert_array_equal(ali[u], jali[u])
    t2p = lang.trans_model.trans_id_to_pdf_array()
    got = wsj.make_cnn_egs(vol, ali, t2p, 5, 5, seed=3)
    want = j_make_cnn_egs(vol, ali, t2p, 5, 5, seed=3)
    for a in ("x", "y", "weights"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))


def test_recipe_trains_then_decodes(digits, tmp_path):
    """wsj.train -> wsj.decode end to end on a few utterances (narrow
    conv, one epoch): the valid logprob rises above the zero-init
    output's -log(num_pdfs), and the decode gives words for every
    utterance."""
    corpus, lang, wp = digits
    vol = wsj.compute_fbank_volumes(corpus, seed=1, device="cpu")
    ali = _equal_alignments(corpus, lang, vol, align_equal, CompiledGraph)
    t2p = lang.trans_model.trans_id_to_pdf_array()
    P = lang.trans_model.num_pdfs
    am = wsj.train(vol, ali, t2p, P, num_epochs=2, num_filters=8, seed=2,
                   device="cpu", checkpoint_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch0.npz", "epoch1.npz", "final.npz"]
    assert isinstance(am.nnet, Nnet) and am.priors.shape == (P,)
    _, valid = wsj.split_valid(wsj.make_cnn_egs(vol, ali, t2p, 5, 5, 2))
    lp = float(am.nnet.objf(torch.as_tensor(valid.x),
                            torch.as_tensor(valid.y)))
    assert lp > -np.log(P) + 0.1
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         t2p)
    res = wsj.decode(am, corpus, hclg, lang.word_table, volumes=vol)
    assert res["missing_utts"] == 0 and set(res["hyps"]) == set(vol)
    assert all(np.isfinite(ll).all() for ll in res["loglikes"].values())
