"""Parity of the port's Switchboard CNN + iVector recipe with the JAX
package on the same numpy inputs: the speaker corpus, Identity and
SliceParallel components, ``make_convnet_ivector`` and its nested
params and NG states, the net's forward, fused-pair predict, train step
and model combination, the recipe's iVectors, aux rows and egs, the
VAD and PLDA twins, the slice as a whole (JAX-trained parameters
decoded by both packages), and ``swbd.run`` on the CPU."""

import functools
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.core.rng import np_rng as j_np_rng
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path as j_shortest_path
from kaldi_cnn_tpu.decode.topk_decoder import (
    decode_utterances as j_decode_utterances)
from kaldi_cnn_tpu import ivector as jiv
from kaldi_cnn_tpu.ivector import plda as jplda, vad as jvad
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa as j_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import (Lang as JLang,
                                     make_hclg_from_arpa as j_make_hclg)
from kaldi_cnn_tpu.models import components as JC
from kaldi_cnn_tpu.models import ng_sgd as jng
from kaldi_cnn_tpu.models.factory import (
    ConvnetConfig as JCfg, make_convnet_ivector as j_make_convnet_ivector)
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.wsj import make_cnn_egs as j_make_cnn_egs
from kaldi_cnn_tpu.train import checkpoint as jck
from kaldi_cnn_tpu.train import trainer as jtr
from kaldi_cnn_tpu.train.egs import Egs as JEgs
from kaldi_cnn_tpu.train.trainer import TrainConfig as JTrainConfig
from kaldi_cnn_tpu_torch import ivector as tiv
from kaldi_cnn_tpu_torch.convert import (opt_from_jax, opt_to_numpy,
                                         params_from_jax, params_to_numpy)
from kaldi_cnn_tpu_torch.core.stages import auto_stage
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import shortest_path
from kaldi_cnn_tpu_torch.gmm.train import align_equal
from kaldi_cnn_tpu_torch.ivector import plda as tplda, vad as tvad
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import (Lang, compile_training_graph,
                                           make_hclg_from_arpa)
from kaldi_cnn_tpu_torch.models import components as TC
from kaldi_cnn_tpu_torch.models import ng_sgd as tng
from kaldi_cnn_tpu_torch.models import nnet as tnn
from kaldi_cnn_tpu_torch.models.factory import (ConvnetConfig,
                                                make_convnet_ivector)
from kaldi_cnn_tpu_torch.models.nnet import AmNnet, Nnet
from kaldi_cnn_tpu_torch.recipes import swbd, synthetic, wsj
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
from kaldi_cnn_tpu_torch.train import checkpoint as tck
from kaldi_cnn_tpu_torch.train import trainer as ttr
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet
from test_torch_ngsgd import assert_state_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the recipe's net at small widths: 11x12x3 volumes, F = 8, iVector 4,
# pnorm 40/8; conv 8x8x8 -> pool 2x2 -> 4x4x8 = 128 columns + 4
IVEC = 4
CFG = dict(in_t=11, in_f=12, in_c=3, filt_t=4, filt_f=5, num_filters=8,
           pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=2,
           pnorm_input_dim=40, pnorm_output_dim=8, num_pdfs=60)
ATOL = 1e-5              # f32 components, forward / backprop / update
# the WSJ path's bounds (test_torch_nnet.py, test_torch_train.py)
FUSED_RTOL, FUSED_ATOL = 2e-2, 2e-3
LOGLIKE_ATOL = 5e-2      # chip_smoke.py: bf16 conv operands vs f32
# the recipe's corpus, cut to 4 speakers x 3 utterances
RUN = dict(num_speakers=4, utts_per_speaker=3, nnet_epochs=1,
           num_filters=8, seed=43, device="cpu")
STAGES = ["mfcc", "gmm_bootstrap", "ivector_extractor", "nnet_train"]
# JAX swbd.run's result: wer_details + dev_wer + use_pitch
JAX_KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
            "per_utt", "dev_wer", "use_pitch"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test processes share the CPU's cores: one torch thread
    each (see test_torch_train.py), the module-scoped runs included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_params(net, seed=0):
    """JAX init with the output affine redrawn (its init is all zero)."""
    p = list(jax.device_get(net.init(jax.random.PRNGKey(seed))))
    p[-2] = dict(p[-2])
    p[-2]["w"] = (np.random.default_rng(seed).normal(size=p[-2]["w"].shape)
                  * 0.3).astype(np.float32)
    return tuple(p)


_JNETS = {}


def _nets(num_pdfs=CFG["num_pdfs"], fused=False):
    """(JAX net, port net, JAX params in the port net).  One JAX net per
    num_pdfs for the module: its jit caches are per instance."""
    cfg = dict(CFG, num_pdfs=num_pdfs)
    if num_pdfs not in _JNETS:
        _JNETS[num_pdfs] = j_make_convnet_ivector(
            JCfg(**cfg), ivector_dim=IVEC, use_pallas=False)
    jnet = _JNETS[num_pdfs]
    tnet = make_convnet_ivector(ConvnetConfig(**cfg), ivector_dim=IVEC,
                                fused=fused, device="cpu")
    p = _jax_params(jnet)
    params_from_jax(tnet, p)
    return jnet, tnet, p


def _rows(n, seed=7, dim=None):
    dim = dim or 11 * 12 * 3 + IVEC
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _leaves_equal(got, want):
    """Nested params (dicts, "parts" tuples, arrays) equal leaf for leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):      # NGState is a tuple too
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _leaves_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _params_close(got, want, rtol, atol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _params_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _params_close(a, b, rtol, atol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol)


def _states_close(got, want):
    """NG states by rho and projector (ROADMAP 3.2), through "parts"."""
    if "parts" in want:
        assert len(got["parts"]) == len(want["parts"])
        for g, w in zip(got["parts"], want["parts"]):
            _states_close(g, w)
        return
    assert sorted(got) == sorted(want)
    for side in want:
        assert_state_close(got[side], want[side])


# ---- corpus ----------------------------------------------------------------

def test_speaker_corpus_is_bit_equal():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    got, spk = synthetic.make_speaker_corpus(lex, wp, 3, 2, 1, 4, seed=43)
    want, jspk = jsyn.make_speaker_corpus(jsyn.digits_lexicon(), wp, 3, 2, 1,
                                          4, seed=43)
    assert spk == jspk and len(spk) == 6
    assert got.transcripts == want.transcripts
    assert sorted(got.waves) == sorted(want.waves)
    for u in want.waves:
        assert got.waves[u].dtype == want.waves[u].dtype
        np.testing.assert_array_equal(got.waves[u], want.waves[u])


# ---- components ------------------------------------------------------------

def _slice_pair(kind):
    """(JAX slice, port slice in an Nnet, its JAX params): the recipe's
    front (Conv2D | Identity) or middle (Maxpool3D | Identity) slice."""
    if kind == "front":
        jpart = JC.Conv2DComponent(11, 12, 3, 4, 5, 8, use_pallas=False)
        tpart = TC.Conv2DComponent(11, 12, 3, 4, 5, 8, device="cpu")
    else:
        jpart = JC.Maxpooling3DComponent(8, 8, 8, 2, 2, 1, use_pallas=False)
        tpart = TC.Maxpooling3DComponent(8, 8, 8, 2, 2, 1)
    js = JC.SliceParallelComponent(parts=(jpart,
                                          JC.IdentityComponent(IVEC)))
    ts = TC.SliceParallelComponent([tpart, TC.IdentityComponent(IVEC)])
    p = jax.device_get(js.init(jax.random.PRNGKey(3)))
    params_from_jax(Nnet([ts]), (p,))
    return js, ts, p


@pytest.mark.parametrize("kind", ["front", "middle"])
def test_slice_forward_and_backprop_match_jax(kind):
    js, ts, p = _slice_pair(kind)
    assert (ts.input_dim, ts.output_dim, ts.trainable) == (
        js.input_dim, js.output_dim, js.trainable)
    r = np.random.default_rng(5)
    x = (r.normal(size=(9, js.input_dim)) * 2).astype(np.float32)
    y, aux = js.forward(p, jnp.asarray(x), train=True)
    d = r.normal(size=y.shape).astype(np.float32)
    want = np.asarray(js.backprop(p, jnp.asarray(x), y, jnp.asarray(d), aux))
    ty, taux = ts.train_forward(_t(x))
    assert isinstance(taux, list) and len(taux) == 2 and taux[1] is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ts(_t(x)).numpy(), np.asarray(y), rtol=0,
                               atol=ATOL)
    got = ts.backprop(_t(x), ty, _t(d), taux)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the Identity part passes the iVector columns and their derivative
    np.testing.assert_array_equal(ty[:, -IVEC:].numpy(), x[:, -IVEC:])
    np.testing.assert_array_equal(got[:, -IVEC:].numpy(), d[:, -IVEC:])


def test_identity_component_matches_jax():
    j, t = JC.IdentityComponent(6), TC.IdentityComponent(6)
    x = _rows(3, dim=6)
    assert (t.input_dim, t.output_dim, t.trainable) == (6, 6, False)
    assert list(t.parameters()) == []
    np.testing.assert_array_equal(t(_t(x)).numpy(),
                                  np.asarray(j.forward({}, x)[0]))
    np.testing.assert_array_equal(
        t.backprop(_t(x), _t(x), _t(2 * x), None).numpy(),
        np.asarray(j.backprop({}, x, x, 2 * x, None)))


def test_slice_update_matches_jax():
    """Three NG-SGD updates of the front slice (only its conv trains):
    params within ATOL, states by projector, the Identity's state {}."""
    js, ts, p = _slice_pair("front")
    kw = dict(rank=6, update_period=2, warmup_updates=1)
    j_in, j_out = jng.OnlineNaturalGradient(**kw), jng.OnlineNaturalGradient(
        **dict(kw, rank=5))
    t_in, t_out = tng.OnlineNaturalGradient(**kw), tng.OnlineNaturalGradient(
        **dict(kw, rank=5))
    jopt, topt = js.init_opt(j_in, j_out), ts.init_opt(t_in, t_out)
    assert topt["parts"][1] == {} and sorted(topt["parts"][0]) == [
        "ng_in", "ng_out"]
    # one jit of JAX's update compiles faster than its ops one by one
    jupdate = jax.jit(lambda p, o, x, d: js.update(p, o, x, d, 0.05, j_in,
                                                   j_out))
    r = np.random.default_rng(6)
    for _ in range(3):
        x = r.normal(size=(16, ts.input_dim)).astype(np.float32)
        d = r.normal(size=(16, ts.output_dim)).astype(np.float32)
        p, jopt = jupdate(p, jopt, jnp.asarray(x), jnp.asarray(d))
        topt = ts.update(topt, _t(x), _t(d), 0.05, t_in, t_out)
        _params_close(params_to_numpy(Nnet([ts]))[0], jax.device_get(p),
                      rtol=0, atol=ATOL)
        _states_close(topt, jopt)
        assert topt["parts"][1] == {}


# ---- the net, its params and states -----------------------------------

def test_make_convnet_ivector_matches_jax():
    jnet, tnet, p = _nets()
    assert [type(c).__name__ for c in tnet.components] == [
        type(c).__name__ for c in jnet.components]
    for jc, tc in zip(jnet.components, tnet.components):
        assert (tc.input_dim if hasattr(tc, "input_dim") else tc.dim) == (
            jc.input_dim if hasattr(jc, "input_dim") else jc.dim)
        if isinstance(jc, JC.SliceParallelComponent):
            assert [type(c).__name__ for c in tc.parts] == [
                type(c).__name__ for c in jc.parts]
            assert [(c.input_dim, c.output_dim) for c in tc.parts] == [
                (c.input_dim, c.output_dim) for c in jc.parts]
    assert tnet.input_dim == jnet.input_dim == 11 * 12 * 3 + IVEC
    names = [k for k, _ in tnet.named_parameters()]
    assert names[:2] == ["components.0.parts.0.w", "components.0.parts.0.b"]
    assert tnet.components[0].parts[0].fused is False
    assert make_convnet_ivector(ConvnetConfig(**CFG), IVEC,
                                device="cpu").components[0].parts[0].fused


def test_nested_params_and_states_round_trip():
    """params_from_jax / params_to_numpy and opt_from_jax / opt_to_numpy
    keep the {"parts": (...)} layout, leaf for leaf; a slice with the
    wrong layout is refused; checkpoints load both ways."""
    jnet, tnet, p = _nets()
    _leaves_equal(params_to_numpy(tnet), p)
    assert params_to_numpy(tnet)[1] == {"parts": ({}, {})}
    bad = list(p)
    bad[0] = p[0]["parts"][0]
    with pytest.raises(ValueError, match="parts"):
        params_from_jax(tnet, bad)
    x, y = _rows(96), np.random.default_rng(1).integers(0, 20, 96)
    p1, jopt, _ = jnet.train_step(p, jnet.init_opt(), jnp.asarray(x),
                                  jnp.asarray(y), 0.05)
    jopt = jax.device_get(jopt)
    topt = opt_from_jax(jopt, "cpu")
    # the front slice holds the conv's states; the pool slice trains not
    assert topt[0]["parts"][1] == {} and topt[1] == {} == jopt[1]
    _leaves_equal(opt_to_numpy(topt), jopt)
    params_from_jax(tnet, jax.device_get(p1))
    topt2, _ = tnet.train_step(topt, _t(x), _t(y), 0.05)
    _leaves_equal(opt_to_numpy(opt_from_jax(opt_to_numpy(topt2), "cpu")),
                  opt_to_numpy(topt2))


def test_nested_checkpoints_load_both_ways(tmp_path):
    jnet, tnet, p = _nets()
    x, y = _rows(96), np.random.default_rng(2).integers(0, 20, 96)
    p1, jopt, _ = jnet.train_step(p, jnet.init_opt(), jnp.asarray(x),
                                  jnp.asarray(y), 0.05)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, p1, jopt, {"epoch": 1})
    tp, to, meta = tck.load_checkpoint(path, params_to_numpy(tnet),
                                       tnet.init_opt())
    assert meta == {"epoch": 1}
    _leaves_equal(tp, jax.device_get(p1))
    _leaves_equal(opt_to_numpy(opt_from_jax(to, "cpu")),
                  jax.device_get(jopt))
    params_from_jax(tnet, tp)
    topt, _ = tnet.train_step(opt_from_jax(to, "cpu"), _t(x), _t(y), 0.05)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, params_to_numpy(tnet), topt, {"iter": 2})
    jp, jo, meta = jck.load_checkpoint(path, p1, jopt)
    assert meta == {"iter": 2}
    _leaves_equal(jax.device_get(jp), params_to_numpy(tnet))
    _leaves_equal(jax.device_get(jo), opt_to_numpy(topt))
    jnet.train_step(jp, jo, jnp.asarray(x), jnp.asarray(y), 0.05)


def test_forward_matches_jax_and_fused_predict_matches_forward(monkeypatch):
    """JAX predict (unfused, f32) against the port's unfused forward at
    f32 tolerance; the port's predict fuses the pair of slices into one
    conv2d_maxpool call (bf16 operands, the plain version on the CPU)
    and agrees with its forward at the WSJ path's bf16 tolerance."""
    jnet, tnet, p = _nets(fused=True)
    x = _rows(11)
    want = np.asarray(jnet.predict(p, jnp.asarray(x)))
    fwd = tnet(_t(x)).detach().numpy()
    np.testing.assert_allclose(fwd, want, rtol=1e-4, atol=1e-6)
    calls = []
    real = tnn.conv2d_maxpool

    def counted(xv, *a, **k):
        calls.append(tuple(xv.shape))
        assert xv.is_contiguous()
        return real(xv, *a, **k)

    monkeypatch.setattr(tnn, "conv2d_maxpool", counted)
    got = tnet.predict(_t(x)).numpy()
    assert calls == [(11, 11 * 12 * 3)]
    np.testing.assert_allclose(got, fwd, rtol=FUSED_RTOL, atol=FUSED_ATOL)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    # unequal Identity widths, or fused=False: no fusion
    calls.clear()
    _, unfused, _ = _nets(fused=False)
    np.testing.assert_allclose(unfused.predict(_t(x)).numpy(), fwd,
                               rtol=1e-6, atol=1e-7)
    assert calls == []
    mid = tnet.components[1]
    mid.parts[1] = TC.IdentityComponent(IVEC + 1)
    assert not tnn._fusable_slices(tnet.components[0], mid)


def test_train_steps_match_jax():
    """One step: objf 1e-5, params rtol 1e-4, NG states by projector;
    then 20 steps: objf 1e-4 at every step, params rtol 2e-3 (the WSJ
    net's bounds)."""
    jnet, tnet, p = _nets()
    r = np.random.default_rng(8)
    x, y = _rows(96, seed=8), r.integers(0, 20, 96).astype(np.int32)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), _t(x), _t(y)
    jopt, topt = jnet.init_opt(), tnet.init_opt()
    p, jopt, jo = jnet.train_step(p, jopt, jx, jy, 0.05)
    topt, to = tnet.train_step(topt, tx, ty, 0.05)
    assert float(to) == pytest.approx(float(jo), abs=1e-5)
    _params_close(params_to_numpy(tnet), jax.device_get(p), 1e-4, 1e-6)
    for got, want in zip(topt, jopt):
        if want:
            _states_close(got, want)
    for s in range(19):
        p, jopt, jo = jnet.train_step(p, jopt, jx, jy, 0.05)
        topt, to = tnet.train_step(topt, tx, ty, 0.05)
        assert float(to) == pytest.approx(float(jo), abs=1e-4), s
    _params_close(params_to_numpy(tnet), jax.device_get(p), 2e-3, 2e-4)


def test_combine_per_component_matches_jax():
    """One weight per TOP-LEVEL component: the slice's conv takes the
    weight of its SliceParallel (JAX's stacked[i] covers the subtree);
    the mixed params of both packages within rtol 1e-4."""
    jnet, tnet, p0 = _nets()
    p1 = _jax_params(jnet, seed=1)
    x, y = _rows(48, seed=12), np.random.default_rng(12).integers(0, 20, 48)
    want = jtr.combine_models_per_component(
        jnet, [p0, p1], JEgs(x, y, np.ones(48)),
        JTrainConfig(minibatch_size=16))

    def named(p):
        net = make_convnet_ivector(ConvnetConfig(**CFG), IVEC, fused=False,
                                   device="cpu")
        params_from_jax(net, p)
        return {k: v.detach().clone() for k, v in net.named_parameters()}

    got = ttr.combine_models_per_component(
        tnet, [named(p0), named(p1)], Egs(x, y, np.ones(48)),
        TrainConfig(minibatch_size=16))
    assert "components.0.parts.0.w" in got
    _params_close(ttr._per_component(tnet, got), jax.device_get(want),
                  1e-4, 1e-6)


def test_train_nnet_returns_the_nested_layout():
    _, tnet, _ = _nets()
    r = np.random.default_rng(4)
    x, y = _rows(300, seed=4), r.integers(0, 20, 300).astype(np.int32)
    params, opt = train_nnet(tnet, Egs(x[40:], y[40:], np.ones(260)),
                             Egs(x[:40], y[:40], np.ones(40)),
                             TrainConfig(num_epochs=2, minibatch_size=64,
                                         combine_num_models=2))
    assert sorted(params[0]) == ["parts"] and params[1] == {
        "parts": ({}, {})}
    _leaves_equal(params, params_to_numpy(tnet))
    assert opt[0]["parts"][0]["ng_in"].t > 0 and opt[0]["parts"][1] == {}


# ---- the recipe's stages ---------------------------------------------------

@pytest.fixture(scope="module")
def stages():
    """The recipe's inputs at 3 speakers x 3 utterances: MFCC (dither 0
    would change nothing here: both packages take these arrays), fbank
    volumes at 12 bins, monophone equal alignments."""
    train, dev, test = swbd.make_corpus(3, 3, seed=43)
    mfcc = compute_features(train, seed=43, device="cpu")
    vols = wsj.compute_fbank_volumes(train, 12, 43, device="cpu",
                                     dither=0.0)
    lang = Lang.create(train.lexicon)
    t2p = lang.trans_model.trans_id_to_pdf_array()
    ali = {u: align_equal(CompiledGraph(compile_training_graph(
        lang, train.transcripts[u]), t2p), v.shape[0])
        for u, v in vols.items()}
    return dict(train=train, mfcc=mfcc, vols=vols, lang=lang, t2p=t2p,
                ali=ali)


@pytest.mark.parametrize("per_spk,extra", [(5, 0), (3, 2)])
def test_make_corpus_is_the_jax_split(per_spk, extra):
    """swbd.py run's split: 20 % test then 15 % dev, or with extra eval
    utterances per speaker, the even ones dev and the odd ones test."""
    lex = jsyn.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus, _ = jsyn.make_speaker_corpus(lex, wp, 4, per_spk + extra, 1, 4,
                                         43)
    if extra:
        j = {u: int(u.rsplit("_utt", 1)[1]) for u in corpus.waves}
        tr = [u for u in corpus.waves if j[u] < per_spk]
        dv = [u for u in corpus.waves if j[u] >= per_spk and j[u] % 2 == 0]
        te = [u for u in corpus.waves if j[u] >= per_spk and j[u] % 2 == 1]
    else:
        trc, tec = corpus.split(0.2)
        trc, dvc = trc.split(0.15)
        tr, dv, te = trc.waves, dvc.waves, tec.waves
    got = swbd.make_corpus(4, per_spk, 43, eval_utts_per_speaker=extra)
    assert [sorted(c.waves) for c in got] == [sorted(tr), sorted(dv),
                                              sorted(te)]
    assert all(len(c.waves) for c in got)


def test_ivectors_match_jax(stages):
    mfcc = stages["mfcc"]
    ubm, ext = swbd.ivector_system(mfcc, IVEC, seed=43)
    got = swbd.ivectors(ext, mfcc)
    raw13 = {u: f[:, :13] for u, f in mfcc.items()}
    jubm = jiv.train_ubm(list(raw13.values()), 16, num_iters=4, seed=43)
    jext = jiv.IvectorExtractor(jubm, IVEC, seed=43)
    jext.train(list(raw13.values()), num_iters=4)
    for u, f in raw13.items():
        want = jiv.length_normalize(jext.extract(f)).astype(np.float32)
        assert got[u].dtype == np.float32 and got[u].shape == (IVEC,)
        np.testing.assert_allclose(got[u], want, rtol=0, atol=1e-5)


def test_aux_rows_and_egs_match_jax(stages):
    """aux rows: the iVector repeated per frame; the egs' x rows
    bit-equal to JAX's make_cnn_egs + the iVector rows permuted with
    np_rng(seed, "cnn_egs_shuffle") (swbd.py:160-171)."""
    vols, ali, t2p = stages["vols"], stages["ali"], stages["t2p"]
    r = np.random.default_rng(9)
    ivs = {u: r.normal(size=IVEC).astype(np.float32) for u in vols}
    aux = swbd.aux_rows(stages["train"], vols, ivs)
    for u, v in vols.items():
        np.testing.assert_array_equal(
            aux[u], np.repeat(ivs[u][None, :], v.shape[0], 0))
    ali = dict(ali)
    drop = sorted(ali)[0]
    ali[drop] = ali[drop][:-1]        # a length mismatch is skipped
    got = swbd.make_egs(vols, aux, ali, t2p, seed=43)
    egs_vol = j_make_cnn_egs(vols, ali, t2p, 5, 5, 43)
    rows = np.concatenate([aux[u] for u in sorted(vols) if u in ali
                           and len(ali[u]) == vols[u].shape[0]])
    rows = rows[j_np_rng(43, "cnn_egs_shuffle").permutation(
        len(egs_vol.y))]
    want = np.concatenate([egs_vol.x, rows], axis=1)
    assert got.x.dtype == want.dtype
    np.testing.assert_array_equal(got.x, want)
    np.testing.assert_array_equal(got.y, egs_vol.y)


def test_vad_and_plda_twins_match_jax():
    for mod in ("vad", "plda"):
        with open(os.path.join(ROOT, f"kaldi_cnn_tpu_torch/ivector/{mod}.py")
                  ) as f:
            got = f.read()
        with open(os.path.join(ROOT, f"kaldi_cnn_tpu/ivector/{mod}.py")) as f:
            want = f.read().replace("from kaldi_cnn_tpu.",
                                    "from kaldi_cnn_tpu_torch.")
        assert got == want, mod
    r = np.random.default_rng(4)
    e = r.normal(size=200) * 3 + 8
    for ctx in (0, 3):
        o = tvad.VadOptions(vad_frames_context=ctx)
        jo = jvad.VadOptions(vad_frames_context=ctx)
        np.testing.assert_array_equal(tvad.compute_vad(e, o),
                                      jvad.compute_vad(e, jo))
    frames = r.normal(size=(20, 200))
    np.testing.assert_array_equal(tiv.log_energy(frames),
                                  jvad.log_energy(frames))
    by_spk = {f"s{s}": [r.normal(size=IVEC) + s for _ in range(4)]
              for s in range(5)}
    tp, jp = tplda.estimate_plda(by_spk), jplda.estimate_plda(by_spk)
    for k in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(tp, k), getattr(jp, k),
                                   rtol=1e-6, atol=1e-9)
    a, b = by_spk["s1"][0], by_spk["s3"][1]
    assert tp.llr(a, b, 2) == pytest.approx(jp.llr(a, b, 2), rel=1e-6)
    assert tiv.Plda is tplda.Plda and tiv.compute_vad is tvad.compute_vad


# ---- the slice as a whole ---------------------------------------------

def test_slice_decodes_like_jax(stages):
    """JAX-trained tiny SWBD parameters (20 JAX train steps on the
    recipe's egs), converted into the port, scored by loglikes_batch
    (the fused pair of slices) and decoded by decode_utterances on the
    monophone graph, against JAX's nnet_decode chain on the same
    volumes and aux rows (the utterances of up to 128 frames): loglikes
    within LOGLIKE_ATOL, one-best words equal, costs close (ROADMAP
    3.7)."""
    vols, ali, t2p, lang = (stages[k] for k in ("vols", "ali", "t2p",
                                                "lang"))
    num_pdfs = lang.trans_model.num_pdfs
    ivs = {u: np.random.default_rng(len(u) + i).normal(size=IVEC)
           .astype(np.float32) for i, u in enumerate(sorted(vols))}
    aux = swbd.aux_rows(stages["train"], vols, ivs)
    egs = swbd.make_egs(vols, aux, ali, t2p, seed=43)
    jnet, tnet, p = _nets(num_pdfs=num_pdfs, fused=True)
    jopt = jnet.init_opt()
    for i in range(20):     # the other tests' minibatch: one jit
        s = slice(96 * i % (len(egs) - 96), 96 * i % (len(egs) - 96) + 96)
        p, jopt, _ = jnet.train_step(p, jopt, jnp.asarray(egs.x[s]),
                                     jnp.asarray(egs.y[s]), 0.05)
    p = jax.device_get(p)
    params_from_jax(tnet, p)
    counts = np.bincount(egs.y, minlength=num_pdfs)
    jam = JAmNnet(jnet, num_pdfs)
    jam.set_priors_from_counts(counts)
    am = AmNnet(tnet, num_pdfs)
    am.set_priors_from_counts(counts)
    # the utterances of one 128-frame bucket: one jit of JAX's search
    short = [u for u in sorted(vols) if vols[u].shape[0] <= 128]
    rows = swbd.decode_rows({u: vols[u] for u in short}, aux)
    wp = stages["train"].word_probs
    jlang = JLang.create(jsyn.digits_lexicon())
    jlls = jam.loglikes_batch(p, rows)
    jlats = j_decode_utterances(
        JGraph(j_make_hclg(jlang, j_unigram_arpa(wp)), t2p), jlls,
        acoustic_scale=0.1, beam=60.0, lattice_beam=8.0, max_active=2000,
        lattice_arcs_per_frame=None)
    lls = am.loglikes_batch(rows)
    lats = swbd.nnet_decode(am, rows, CompiledGraph(
        make_hclg_from_arpa(lang, make_unigram_arpa(wp)), t2p))
    assert sorted(lats) == sorted(jlats) == short and len(short) >= 2
    for u in short:
        np.testing.assert_allclose(lls[u], np.asarray(jlls[u]), rtol=0,
                                   atol=LOGLIKE_ATOL)
        _, w, c = shortest_path(lats[u], acoustic_scale=0.1)
        _, jw, jc = j_shortest_path(jlats[u], acoustic_scale=0.1)
        assert list(w) == list(jw), u
        assert c == pytest.approx(jc, rel=1e-4, abs=5e-2)


# ---- the recipe ----------------------------------------------------------------

def _recording(calls):
    """swbd.nnet_decode that keeps its arguments in ``calls``."""
    decode = swbd.nnet_decode

    def record(am, rows, hclg):
        calls.append((am, rows, hclg))
        return decode(am, rows, hclg)
    return record


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One swbd.run with its stage artifacts in ``exp``, the result and
    the (am, rows, hclg) of its dev and test decodes.  Its
    decode_utterances runs in batches of 2 rather than 16: a short batch
    is padded with copies of its last utterance, so the lattices are the
    same and the CPU searches an eighth of the rows."""
    exp = str(tmp_path_factory.mktemp("swbd") / "exp")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(swbd, "nnet_decode", _recording(calls))
        mp.setattr(swbd, "decode_utterances", functools.partial(
            swbd.decode_utterances, batch_size=2))
        res = swbd.run(exp_dir=exp, **RUN)
    return exp, res, calls


def test_run_completes_with_the_jax_result_keys(full_run):
    _, res, _ = full_run
    assert JAX_KEYS <= set(res)
    assert res["words"] > 0 and res["missing_utts"] == 0
    assert 0.0 <= res["wer"] <= 100.0 and 0.0 <= res["dev_wer"] <= 100.0
    assert res["use_pitch"] is False
    assert res["tree_leaves"] > 60 and res["graph_states"] > 163
    assert set(STAGES) <= set(res["seconds"])


def test_stage_artifacts_hold_host_numpy_only(full_run):
    exp, _, _ = full_run
    names = sorted(f for f in os.listdir(exp) if f.endswith(".pkl"))
    assert names == [f"stage{i:02d}_{n}.pkl" for i, n in enumerate(STAGES)]

    def walk(x):
        assert not isinstance(x, (torch.Tensor, torch.nn.Module)), type(x)
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            walk(vars(x))

    for n in names:
        with open(os.path.join(exp, n), "rb") as f:
            walk(pickle.load(f))
    with open(os.path.join(exp, "stage03_nnet_train.pkl"), "rb") as f:
        params = pickle.load(f)
    assert sorted(params[0]) == ["parts"]
    assert isinstance(params[0]["parts"][0]["w"], np.ndarray)


class _Decoding(Exception):
    pass


def test_run_resumes_after_the_bootstrap(full_run, monkeypatch):
    """Delete the stages after gmm_bootstrap and resume: the two kept
    artifacts are not rewritten, the two redone ones hold the full
    run's arrays bit for bit, and the decode gets the full run's rows,
    priors and graph (the resumed run stops there: the decode itself is
    the full run's)."""
    exp, _, calls = full_run
    names = sorted(f for f in os.listdir(exp) if f.startswith("stage"))
    before = {}
    for f in names:
        with open(os.path.join(exp, f), "rb") as fh:
            before[f] = pickle.load(fh)
    keep = {f for f in names if f.startswith(("stage00", "stage01"))}
    assert len(keep) == 2
    for f in names:
        if f not in keep:
            os.remove(os.path.join(exp, f))
    mtimes = {f: os.path.getmtime(os.path.join(exp, f)) for f in keep}
    assert auto_stage(exp) == 2
    resumed = []

    def stop(am, rows, hclg):
        resumed.append((am, rows, hclg))
        raise _Decoding

    monkeypatch.setattr(swbd, "nnet_decode", stop)
    with pytest.raises(_Decoding):
        swbd.run(exp_dir=exp, stage=auto_stage(exp), **RUN)
    for f in keep:
        assert os.path.getmtime(os.path.join(exp, f)) == mtimes[f]
    assert auto_stage(exp) == 4
    for f in names:
        if f not in keep:
            with open(os.path.join(exp, f), "rb") as fh:
                _leaves_equal(_arrays(pickle.load(fh)), _arrays(before[f]))
    (am, rows, hclg), = resumed
    full_am, full_rows, full_hclg = calls[0]
    assert sorted(rows) == sorted(full_rows)
    for u in rows:
        np.testing.assert_array_equal(rows[u], full_rows[u])
    np.testing.assert_array_equal(am.priors, full_am.priors)
    assert hclg.num_states == full_hclg.num_states
    _leaves_equal(params_to_numpy(am.nnet), params_to_numpy(full_am.nnet))


def _arrays(x):
    """The numpy arrays of a stage artifact, nested as it nests them."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, dict):
        return {k: _arrays(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_arrays(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return _arrays(vars(x))
    return np.asarray(x) if isinstance(x, (int, float)) else None
