"""Parity of the port's sequence-discriminative training with the JAX
package's on the yesno fixture of ``tests/test_discriminative.py`` (the
JAX package's MFCC; a monophone system trained by each package on them):
``lattice_pdf_posteriors``, ``mmi_objf``/``ebw_update_am`` and one
``mmi_train_gmm`` iteration; ``Nnet.discriminative_step`` from the same
parameters (a p-norm DNN and a small CNN); ``mmi_train_nnet`` for two
iterations; the verbatim twins by source text; and the update period
that ``mmi_train_nnet`` gives back (ROADMAP 3.21)."""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode.decoder import lattice_decode as j_lattice_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.features.functional import splice_frames
from kaldi_cnn_tpu.gmm import ebw as jebw
from kaldi_cnn_tpu.gmm.am_gmm import AmDiagGmmAccs as JAccs
from kaldi_cnn_tpu.gmm.train import MonoTrainOptions as JMonoOpts
from kaldi_cnn_tpu.gmm.train import train_mono as j_train_mono
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa as j_arpa
from kaldi_cnn_tpu.lang.hclg import (Lang as JLang,
                                     make_hclg_from_arpa as j_hclg)
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          PnormDnnConfig as JDnnCfg,
                                          make_convnet as j_make_convnet,
                                          make_pnorm_dnn as j_make_dnn)
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.yesno import compute_features as j_features
from kaldi_cnn_tpu.train import discriminative as jdisc
from kaldi_cnn_tpu_torch.convert import (opt_from_jax, opt_to_numpy,
                                         params_from_jax, params_to_numpy)
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.gmm import ebw as tebw
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmmAccs
from kaldi_cnn_tpu_torch.gmm.train import MonoTrainOptions, train_mono
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.factory import (
    ConvnetConfig, PnormDnnConfig, make_convnet, make_pnorm_dnn)
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.train import discriminative as tdisc
from test_torch_ngsgd import assert_state_close
from test_torch_lang import load_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJF_ATOL = 1e-5          # one discriminative_step's objf
PARAM_REL = 1e-4          # its parameters, ||a - b|| / ||b|| per tensor
HISTORY_ATOL = 1e-3       # mmi_train_nnet's per-iteration objf


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """tests/test_discriminative.py's yesno system, trained by each
    package on the JAX package's MFCC (each with its own Lang:
    training updates the transition model in place)."""
    load_jax_native(tmp_path_factory)
    wp = {"yes": 0.5, "no": 0.5}
    corpus = jsyn.make_corpus(jsyn.yesno_lexicon(), wp, 16, 1, 2, 83)
    feats = j_features(corpus, seed=83)
    jlang = JLang.create(jsyn.yesno_lexicon())
    jam, jali = j_train_mono(feats, corpus.transcripts, jlang,
                             JMonoOpts(num_iters=8, totgauss=80))
    jg = JGraph(j_hclg(jlang, j_arpa(wp)),
                jlang.trans_model.trans_id_to_pdf_array())
    lang = Lang.create(synthetic.yesno_lexicon())
    am, ali = train_mono(feats, corpus.transcripts, lang,
                         MonoTrainOptions(num_iters=8, totgauss=80))
    g = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                      lang.trans_model.trans_id_to_pdf_array())
    for a, b in zip(am.gmms, jam.gmms):
        np.testing.assert_array_equal(a.means, b.means)
    return dict(feats=feats, jam=jam, jali=jali, jlang=jlang, jg=jg,
                am=am, ali=ali, lang=lang, g=g)


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def test_ebw_twin_is_verbatim():
    assert _source("kaldi_cnn_tpu_torch/gmm/ebw.py") == _source(
        "kaldi_cnn_tpu/gmm/ebw.py").replace("from kaldi_cnn_tpu.",
                                             "from kaldi_cnn_tpu_torch.")


@pytest.mark.parametrize("name", ["lattice_pdf_posteriors",
                                  "mmi_train_gmm"])
def test_discriminative_twins_are_verbatim(name):
    assert inspect.getsource(getattr(tdisc, name)) == inspect.getsource(
        getattr(jdisc, name)).replace("from kaldi_cnn_tpu.",
                                      "from kaldi_cnn_tpu_torch.")


def _den(s, utt, pkg):
    am, g, lang = ((s["jam"], s["jg"], s["jlang"]) if pkg == "jax"
                   else (s["am"], s["g"], s["lang"]))
    decode = j_lattice_decode if pkg == "jax" else lattice_decode
    mod = jdisc if pkg == "jax" else tdisc
    f = s["feats"][utt]
    lat = decode(g, am.loglikes(f), acoustic_scale=0.1, beam=60.0,
                 lattice_beam=8.0, max_active=2000)
    tm = lang.trans_model
    return mod.lattice_pdf_posteriors(lat, tm.trans_id_to_pdf_array(),
                                      tm.num_pdfs, f.shape[0], 1.0, 0.1)


def test_lattice_pdf_posteriors_match_jax(system):
    for utt in sorted(system["feats"])[:2]:
        got, want = _den(system, utt, "port"), _den(system, utt, "jax")
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-3)


def test_mmi_objf_and_ebw_update_match_jax(system):
    s = system
    t2p = s["lang"].trans_model.trans_id_to_pdf_array()
    num, den = AmDiagGmmAccs(s["am"]), AmDiagGmmAccs(s["am"])
    jnum, jden = JAccs(s["jam"]), JAccs(s["jam"])
    for utt in sorted(s["feats"])[:3]:
        f = s["feats"][utt]
        post, jpost = _den(s, utt, "port"), _den(s, utt, "jax")
        num.accumulate(s["am"], f, t2p[s["ali"][utt]])
        jnum.accumulate(s["jam"], f, t2p[s["jali"][utt]])
        tebw.accumulate_post(den, s["am"], f, post)
        jebw.accumulate_post(jden, s["jam"], f, jpost)
        assert tebw.mmi_objf(s["am"], f, t2p[s["ali"][utt]], post) == \
            pytest.approx(jebw.mmi_objf(s["jam"], f, t2p[s["jali"][utt]],
                                        jpost), rel=1e-6)
    new = tebw.ebw_update_am(s["am"], num, den)
    jnew = jebw.ebw_update_am(s["jam"], jnum, jden)
    for a, b in zip(new.gmms, jnew.gmms):
        np.testing.assert_allclose(a.means, b.means, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(a.vars, b.vars, rtol=1e-6, atol=1e-8)


def test_mmi_train_gmm_matches_jax(system):
    s = system
    keys = sorted(s["feats"])[:3]
    feats = {u: s["feats"][u] for u in keys}
    am, hist = tdisc.mmi_train_gmm(s["am"], s["lang"], feats, s["ali"],
                                   s["g"], num_iters=1)
    jam, jhist = jdisc.mmi_train_gmm(s["jam"], s["jlang"], feats,
                                     s["jali"], s["jg"], num_iters=1)
    np.testing.assert_allclose(hist, jhist, rtol=1e-6)
    for a, b in zip(am.gmms, jam.gmms):
        np.testing.assert_allclose(a.means, b.means, rtol=1e-6, atol=1e-8)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_params(jnet, seed):
    p = [{k: np.asarray(v, np.float32) for k, v in d.items()}
         for d in jax.device_get(jnet.init(jax.random.PRNGKey(seed)))]
    p[-2]["w"] = (np.random.default_rng(seed).normal(size=p[-2]["w"].shape)
                  * 0.3).astype(np.float32)
    return tuple(p)


@pytest.mark.parametrize("kind", ["dnn", "cnn"])
def test_discriminative_step_matches_jax(kind):
    rng = np.random.default_rng(21)
    if kind == "dnn":
        cfg = dict(input_dim=30, num_hidden_layers=2, pnorm_input_dim=40,
                   pnorm_output_dim=10, num_pdfs=12)
        jnet = j_make_dnn(JDnnCfg(**cfg))
        net = make_pnorm_dnn(PnormDnnConfig(**cfg), device="cpu")
    else:
        cfg = dict(in_t=6, in_f=12, in_c=2, filt_t=3, filt_f=5,
                   num_filters=8, pool_t=2, pool_f=2, pool_c=1,
                   num_hidden_layers=1, pnorm_input_dim=32,
                   pnorm_output_dim=8, num_pdfs=12)
        jnet = j_make_convnet(JCfg(**cfg), use_pallas=False)
        net = make_convnet(ConvnetConfig(**cfg), device="cpu")
    params = _jax_params(jnet, 2)
    params_from_jax(net, params)
    jopt = jnet.init_opt()
    opt = opt_from_jax(jax.device_get(jopt), "cpu")
    n = 48
    x = rng.normal(size=(n, jnet.input_dim)).astype(np.float32)
    num = np.zeros((n, 12), np.float32)
    num[np.arange(n), rng.integers(0, 12, n)] = 1.0
    den = rng.dirichlet(np.ones(12), size=n).astype(np.float32)
    for step in range(2):
        jparams, jopt, jobjf = jnet.discriminative_step(
            params, jopt, x, num, den, 0.01)
        opt, objf = net.discriminative_step(
            opt, torch.from_numpy(x), torch.from_numpy(num),
            torch.from_numpy(den), 0.01)
        assert abs(float(objf) - float(jobjf)) < OBJF_ATOL
        params = tuple({k: np.asarray(v) for k, v in d.items()}
                       for d in jax.device_get(jparams))
        for got, want in zip(params_to_numpy(net), params):
            for k in want:
                assert _rel(got[k], want[k]) < PARAM_REL, (step, k)
    for a, b in zip(opt_to_numpy(opt), jax.device_get(jopt)):
        for side in a:
            assert_state_close(a[side], b[side])


@pytest.fixture(scope="module")
def mmi_setup(system):
    """A DNN trained 2 epochs by the JAX package on the yesno egs, its NG
    states, and 4 utterances spliced +-2 with their pdf alignments."""
    from kaldi_cnn_tpu.train.egs import Egs, EgsConfig, make_egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet
    s = system
    tm = s["jlang"].trans_model
    t2p = tm.trans_id_to_pdf_array()
    egs = make_egs(s["feats"], s["jali"], t2p, EgsConfig(2, 2))
    cfg = dict(input_dim=egs.x.shape[1], num_hidden_layers=1,
               pnorm_input_dim=200, pnorm_output_dim=40,
               num_pdfs=tm.num_pdfs)
    jnet = j_make_dnn(JDnnCfg(**cfg))
    params, opt = train_nnet(
        jnet, egs, Egs(egs.x[:256], egs.y[:256], egs.weights[:256]),
        TrainConfig(num_epochs=2, minibatch_size=256,
                    initial_learning_rate=0.08, final_learning_rate=0.02))
    priors = np.bincount(egs.y, minlength=tm.num_pdfs) + 0.5
    priors = priors / priors.sum()
    utts = [(np.asarray(splice_frames(f, 2, 2), np.float32),
             t2p[s["jali"][u]]) for u, f in list(s["feats"].items())[:4]]
    params = tuple({k: np.asarray(v) for k, v in d.items()}
                   for d in jax.device_get(params))
    return cfg, jnet, params, jax.device_get(opt), priors, utts, t2p


def test_mmi_train_nnet_matches_jax(system, mmi_setup):
    cfg, jnet, params, jopt, priors, utts, t2p = mmi_setup
    net = make_pnorm_dnn(PnormDnnConfig(**cfg), device="cpu")
    params_from_jax(net, params)
    opt = opt_from_jax(jopt, "cpu")
    period = net.ng_in.update_period
    assert period == jnet.ng_in.update_period == 16
    _, _, jhist = jdisc.mmi_train_nnet(jnet, params, jopt, utts,
                                       system["jg"], t2p, priors,
                                       num_iters=2, learning_rate=0.002)
    opt, hist = tdisc.mmi_train_nnet(net, opt, utts, system["g"], t2p,
                                     priors, num_iters=2,
                                     learning_rate=0.002, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, jhist, atol=HISTORY_ATOL, rtol=0)
    # ROADMAP 3.21: the JAX function leaves its net at period 4; the
    # port's phase ran at 4 and gave the net its own period back
    assert jnet.ng_in.update_period == jnet.ng_out.update_period == 4
    assert net.ng_in.update_period == net.ng_out.update_period == period


def test_mmi_phase_runs_at_period_four(system, mmi_setup):
    """Inside mmi_train_nnet the port's NG states refresh every 4 steps
    (ROADMAP 3.21), and the period comes back even when the phase
    raises."""
    cfg, _, params, jopt, priors, utts, t2p = mmi_setup
    net = make_pnorm_dnn(PnormDnnConfig(**cfg), device="cpu")
    params_from_jax(net, params)
    seen = []
    step = net.discriminative_step

    def spy(*a, **k):
        seen.append((net.ng_in.update_period, net.ng_out.update_period))
        if len(seen) == 2:
            raise RuntimeError("stop")
        return step(*a, **k)

    net.discriminative_step = spy
    with pytest.raises(RuntimeError, match="stop"):
        tdisc.mmi_train_nnet(net, opt_from_jax(jopt, "cpu"), utts,
                             system["g"], t2p, priors, num_iters=1,
                             device="cpu")
    assert seen == [(4, 4), (4, 4)]
    assert (net.ng_in.update_period, net.ng_out.update_period) == (16, 16)
