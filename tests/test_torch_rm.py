"""Parity of the port's RM recipe (and yesno) with the JAX package on the
same numpy inputs: ``splice_frames``, the ``transform/`` twins (LDA,
MLLT, fMLLR), the LDA+MLLT and SAT trainers, the two-pass fMLLR GMM
decode, ``make_egs``, the slice as a whole (a JAX-trained p-norm DNN on
fMLLR rows decoded by both packages), and ``rm.run`` and ``yesno.run``
on the CPU."""

import functools
import inspect
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode.decoder import lattice_decode as j_lattice_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path as j_shortest_path
from kaldi_cnn_tpu.decode.topk_decoder import (
    TpuTopKDecoder, decode_utterances as j_decode_utterances)
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.gmm import train as jtrain
from kaldi_cnn_tpu.lang import arpa as jarpa
from kaldi_cnn_tpu.lang import hclg as jhclg
from kaldi_cnn_tpu.models import factory as jfactory
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet
from kaldi_cnn_tpu.recipes import rm as jrm
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes import yesno as jyesno
from kaldi_cnn_tpu.train import egs as jegs
from kaldi_cnn_tpu.train import trainer as jtr
from kaldi_cnn_tpu.transform import fmllr as jfmllr
from kaldi_cnn_tpu.transform import lda as jlda
from kaldi_cnn_tpu.transform import mllt as jmllt
from kaldi_cnn_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_cnn_tpu_torch.core.stages import auto_stage
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import shortest_path
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.gmm import train as ttrain
from kaldi_cnn_tpu_torch.lang import arpa as tarpa
from kaldi_cnn_tpu_torch.lang import hclg as thclg
from kaldi_cnn_tpu_torch.models import factory as tfactory
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes import rm, synthetic, yesno
from kaldi_cnn_tpu_torch.train import egs as tegs
from kaldi_cnn_tpu_torch.transform import fmllr as tfmllr
from kaldi_cnn_tpu_torch.transform import lda as tlda
from kaldi_cnn_tpu_torch.transform import mllt as tmllt
from test_torch_lang import load_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# lattice one-best cost between the packages (PERF.md section 2)
LAT_COST_REL, LAT_COST_ABS = 1e-4, 5e-2
LOGLIKE_ATOL = 1e-3      # JAX-trained DNN, loglikes of both packages
# JAX rm.run's result: wer_details + the three WERs
JAX_KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
            "per_utt", "gmm_dev_wer", "dnn_dev_wer", "gmm_test_wer"}
STAGES = ["features", "mono", "tri1", "tri2b", "tri3b_sat", "dnn_train"]
# the recipe cut to 16 utterances and one epoch
RUN = dict(num_utts=16, nnet_epochs=1, seed=29, device="cpu")
# the chain's trainers cut for size, mllt_iters / fmllr_iters inside
LDA_OPTS = dict(num_iters=4, totgauss=160, max_leaves=60, lda_dim=20,
                mllt_iters=(1, 3))
SAT_OPTS = dict(num_iters=4, totgauss=200, fmllr_iters=(1, 2),
                fmllr_min_count=50.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test processes share the CPU's cores: one torch thread
    each, the module-scoped runs included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- twins by source text ----------------------------------------------

def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def _mapped(text):
    return text.replace("from kaldi_cnn_tpu.", "from kaldi_cnn_tpu_torch.")


@pytest.mark.parametrize("port", [
    "transform/__init__.py", "transform/lda.py", "transform/mllt.py",
    "transform/fmllr.py", "train.LdaMlltTrainOptions",
    "train.train_lda_mllt", "train.SatTrainOptions", "train.train_sat",
    "egs.EgsConfig", "egs.make_egs", "egs.Egs.save", "egs.Egs.load",
    "rm.fmllr_feats", "rm.estimate_test_fmllr", "rm.score_sweep",
    "synthetic.make_corpus", "synthetic.yesno_lexicon"])
def test_twins_are_verbatim(port):
    """Each twin is its original with the imports pointed at the port."""
    if port.endswith(".py"):
        got = _source(f"kaldi_cnn_tpu_torch/{port}")
        want = _source(f"kaldi_cnn_tpu/{port}")
    else:
        mod, *names = port.split(".")
        pair = {"train": (ttrain, jtrain), "egs": (tegs, jegs),
                "rm": (rm, jrm), "synthetic": (synthetic, jsyn)}[mod]
        got, want = (inspect.getsource(functools.reduce(getattr, names, m))
                     for m in pair)
    assert got == _mapped(want)


# ---- estimates on seeded numpy stats ------------------------------------

@pytest.mark.parametrize("T,left,right", [(10, 3, 3), (3, 4, 4), (1, 5, 2),
                                          (40, 4, 4)])
def test_splice_frames_bit_equal(T, left, right):
    f = np.random.default_rng(T).normal(size=(T, 13)).astype(np.float32)
    got = TF.splice_frames(f, left, right)
    want = np.asarray(JF.splice_frames(f, left, right))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (T, (left + right + 1) * 13)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, left * 13:(left + 1) * 13], f)


def _stats(seed, T=400, D=6, M=5):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, D)) @ rng.normal(size=(D, D)) + 0.5
    means = rng.normal(size=(M, D))
    inv_vars = rng.uniform(0.5, 2.0, size=(M, D))
    post = rng.dirichlet(np.ones(M), size=T)
    return feats.astype(np.float32), means, inv_vars, post


@pytest.mark.parametrize("seed", [0, 1])
def test_lda_estimate_bit_equal(seed):
    feats, _, _, _ = _stats(seed, D=9)
    classes = np.random.default_rng(seed + 10).integers(0, 7, len(feats))
    w = np.random.default_rng(seed + 20).uniform(0.5, 1.0, len(feats))
    outs = []
    for mod in (tlda, jlda):
        est = mod.LdaEstimate(7, 9)
        est.accumulate(feats, classes)
        est.accumulate(feats[:50], classes[:50], weights=w[:50])
        outs.append(est.estimate(4))
    (got, gobjf), (want, wobjf) = outs
    assert got.shape == (4, 10) and gobjf == wobjf
    np.testing.assert_array_equal(got, want)
    x = feats[:5].astype(np.float64)
    np.testing.assert_array_equal(tlda.apply_affine(x, got),
                                  jlda.apply_affine(x, want))
    np.testing.assert_array_equal(tlda.compose_affine(got[:, :5], got),
                                  jlda.compose_affine(want[:, :5], want))


@pytest.mark.parametrize("seed", [0, 1])
def test_mllt_update_bit_equal(seed):
    feats, means, inv_vars, post = _stats(seed)
    outs = []
    for mod in (tmllt, jmllt):
        acc = mod.MlltAccs(feats.shape[1])
        acc.accumulate(feats, means, inv_vars, post)
        M = acc.update(num_iters=5)
        outs.append((M, acc.objf(M), acc.objf(np.eye(acc.dim))))
    (got, gobjf, gid), (want, wobjf, _) = outs
    np.testing.assert_array_equal(got, want)
    assert gobjf == wobjf and gobjf > gid


@pytest.mark.parametrize("seed", [0, 1])
def test_fmllr_update_and_auxf_bit_equal(seed):
    feats, means, inv_vars, post = _stats(seed)
    outs = []
    for mod in (tfmllr, jfmllr):
        acc = mod.FmllrAccs(feats.shape[1])
        acc.accumulate_gmm(feats, means, inv_vars, post)
        W = acc.update(num_iters=5, min_count=10.0)
        eye = np.concatenate([np.eye(acc.dim), np.zeros((acc.dim, 1))], 1)
        outs.append((W, acc.auxf(W), acc.auxf(eye),
                     acc.update(min_count=1e9)))
    (got, gaux, gid, gnone), (want, waux, _, wnone) = outs
    np.testing.assert_array_equal(got, want)
    assert gaux == waux and gaux > gid
    assert gnone is None and wnone is None


# ---- the GMM chain in both packages --------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """mono -> tri1 (cut) then train_lda_mllt and train_sat (LDA_OPTS,
    SAT_OPTS) in both packages on the same MFCC features (the port's, at
    the recipe's dither) of the recipe's corpus cut to 14 utterances, each
    package with its own Lang (training updates transition models in
    place); the LDA and SAT stages see the 13 statics, as in rm.run."""
    load_jax_native(tmp_path_factory)
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_corpus(lex, wp, 14, 1, 4, 29)
    train, dev = corpus.split(0.25)
    feats = yesno.compute_features(train, 29, "cpu")
    dev_feats = yesno.compute_features(dev, 30, "cpu")
    raw = {u: f[:, :13] for u, f in feats.items()}

    def boot(mod, lang, splice):
        am0, ali0 = mod.train_mono(feats, train.transcripts, lang,
                                   mod.MonoTrainOptions(num_iters=4,
                                                        totgauss=100))
        _, ali1, tri1 = mod.train_deltas(
            feats, train.transcripts, lang, ali0, lang.trans_model,
            mod.DeltasTrainOptions(num_iters=3, totgauss=200,
                                   max_leaves=60))
        am2, ali2, tri2, T = mod.train_lda_mllt(
            raw, train.transcripts, lang, ali1, tri1.trans_model,
            mod.LdaMlltTrainOptions(**LDA_OPTS))
        lda_tr = {u: (np.asarray(splice(f, 3, 3))
                      @ T[:, :-1].T + T[:, -1]).astype(np.float32)
                  for u, f in raw.items()}
        am3, ali3, xforms = mod.train_sat(
            lda_tr, train.transcripts, tri2, ali2,
            opts=mod.SatTrainOptions(**SAT_OPTS))
        return dict(ali1=ali1, tri1=tri1, am2=am2, ali2=ali2, tri2=tri2,
                    T=T, am3=am3, ali3=ali3, xforms=xforms)

    out = dict(
        j=boot(jtrain, jhclg.Lang.create(jsyn.digits_lexicon()),
               JF.splice_frames),
        t=boot(ttrain, thclg.Lang.create(synthetic.digits_lexicon()),
               TF.splice_frames))
    for k, (mod, arpa) in (("j", (jhclg, jarpa)), ("t", (thclg, tarpa))):
        tri2 = out[k]["tri2"]
        graph = JGraph if k == "j" else CompiledGraph
        out[k]["hclg"] = graph(
            mod.make_hclg_from_arpa(tri2, arpa.make_unigram_arpa(wp)),
            tri2.trans_model.trans_id_to_pdf_array())
    out.update(raw=raw, dev_raw={u: f[:, :13] for u, f in dev_feats.items()},
               train=train, dev=dev, wp=wp)
    return out


def test_lda_mllt_transform_and_alignments_bit_equal(chain):
    j, t = chain["j"], chain["t"]
    assert t["T"].shape == (20, 7 * 13 + 1)
    np.testing.assert_array_equal(t["T"], j["T"])
    for which in ("ali2", "ali3"):
        assert sorted(t[which]) == sorted(j[which]) == sorted(chain["raw"])
        for u in j[which]:
            np.testing.assert_array_equal(t[which][u], j[which][u])


@pytest.mark.parametrize("which", ["am2", "am3"])
def test_lda_mllt_and_sat_gaussians_bit_equal(chain, which):
    got, want = chain["t"][which], chain["j"][which]
    assert type(got).__module__.startswith("kaldi_cnn_tpu_torch.")
    assert got.num_pdfs == want.num_pdfs
    assert got.total_gauss() == want.total_gauss()
    for a, b in zip(got.gmms, want.gmms):
        for k in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(
        chain["t"]["tri2"].trans_model.log_probs,
        chain["j"]["tri2"].trans_model.log_probs)


def test_sat_transforms_bit_equal(chain):
    got, want = chain["t"]["xforms"], chain["j"]["xforms"]
    assert sorted(got) == sorted(want) and len(got) >= 1
    for u in want:
        assert got[u].dtype == np.float32
        np.testing.assert_array_equal(got[u], want[u])


def test_fmllr_feats_bit_equal(chain):
    args = (chain["t"]["T"], chain["t"]["xforms"],
            {u: u for u in chain["raw"]})
    got = rm.fmllr_feats(chain["raw"], *args)
    want = jrm.fmllr_feats(chain["raw"], *args)
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
        assert got[u].shape[1] == 20


@pytest.fixture(scope="module")
def dev_decode(chain):
    """The two-pass GMM decode of the dev utterances: the port's
    ``rm.gmm_decode`` against JAX rm.run's ``gmm_decode`` closure,
    written out here with the JAX package's functions."""
    j, t = chain["j"], chain["t"]
    raw = chain["dev_raw"]
    jlda_f = {u: jlda.apply_affine(np.asarray(JF.splice_frames(f, 3, 3)),
                                   j["T"]).astype(np.float32)
              for u, f in raw.items()}
    jxf = jrm.estimate_test_fmllr(j["am2"], j["hclg"], j["tri2"], jlda_f)
    jlats, jfeats = {}, {}
    for u, f in jlda_f.items():
        W = jxf.get(u)
        g = f if W is None else (f @ W[:, :-1].T + W[:, -1])
        jlats[u] = j_lattice_decode(j["hclg"], j["am3"].loglikes(g),
                                    acoustic_scale=0.1, beam=60.0,
                                    lattice_beam=8.0, max_active=2000)
        jfeats[u] = f if W is None else g.astype(np.float32)
    txf = rm.estimate_test_fmllr(t["am2"], t["hclg"], t["tri2"],
                                 rm.lda_feats(raw, t["T"]))
    tlats, tfeats = rm.gmm_decode(raw, t["T"], t["am2"], t["am3"],
                                  t["hclg"], t["tri2"])
    return dict(jxf=jxf, txf=txf, jlats=jlats, tlats=tlats, jfeats=jfeats,
                tfeats=tfeats)


def test_estimate_test_fmllr_equals_jax(dev_decode):
    got, want = dev_decode["txf"], dev_decode["jxf"]
    assert sorted(got) == sorted(want) and len(got) >= 1
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])


def test_gmm_decode_equals_jax(dev_decode):
    """Same one-best words and costs, and the same fMLLR'd features."""
    tl, jl = dev_decode["tlats"], dev_decode["jlats"]
    assert sorted(tl) == sorted(jl)
    for u in jl:
        _, w, c = shortest_path(tl[u], 1.0, 0.1)
        _, jw, jc = j_shortest_path(jl[u], 1.0, 0.1)
        assert list(w) == list(jw), u
        assert c == pytest.approx(jc, rel=LAT_COST_REL, abs=LAT_COST_ABS)
        np.testing.assert_array_equal(dev_decode["tfeats"][u],
                                      dev_decode["jfeats"][u])


@pytest.fixture(scope="module")
def egs(chain):
    feats = rm.fmllr_feats(chain["raw"], chain["t"]["T"],
                           chain["t"]["xforms"],
                           {u: u for u in chain["raw"]})
    t2p = chain["t"]["tri2"].trans_model.trans_id_to_pdf_array()
    got = tegs.make_egs(feats, chain["t"]["ali3"], t2p,
                        tegs.EgsConfig(left_context=4, right_context=4))
    want = jegs.make_egs(feats, chain["t"]["ali3"], t2p,
                         jegs.EgsConfig(left_context=4, right_context=4))
    return got, want


def test_make_egs_bit_equal(egs, tmp_path):
    got, want = egs
    assert got.x.shape[1] == 9 * 20
    for k in ("x", "y", "weights"):
        assert getattr(got, k).dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    path = str(tmp_path / "egs.npz")
    got.save(path)
    back = jegs.Egs.load(path)
    for k in ("x", "y", "weights"):
        np.testing.assert_array_equal(getattr(tegs.Egs.load(path), k),
                                      getattr(back, k))


# ---- the slice as a whole -----------------------------------------------

def test_slice_decodes_like_jax(chain, egs, dev_decode):
    """A p-norm DNN on the fMLLR egs (2 x Affine -> Pnorm 60/12 ->
    Normalize) trained by the JAX package for two epochs, its parameters
    carried into the port: loglikes of fMLLR rows (training and dev
    utterances of up to 128 frames) within LOGLIKE_ATOL and the same
    one-best words key by key from both packages' ``decode_utterances``
    (one 128-frame bucket, batches of one utterance: a lattice does not
    depend on its batch)."""
    eg, _ = egs
    num_pdfs = chain["t"]["tri2"].trans_model.num_pdfs
    n_valid = 256
    train = jegs.Egs(eg.x[n_valid:], eg.y[n_valid:], eg.weights[n_valid:])
    valid = jegs.Egs(eg.x[:n_valid], eg.y[:n_valid], eg.weights[:n_valid])
    cfg = dict(input_dim=180, num_hidden_layers=2, pnorm_input_dim=60,
               pnorm_output_dim=12, num_pdfs=num_pdfs)
    jnet = jfactory.make_pnorm_dnn(jfactory.PnormDnnConfig(**cfg))
    params = jax.device_get(jtr.train_nnet(
        jnet, train, valid, jtr.TrainConfig(
            num_epochs=2, minibatch_size=256, initial_learning_rate=0.08,
            final_learning_rate=0.008, seed=29))[0])
    net = tfactory.make_pnorm_dnn(tfactory.PnormDnnConfig(**cfg),
                                  device="cpu")
    params_from_jax(net, params)
    counts = np.bincount(train.y, minlength=num_pdfs)
    jam = JAmNnet(jnet, num_pdfs)
    jam.set_priors_from_counts(counts)
    am = AmNnet(net, num_pdfs)
    am.set_priors_from_counts(counts)
    feats = {**rm.fmllr_feats(chain["raw"], chain["t"]["T"],
                              chain["t"]["xforms"],
                              {u: u for u in chain["raw"]}),
             **dev_decode["tfeats"]}
    utts = [u for u in sorted(feats) if feats[u].shape[0] <= 128][:3]
    assert len(utts) >= 2
    jlls = {u: np.asarray(jam.loglikes(params, np.asarray(
        JF.splice_frames(feats[u], 4, 4)))) for u in utts}
    lls = am.loglikes_batch({u: TF.splice_frames(feats[u], 4, 4)
                             for u in utts})
    for u in utts:
        np.testing.assert_allclose(lls[u], jlls[u], rtol=0,
                                   atol=LOGLIKE_ATOL)
    kw = dict(acoustic_scale=0.1, beam=60.0, lattice_beam=8.0,
              max_active=2000, lattice_arcs_per_frame=None, batch_size=1)
    # one JAX decoder for the decode and any raw-lattice decode below, so
    # that its jit compiles once
    jdec = TpuTopKDecoder(chain["j"]["hclg"], beam=60.0, max_active=2000,
                          acoustic_scale=0.1, lattice_beam=8.0,
                          lattice_arcs_per_frame=None)
    jlats = j_decode_utterances(chain["j"]["hclg"], jlls, decoder=jdec, **kw)
    lats = rm.decode_utterances(chain["t"]["hclg"], lls, device="cpu", **kw)
    assert sorted(lats) == sorted(jlats) == utts
    raw = {}
    for u in utts:
        _, w, c = shortest_path(lats[u], 1.0, 0.1)
        _, jw, jc = j_shortest_path(jlats[u], 1.0, 0.1)
        if jlats[u].num_arcs == 0 and lats[u].num_arcs > 0:
            # ROADMAP 3.24: JAX's determinization ran out of pops and
            # gave an empty lattice; the port's gives the best path of
            # the raw lattice, JAX's raw lattice here
            raw.update(j_decode_utterances(chain["j"]["hclg"],
                                           {u: jlls[u]}, determinize=False,
                                           decoder=jdec, **kw))
            _, jw, jc = j_shortest_path(raw[u], 1.0, 0.1)
        assert list(w) == list(jw), u
        assert c == pytest.approx(jc, rel=LAT_COST_REL, abs=LAT_COST_ABS)


# ---- the recipes on the CPU ----------------------------------------------

def _recording(calls):
    """rm.nnet_decode that keeps its arguments in ``calls``."""
    decode = rm.nnet_decode

    def record(am, feats, hclg):
        calls.append((am, feats, hclg))
        return decode(am, feats, hclg)
    return record


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One rm.run with its stage artifacts in ``exp``, the result and the
    (am, features, graph) of its two DNN decodes.  Its decode_utterances
    runs in batches of 1 rather than 16: a short batch is padded with
    copies of its last utterance, so the lattices are the same and the
    CPU searches no copies."""
    exp = str(tmp_path_factory.mktemp("rm") / "exp")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rm, "nnet_decode", _recording(calls))
        mp.setattr(rm, "decode_utterances", functools.partial(
            rm.decode_utterances, batch_size=1))
        res = rm.run(exp_dir=exp, **RUN)
    return exp, res, calls


def test_run_completes_with_the_jax_result_keys(full_run):
    _, res, calls = full_run
    assert JAX_KEYS <= set(res)
    assert res["words"] > 0 and res["missing_utts"] == 0
    for k in ("wer", "gmm_dev_wer", "dnn_dev_wer", "gmm_test_wer"):
        assert 0.0 <= res[k] <= 100.0, k
    assert set(STAGES) <= set(res["seconds"])
    assert res["tree_leaves"] > 60 and res["graph_states"] > 163
    assert len(calls) == 2
    for _, feats, _ in calls:
        assert all(f.dtype == np.float32 and f.shape[1] == 20
                   for f in feats.values())


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
    with open(os.path.join(exp, "stage05_dnn_train.pkl"), "rb") as f:
        params = pickle.load(f)
    assert isinstance(params[0]["w"], np.ndarray)


class _Decoding(Exception):
    pass


def test_run_resumes_after_the_gmm_chain(full_run, monkeypatch):
    """Delete the dnn_train artifact and resume: the five GMM-chain
    artifacts are not rewritten, the redone one holds the full run's
    parameters bit for bit, and the first DNN decode gets the full run's
    features, priors and graph: the tri3b_sat artifact carries the tri2b
    Lang whose transitions SAT training updated (the resumed run stops
    at that decode)."""
    exp, _, calls = full_run
    names = sorted(f for f in os.listdir(exp) if f.startswith("stage"))
    with open(os.path.join(exp, names[-1]), "rb") as fh:
        before = pickle.load(fh)
    keep = names[:-1]
    os.remove(os.path.join(exp, names[-1]))
    mtimes = {f: os.path.getmtime(os.path.join(exp, f)) for f in keep}
    assert auto_stage(exp) == 5
    resumed = []

    def stop(am, feats, hclg):
        resumed.append((am, feats, hclg))
        raise _Decoding

    monkeypatch.setattr(rm, "nnet_decode", stop)
    with pytest.raises(_Decoding):
        rm.run(exp_dir=exp, stage=auto_stage(exp), **RUN)
    for f in keep:
        assert os.path.getmtime(os.path.join(exp, f)) == mtimes[f]
    assert auto_stage(exp) == 6
    with open(os.path.join(exp, names[-1]), "rb") as fh:
        after = pickle.load(fh)
    for a, b in zip(after, before):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    (am, feats, hclg), = resumed
    full_am, full_feats, full_hclg = calls[0]
    assert sorted(feats) == sorted(full_feats)
    for u in feats:
        np.testing.assert_array_equal(feats[u], full_feats[u])
    np.testing.assert_array_equal(am.priors, full_am.priors)
    for k in ("e_src", "e_dst", "e_weight", "e_pdf", "n_src", "n_dst",
              "n_weight", "final"):
        np.testing.assert_array_equal(getattr(hclg, k),
                                      getattr(full_hclg, k))
    assert hclg.num_states == full_hclg.num_states
    for a, b in zip(params_to_numpy(am.nnet), params_to_numpy(full_am.nnet)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_make_corpus_is_the_jax_corpus():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    got = synthetic.make_corpus(lex, wp, 6, 1, 4, 29)
    jlex = jsyn.digits_lexicon()
    want = jsyn.make_corpus(jlex, wp, 6, 1, 4, 29)
    assert got.transcripts == want.transcripts
    for u in want.waves:
        np.testing.assert_array_equal(got.waves[u], want.waves[u])
    train, dev, test = rm.make_corpus(20, 29, eval_utts=8)
    assert len(train.waves) == 20 and len(dev.waves) + len(test.waves) == 8
    with pytest.raises(ValueError):
        rm.make_corpus(eval_utts=8, corpus=got)


def test_yesno_run_wer_zero_and_the_jax_point(monkeypatch):
    """yesno.run at the recipe's size on the CPU reaches WER 0, and the
    JAX package's yesno.run on the same MFCC features (the port's,
    computed once per split) sweeps to the same point and the same
    result."""
    cache = {}
    compute = yesno.compute_features

    def features(corpus, seed, *_):
        key = (tuple(sorted(corpus.waves)), seed)
        if key not in cache:
            cache[key] = compute(corpus, seed, "cpu")
        return cache[key]

    jwers = []
    jwer_details = jyesno.wer_details

    def recorded(refs, hyps):
        r = jwer_details(refs, hyps)
        jwers.append(r)
        return r

    monkeypatch.setattr(yesno, "compute_features",
                        lambda c, seed, device: features(c, seed))
    monkeypatch.setattr(jyesno, "compute_features",
                        lambda c, use_pallas=None, seed=0: features(c, seed))
    monkeypatch.setattr(jyesno, "wer_details", recorded)
    res = yesno.run(device="cpu")
    want = jyesno.run()
    assert res["wer"] == 0.0 and res["words"] > 20
    grid = [(s, w) for s in yesno.SCALES for w in yesno.WIPS]
    assert len(jwers) == len(grid) + 1
    dev = [r["wer"] for r in jwers[:-1]]
    assert res["point"] == grid[int(np.argmin(dev))]
    assert res["dev_wer"] == min(dev)
    for k in ("wer", "errors", "words", "per_utt"):
        assert res[k] == want[k], k
