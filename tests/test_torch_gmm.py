"""Parity of the port's MFCC and GMM bootstrap with the JAX package's, on
the CPU: the plain MFCC versions against ``compute_mfcc`` and
``mfcc_pallas`` (interpret mode) at dither 0, the MFCC extractor with
deltas, the verbatim twins (``core/stages.py``, ``gmm/``, ``tree/``, the
bootstrap trainers, ``paired_sign_test``), ``train_mono`` +
``train_deltas`` fed the JAX package's own MFCC features (bit-equal
alignments, tree and Gaussians), the triphone HCLG arc for arc, both
top-K decoders on it, and the p-norm DNN with converted parameters."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode import score as jscore
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.gmm import train as jtrain
from kaldi_cnn_tpu.lang import arpa as jarpa
from kaldi_cnn_tpu.lang import hclg as jhclg
from kaldi_cnn_tpu.models import factory as jfactory
from kaldi_cnn_tpu.ops.fbank_pallas import mfcc_pallas
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.yesno import compute_features as j_features
from kaldi_cnn_tpu_torch.convert import params_from_jax
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.decode import score as tscore
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.gmm import train as ttrain
from kaldi_cnn_tpu_torch.lang import arpa as tarpa
from kaldi_cnn_tpu_torch.lang import hclg as thclg
from kaldi_cnn_tpu_torch.models import factory as tfactory
from kaldi_cnn_tpu_torch.ops import fbank as fb
from kaldi_cnn_tpu_torch.recipes import synthetic
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
from test_torch_lang import assert_fst_equal, load_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CEPS, LIFTER = 13, 22.0
# MFCC, port vs JAX: log-mel agrees to 1e-3 (the fbank limit); the DCT is
# orthonormal and the lifter scales cepstrum c by up to 1 + 22/2, so each
# cepstrum is held to MFCC_REL * its lifter coefficient, and column 0
# (raw log energy) to ENERGY_ATOL
MFCC_REL, ENERGY_ATOL = 2e-3, 1e-3


def mfcc_limits(blocks: int = 1) -> np.ndarray:
    """Per-column |port - JAX| limits of an MFCC (+ deltas) matrix: a
    delta block is a combination of the statics whose weights sum to
    at most 1 in absolute value, so it keeps the statics' limits."""
    lim = MFCC_REL * TF.lifter_coeffs(NUM_CEPS, LIFTER).astype(np.float64)
    lim[0] = ENERGY_ATOL
    return np.tile(lim, blocks)


def assert_mfcc_close(got, want, blocks=1):
    assert got.shape == want.shape
    err = np.abs(np.asarray(got, np.float64) - want).max(axis=0)
    bad = np.flatnonzero(err > mfcc_limits(blocks))
    assert not len(bad), (bad, err[bad])


def _opts(pkg, sr, bins=23):
    o = pkg.MfccOptions()
    o.frame_opts.samp_freq = float(sr)
    o.frame_opts.dither = 0.0
    o.mel_opts.num_bins = bins
    return o


def _wave(sr):
    """0.75 s of digit speech at 8 kHz or of noise at 16 kHz."""
    if sr == 8000:
        lex = synthetic.digits_lexicon()
        corpus = synthetic.make_noisy_corpus(
            lex, {w: 0.1 for w in lex.entries}, 1, 2, 3, 37)
        return next(iter(corpus.waves.values()))[:6000]
    return (np.random.default_rng(4).normal(size=12000) * 1000
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mfcc():
    out = {}
    for sr in (8000, 16000):
        wave = jnp.asarray(_wave(sr))
        out[sr] = {"compute_mfcc": np.asarray(JF.compute_mfcc(
            wave, _opts(JF, sr))), "mfcc_pallas": np.asarray(mfcc_pallas(
                wave, _opts(JF, sr)))}
    return out


@pytest.mark.parametrize("ref", ["compute_mfcc", "mfcc_pallas"])
@pytest.mark.parametrize("port", ["compute_mfcc", "mfcc_reference", "mfcc"])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_mfcc_plain_versions_match_jax(jax_mfcc, sr, port, ref):
    """The port's plain MFCC versions (and the kernel wrapper, which takes
    the plain version on a CPU tensor) against both JAX MFCCs."""
    fn = TF.compute_mfcc if port == "compute_mfcc" else getattr(fb, port)
    got = fn(torch.as_tensor(_wave(sr)), _opts(TF, sr)).numpy()
    want = jax_mfcc[sr][ref]
    assert want.shape == (TF.num_frames(len(_wave(sr)),
                                        _opts(TF, sr).frame_opts), NUM_CEPS)
    assert_mfcc_close(got, want)


def test_mfcc_on_cpu_takes_the_plain_version():
    wave = torch.as_tensor(_wave(8000))
    before = fb.fbank_frames.launches
    got = fb.mfcc(wave, _opts(TF, 8000), torch_generator(1, "d"))
    assert fb.fbank_frames.launches == before
    np.testing.assert_array_equal(got.numpy(), fb.mfcc_reference(
        wave, _opts(TF, 8000), torch_generator(1, "d")).numpy())


def test_mfcc_energy_floor_and_lifter_like_jax():
    """energy_floor, no lifter and no energy column, against JAX."""
    wave = _wave(8000)
    for change in (dict(energy_floor=50.0), dict(cepstral_lifter=0.0),
                   dict(use_energy=False)):
        oj, ot = _opts(JF, 8000), _opts(TF, 8000)
        for k, v in change.items():
            setattr(oj, k, v)
            setattr(ot, k, v)
        want = np.asarray(JF.compute_mfcc(jnp.asarray(wave), oj))
        got = fb.mfcc(torch.as_tensor(wave), ot).numpy()
        lim = mfcc_limits()
        if not ot.use_energy:
            lim[0] = MFCC_REL
        err = np.abs(got - want).max(axis=0)
        assert (err <= lim).all(), (change, err)


def test_mfcc_extractor_deltas_match_jax_over_true_frames():
    """FeatureExtractor("mfcc", deltas_order=2) at dither 0 against JAX
    compute_mfcc + compute_deltas over each utterance's true frames."""
    wave = _wave(8000)
    waves = {"a": wave[:3500], "b": wave[3500:]}
    ex = FeatureExtractor(_opts(TF, 8000), device="cpu", deltas_order=2)
    assert ex.kind == "mfcc"
    got = ex.extract_corpus(waves)
    for u, w in waves.items():
        want = np.asarray(JF.compute_deltas(JF.compute_mfcc(
            jnp.asarray(w), _opts(JF, 8000)), 2, 2))
        assert got[u].shape == (want.shape[0], 3 * NUM_CEPS)
        assert_mfcc_close(got[u], want, blocks=3)


def test_compute_features_dithers_from_the_mfcc_stage():
    """yesno.compute_features: MFCC + deltas at dither 1, utterance i
    from stage ("mfcc_dither", i) of the seed."""
    lex = synthetic.digits_lexicon()
    corpus = synthetic.make_noisy_corpus(
        lex, {w: 0.1 for w in lex.entries}, 2, 1, 1, 5)
    got = compute_features(corpus, seed=9, device="cpu")
    opts = TF.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    ex = FeatureExtractor(opts, device="cpu", deltas_order=2)
    for i, u in enumerate(sorted(corpus.waves)):
        want = ex(corpus.waves[u], torch_generator(9, "mfcc_dither", i))
        np.testing.assert_array_equal(got[u], want)
        assert want.shape[1] == 3 * NUM_CEPS


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


@pytest.mark.parametrize("port", [
    "core/stages.py", "gmm/diag_gmm.py", "gmm/am_gmm.py",
    "tree/questions.py", "tree/build.py", "tree/__init__.py",
    "train.MonoTrainOptions", "train.align_equal",
    "train.convert_alignment", "train.DeltasTrainOptions",
    "train.build_tree_lang", "train.train_deltas", "train._train_em",
    "train.train_mono", "score.paired_sign_test", "functional.MfccOptions",
    "functional.dct_matrix", "functional.lifter_coeffs",
    "factory.PnormDnnConfig"])
def test_twins_are_verbatim(port):
    """Each twin is its original with the imports pointed at the port."""
    if port.endswith(".py"):
        got = _source(f"kaldi_cnn_tpu_torch/{port}")
        want = _source(f"kaldi_cnn_tpu/{port}")
    else:
        mod, name = port.split(".")
        pair = {"train": (ttrain, jtrain), "score": (tscore, jscore),
                "functional": (TF, JF),
                "factory": (tfactory, jfactory)}[mod]
        got, want = (inspect.getsource(getattr(m, name)) for m in pair)
    want = want.replace("from kaldi_cnn_tpu.", "from kaldi_cnn_tpu_torch.")
    assert got == want


@pytest.mark.parametrize("a,b", [((3, 9), (0, 9)), ((0, 0), (0, 0)),
                                 ((1, 5), (2, 9))])
def test_paired_sign_test_equals_jax(a, b):
    rng = np.random.default_rng(sum(a + b))
    ea = {f"u{i}": (int(e), 5) for i, e in enumerate(
        rng.integers(a[0], a[1] + 1, 40))}
    eb = {f"u{i}": (int(e), 5) for i, e in enumerate(
        rng.integers(b[0], b[1] + 1, 40))}
    assert tscore.paired_sign_test(ea, eb) == jscore.paired_sign_test(ea, eb)


@pytest.fixture(scope="module")
def bootstrap(tmp_path_factory):
    """train_mono (4 iterations) then train_deltas (3 iterations, 40
    leaves) in both packages on the JAX package's own MFCC features of
    10 noisy digit utterances; each side builds its own Lang, since the
    training updates the transition model in place."""
    load_jax_native(tmp_path_factory)
    jlex = jsyn.digits_lexicon()
    wp = {w: 1.0 / len(jlex.entries) for w in jlex.entries}
    corpus = jsyn.make_noisy_corpus(jlex, wp, 10, 2, 4, 37)
    feats = j_features(corpus, seed=37)

    def boot(mod, lang):
        am0, ali0 = mod.train_mono(feats, corpus.transcripts, lang,
                                   mod.MonoTrainOptions(num_iters=4,
                                                        totgauss=100))
        am1, ali1, tri = mod.train_deltas(
            feats, corpus.transcripts, lang, ali0, lang.trans_model,
            mod.DeltasTrainOptions(num_iters=3, totgauss=200,
                                   max_leaves=40))
        return dict(am0=am0, ali0=ali0, am1=am1, ali1=ali1, tri=tri,
                    lang=lang)

    return dict(
        j=boot(jtrain, jhclg.Lang.create(jlex)),
        t=boot(ttrain, thclg.Lang.create(synthetic.digits_lexicon())),
        feats=feats, wp=wp, transcripts=corpus.transcripts)


@pytest.mark.parametrize("which", ["ali0", "ali1"])
def test_bootstrap_alignments_bit_equal(bootstrap, which):
    got, want = bootstrap["t"][which], bootstrap["j"][which]
    assert sorted(got) == sorted(want) == sorted(bootstrap["feats"])
    for u in want:
        assert got[u].dtype == want[u].dtype
        np.testing.assert_array_equal(got[u], want[u])


@pytest.mark.parametrize("which", ["am0", "am1"])
def test_bootstrap_gaussians_bit_equal(bootstrap, which):
    got, want = bootstrap["t"][which], bootstrap["j"][which]
    assert type(got).__module__.startswith("kaldi_cnn_tpu_torch.")
    assert got.num_pdfs == want.num_pdfs
    assert got.total_gauss() == want.total_gauss()
    for a, b in zip(got.gmms, want.gmms):
        for k in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    f = next(iter(bootstrap["feats"].values()))
    np.testing.assert_array_equal(got.loglikes(f), want.loglikes(f))


def test_bootstrap_tree_and_transitions_bit_equal(bootstrap):
    """The same leaves, the same answer for every (left, centre, right,
    pdf class) context, and the same transition model after training."""
    tri, jtri = bootstrap["t"]["tri"], bootstrap["j"]["tri"]
    ctx, jctx = tri.ctx_dep, jtri.ctx_dep
    assert type(ctx).__module__ == "kaldi_cnn_tpu_torch.tree.build"
    assert ctx.num_pdfs == jctx.num_pdfs == 40
    assert (ctx.context_width, ctx.central_position) == (
        jctx.context_width, jctx.central_position)
    phones = [0] + list(tri.topo.phones)
    for p in tri.topo.phones:
        for st in tri.topo.entry(p).states:
            if st.pdf_class < 0:
                continue
            for left in phones:
                for right in phones:
                    w = [left, p, right]
                    assert ctx.compute(w, st.pdf_class) == jctx.compute(
                        w, st.pdf_class)
    tm, jtm = tri.trans_model, jtri.trans_model
    assert tm.num_transition_ids == jtm.num_transition_ids
    np.testing.assert_array_equal(tm.trans_id_to_pdf_array(),
                                  jtm.trans_id_to_pdf_array())
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)


@pytest.fixture(scope="module")
def tri_graphs(bootstrap):
    wp = bootstrap["wp"]
    fst = thclg.make_hclg_from_arpa(bootstrap["t"]["tri"],
                                    tarpa.make_unigram_arpa(wp))
    jfst = jhclg.make_hclg_from_arpa(bootstrap["j"]["tri"],
                                     jarpa.make_unigram_arpa(wp))
    return fst, jfst


def test_triphone_hclg_equal_arc_for_arc(tri_graphs):
    fst, jfst = tri_graphs
    assert fst.num_states > 163          # larger than the monophone graph
    assert_fst_equal(fst, jfst)


def test_topk_decoders_agree_on_the_triphone_graph(bootstrap, tri_graphs):
    """TopKDecoder and TpuTopKDecoder on the triphone HCLG, fed the JAX
    GMM's loglikes of 2 utterances: the same words, best-path costs
    within rel 1e-5 / abs 1e-2."""
    fst, jfst = tri_graphs
    t2p = bootstrap["j"]["tri"].trans_model.trans_id_to_pdf_array()
    am = bootstrap["j"]["am1"]
    utts = sorted(bootstrap["feats"])[:2]
    lls = [np.asarray(am.loglikes(bootstrap["feats"][u]), np.float32)
           for u in utts]
    kw = dict(beam=16.0, max_active=200, acoustic_scale=0.1)
    got = TopKDecoder(CompiledGraph(fst, t2p), device="cpu",
                      **kw).decode_batch(lls)
    want = TpuTopKDecoder(JGraph(jfst, t2p), **kw).decode_batch(lls)
    for (_, w, c), (_, jw, jc) in zip(got, want):
        assert len(jw) > 0
        assert list(w) == list(jw)
        assert c == pytest.approx(jc, rel=1e-5, abs=1e-2)


def test_pnorm_dnn_predict_matches_jax():
    """make_pnorm_dnn at the recipe's shape (2 x Affine 1000 -> Pnorm 200
    -> Normalize, narrowed), JAX parameters converted across, the output
    layer drawn non-zero: predict and objf within 1e-4."""
    jcfg = jfactory.PnormDnnConfig(input_dim=66, num_hidden_layers=2,
                                   pnorm_input_dim=40, pnorm_output_dim=8,
                                   num_pdfs=12)
    jnet = jfactory.make_pnorm_dnn(jcfg)
    p = [dict(d) for d in jax.device_get(jnet.init(jax.random.PRNGKey(3)))]
    p[-2]["w"] = (np.random.default_rng(3).normal(size=p[-2]["w"].shape)
                  / 3.0).astype(np.float32)
    net = tfactory.make_pnorm_dnn(tfactory.PnormDnnConfig(
        **{k: getattr(jcfg, k) for k in ("input_dim", "num_hidden_layers",
                                         "pnorm_input_dim",
                                         "pnorm_output_dim", "num_pdfs")}),
        device="cpu")
    assert [type(c).__name__ for c in net.components] == [
        type(c).__name__ for c in jnet.components]
    params_from_jax(net, p)
    x = np.random.default_rng(4).normal(size=(50, 66)).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 12, 50)
    want = np.asarray(jnet.predict(p, jnp.asarray(x)))
    got = net.predict(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert float(net.objf(torch.as_tensor(x), torch.as_tensor(y))) == \
        pytest.approx(float(jnet.objf(p, jnp.asarray(x), jnp.asarray(y))),
                      abs=1e-4)
