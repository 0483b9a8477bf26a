"""The port's random draws against the JAX package's, draw by draw.

torch cannot reproduce ``jax.random`` (ROADMAP 3.1, 3.20), so the
dither and the net init are held to the same distribution: the same
shapes and elements drawn, mean and standard deviation, and a
two-sample KS test between the packages.  The numpy draws (GMM
splitting, the egs shuffle and epoch orders) are bit-equal.  The
per-stage seed derivation gives every utterance of train, dev and test
its own stream (the 3.8 pattern: dev and test must not share noise).
``scripts/draw_audit.py`` runs the same at the recipes' shapes.
"""

import jax
import numpy as np
import pytest
from scipy import stats

from kaldi_cnn_tpu.core.rng import np_rng as jax_np_rng, stage_key
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.features.extractor import FeatureExtractor as JExtractor
from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.features.extractor import (
    FeatureExtractor as TExtractor)

KS_P = 1e-3     # a two-sample KS p below this is a mismatch


def _raw_opts(pkg_f, kind):
    """The recipe's options with everything after the dither turned off,
    so the frames of a zero wave are the noise itself."""
    opts = pkg_f.MfccOptions() if kind == "mfcc" else pkg_f.FbankOptions()
    fo = opts.frame_opts
    fo.samp_freq = 8000.0
    fo.dither = 1.0
    fo.remove_dc_offset = False
    fo.preemph_coeff = 0.0
    fo.window_type = "rectangular"
    fo.round_to_power_of_two = False
    return opts


def _jax_noise(lengths, kind, seed):
    ex = JExtractor(kind, _raw_opts(JF, kind), bucket_seconds=1.0,
                    device="cpu", use_pallas=False)
    ex._fn = lambda wave, o, key: JF.frame_signal(wave, o.frame_opts, key)[0]
    waves = {f"u{i:02d}": np.zeros(n, np.float32)
             for i, n in enumerate(lengths)}
    return ex.extract_corpus(waves, stage_key(seed, f"{kind}_dither"))


def _port_noise(lengths, kind, seed):
    ex = TExtractor(_raw_opts(TF, kind), device="cpu")
    ex._fn = lambda x, o, gen: TF.frame_signal(x, o.frame_opts, gen)[0]
    waves = {f"u{i:02d}": np.zeros(n, np.float32)
             for i, n in enumerate(lengths)}
    return ex.extract_corpus(waves, seed)


LENGTHS = (7000, 7000, 7600, 6400)    # under one 1 s bucket: one JAX jit


@pytest.fixture(scope="module")
def noise():
    """{(package, set): {utt: [T, 200]}} for train / dev / test at the
    recipes' seed offsets (RM seed 29: 29 / 30 / 31)."""
    out = {}
    for k, name in enumerate(("train", "dev", "test")):
        out["jax", name] = _jax_noise(LENGTHS, "mfcc", 29 + k)
        out["port", name] = _port_noise(LENGTHS, "mfcc", 29 + k)
    return out


def test_dither_draws_follow_jax_distribution(noise):
    for name in ("train", "dev", "test"):
        j, t = noise["jax", name], noise["port", name]
        assert list(j) == list(t)
        for u in j:
            assert j[u].shape == t[u].shape == (
                TF.num_frames(LENGTHS[int(u[1:])], _raw_opts(
                    TF, "mfcc").frame_opts), 200)
            assert np.all(t[u] != 0) and np.all(j[u] != 0)
        ja = np.concatenate([v.ravel() for v in j.values()])
        ta = np.concatenate([v.ravel() for v in t.values()])
        for a in (ja, ta):
            assert abs(a.mean()) < 4 / np.sqrt(a.size)
            assert abs(a.std() - 1.0) < 4 / np.sqrt(2 * a.size)
        assert stats.ks_2samp(ja, ta).pvalue > KS_P


def test_stage_streams_are_independent(noise):
    """No two utterances of train, dev and test share a stream: every
    pair's correlation is within 4 sigma of 0, and none is identical."""
    for pkg in ("jax", "port"):
        rows = [v.ravel()[:8000] for name in ("train", "dev", "test")
                for v in noise[pkg, name].values()]
        m = np.stack(rows)
        c = np.corrcoef(m)
        np.fill_diagonal(c, 0.0)
        assert np.abs(c).max() < 4 / np.sqrt(m.shape[1]), pkg
        for i in range(len(m)):
            for k in range(i + 1, len(m)):
                assert not np.array_equal(m[i], m[k])


@pytest.mark.parametrize("kind", ["pnorm_dnn", "cnn"])
def test_init_draws_follow_jax_distribution(kind):
    from kaldi_cnn_tpu.models import factory as jfac
    from kaldi_cnn_tpu_torch.models import factory as tfac
    if kind == "pnorm_dnn":
        def make(f, **kw):
            return f.make_pnorm_dnn(f.PnormDnnConfig(
                input_dim=90, num_hidden_layers=2, pnorm_input_dim=400,
                pnorm_output_dim=80, num_pdfs=60), **kw)
        jnet = make(jfac)
    else:
        def make(f, **kw):
            return f.make_convnet(f.ConvnetConfig(
                in_t=11, in_f=12, in_c=3, filt_t=4, filt_f=7,
                num_filters=16, pool_t=2, pool_f=3, pool_c=1,
                num_hidden_layers=1, pnorm_input_dim=400,
                pnorm_output_dim=80, num_pdfs=60), **kw)
        jnet = make(jfac, use_pallas=False)
    jp = jnet.init(jax.random.PRNGKey(int(stage_key(29, "init")[1])))
    tnet = make(tfac, device="cpu").init(torch_generator(29, "init"))
    compared = 0
    for jc, tc in zip(jp, tnet.components):
        for k in ("w", "b"):
            if k not in jc:
                continue
            ja = np.asarray(jc[k], np.float64).ravel()
            ta = getattr(tc, k).detach().double().numpy().ravel()
            assert ja.shape == ta.shape
            if not ja.any():            # the output layer starts at 0
                assert not ta.any()
                continue
            assert stats.ks_2samp(ja, ta).pvalue > KS_P, (tc, k)
            assert abs(ta.std() / ja.std() - 1) < 8 / np.sqrt(ja.size)
            compared += 1
    assert compared >= 4


def test_numpy_draws_equal_jax():
    from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm as JGmm
    from kaldi_cnn_tpu.train.egs import Egs as JEgs, EgsBatcher as JB
    from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm as TGmm
    from kaldi_cnn_tpu_torch.train.egs import Egs as TEgs, EgsBatcher as TB
    g = np.random.default_rng(0)
    w, m = np.full(4, 0.25), g.normal(size=(4, 13))
    v = g.uniform(0.5, 2.0, (4, 13))
    a = JGmm(w, m, v).split(12, np.random.default_rng(29))
    b = TGmm(w, m, v).split(12, np.random.default_rng(29))
    np.testing.assert_array_equal(a.means, b.means)
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(
        jax_np_rng(37, "cnn_egs_shuffle").permutation(5000),
        np_rng(37, "cnn_egs_shuffle").permutation(5000))
    n = 1000
    x, y = np.zeros((n, 1), np.float32), np.arange(n, dtype=np.int32)
    wts = np.ones(n, np.float32)
    for e in range(2):
        for (_, jy, jw), (_, ty, tw) in zip(
                JB(JEgs(x, y, wts), 96, 29).epoch(e),
                TB(TEgs(x, y, wts), 96, 29).epoch(e)):
            np.testing.assert_array_equal(jy, ty)
            np.testing.assert_array_equal(jw, tw)
