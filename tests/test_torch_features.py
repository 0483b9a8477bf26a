"""Parity of the PyTorch port's features with the JAX package: the
fbank kernel's plain version against the Pallas fbank kernel (interpret
mode on the CPU), the rfft references against each other, deltas and the
dither generator.  The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.ops.fbank_pallas import fbank_pallas
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.ops import fbank as fb
from kaldi_cnn_tpu_torch.recipes import synthetic

# log-mel and log energy: f32 matmul-DFT (or rfft) in two frameworks,
# sums taken in different orders
ATOL = 1e-3


def _opts(pkg, sr, bins, use_energy=True, dither=0.0):
    o = pkg.FbankOptions()
    o.frame_opts.samp_freq = float(sr)
    o.frame_opts.dither = dither
    o.mel_opts.num_bins = bins
    o.use_energy = use_energy
    return o


def _waves():
    """The slice's 8 kHz corpus speech and 16 kHz noise, from seeds."""
    lex = synthetic.digits_lexicon()
    corpus = synthetic.make_noisy_corpus(
        lex, {w: 0.1 for w in lex.entries}, 1, 2, 3, 37)
    speech = next(iter(corpus.waves.values()))[:12000]
    noise = (np.random.default_rng(3).normal(size=8000) * 1000
             ).astype(np.float32)
    return {8000: speech, 16000: noise}


@pytest.mark.parametrize("sr,bins", [(8000, 36), (16000, 23)])
def test_fbank_reference_matches_pallas(sr, bins):
    wave = _waves()[sr]
    want = np.asarray(fbank_pallas(jnp.asarray(wave),
                                   _opts(JF, sr, bins)))
    got = fb.fbank_reference(torch.as_tensor(wave),
                             _opts(TF, sr, bins)).numpy()
    assert got.shape == want.shape == (TF.num_frames(
        len(wave), _opts(TF, sr, bins).frame_opts), bins + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sr,bins", [(8000, 36), (16000, 23)])
def test_compute_fbank_matches_jax(sr, bins):
    wave = _waves()[sr]
    want = np.asarray(JF.compute_fbank(jnp.asarray(wave),
                                       _opts(JF, sr, bins)))
    got = TF.compute_fbank(torch.as_tensor(wave),
                           _opts(TF, sr, bins)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fbank_on_cpu_takes_the_plain_version():
    wave = torch.as_tensor(_waves()[8000])
    opts = _opts(TF, 8000, 36, use_energy=False)
    before = fb.fbank_frames.launches
    out = fb.fbank(wave, opts)
    assert fb.fbank_frames.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  fb.fbank_reference(wave, opts).numpy())


def test_tables_and_framing_match_jax():
    fo_j, fo_t = _opts(JF, 8000, 36).frame_opts, _opts(TF, 8000, 36
                                                        ).frame_opts
    for wt in ("povey", "hamming", "hanning", "rectangular", "blackman"):
        fo_j.window_type = fo_t.window_type = wt
        np.testing.assert_array_equal(TF.feature_window(fo_t),
                                      JF.feature_window(fo_j))
    np.testing.assert_array_equal(
        TF.mel_banks(TF.MelBanksOptions(num_bins=36), fo_t),
        JF.mel_banks(JF.MelBanksOptions(num_bins=36), fo_j))
    for a, b in zip(TF.dft_matrices(256), JF.dft_matrices(256)):
        np.testing.assert_array_equal(a, b)
    wave = _waves()[8000][:4000]
    for snip in (True, False):
        fo_j.snip_edges = fo_t.snip_edges = snip
        np.testing.assert_array_equal(
            TF.extract_frames(torch.as_tensor(wave), fo_t).numpy(),
            np.asarray(JF.extract_frames(jnp.asarray(wave), fo_j)))


def test_compute_deltas_matches_jax():
    feats = np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32)
    want = np.asarray(JF.compute_deltas(jnp.asarray(feats), 2, 2))
    got = TF.compute_deltas(torch.as_tensor(feats), 2, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dither_is_generator_noise_before_dc_removal():
    """fbank with dither == the plain version on frames + dither * randn
    drawn from the same generator; the noise does not depend on the
    device the frames lie on."""
    wave = torch.as_tensor(_waves()[8000])
    opts = _opts(TF, 8000, 36, use_energy=False, dither=1.0)
    a = fb.fbank(wave, opts, torch_generator(5, "d"))
    b = fb.fbank(wave, opts, torch_generator(5, "d"))
    c = fb.fbank(wave, opts, torch_generator(6, "d"))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert np.abs(a.numpy() - c.numpy()).max() > 0
    frames = TF.extract_frames(wave, opts.frame_opts)
    noise = torch.randn(frames.shape, generator=torch_generator(5, "d"))
    want, _ = fb.fbank_reference_frames(frames + noise, opts)
    np.testing.assert_array_equal(a.numpy(), want.numpy())


def test_extractor_deltas_volume_matches_jax():
    """FeatureExtractor(deltas_order=2) at dither 0 against the JAX
    extractor's Pallas path.  The JAX extractor takes deltas over its
    zero-padded length bucket, so its last order * window frames see
    padding frames; the port replicates the last true frame as Kaldi's
    DeltaFeatures does.  Those frames are compared with JAX deltas taken
    over the true frames."""
    from kaldi_cnn_tpu.features.extractor import FeatureExtractor as JFE
    waves = {"a": _waves()[8000][:6000], "b": _waves()[8000][6000:]}
    opts_j = _opts(JF, 8000, 36, use_energy=False)
    jex = JFE("fbank", opts_j, device="cpu", use_pallas=True,
              deltas_order=2)
    tex = FeatureExtractor(_opts(TF, 8000, 36, use_energy=False),
                           device="cpu", deltas_order=2)
    want = jex.extract_corpus(waves)
    got = tex.extract_corpus(waves)
    edge = 2 * 2
    for u in waves:
        assert got[u].shape == want[u].shape == (got[u].shape[0], 108)
        np.testing.assert_allclose(got[u][:-edge], want[u][:-edge],
                                   rtol=0, atol=ATOL)
        true_deltas = np.asarray(JF.compute_deltas(
            fbank_pallas(jnp.asarray(waves[u]), opts_j), 2, 2))
        np.testing.assert_allclose(got[u], true_deltas, rtol=0, atol=ATOL)


def test_jax_stage_port_deltas_are_the_port_deltas_of_jax_statics():
    """``scripts/jax_stage_features.py --port-deltas`` (arm B of ROADMAP
    3.14's paired run) keeps the JAX package's MFCC statics to the bit
    and takes the port's ``compute_deltas`` over them, to the bit; it
    parts from the JAX extractor's deltas only on each utterance's last
    order * window frames, which JAX takes over its zero-padded bucket."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from jax_stage_features import port_deltas
    from kaldi_cnn_tpu.features.extractor import FeatureExtractor as JFE
    opts = JF.MfccOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.frame_opts.dither = 0.0
    jex = JFE("mfcc", opts, bucket_seconds=1.0, device="cpu",
              use_pallas=False, deltas_order=2)
    speech = _waves()[8000]
    want = jex.extract_corpus({"a": speech[:6000], "b": speech[6000:]})
    edge = 2 * 2
    for f in want.values():
        got = port_deltas(f)
        assert got.shape == f.shape == (f.shape[0], 39)
        np.testing.assert_array_equal(got[:, :13], f[:, :13])
        np.testing.assert_array_equal(got, TF.compute_deltas(
            torch.as_tensor(np.array(f[:, :13])), 2).numpy())
        np.testing.assert_allclose(got[:-edge], f[:-edge], rtol=0,
                                   atol=ATOL)
        assert np.abs(got[-edge:] - f[-edge:]).max() > 10 * ATOL
