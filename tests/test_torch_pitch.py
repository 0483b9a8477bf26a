"""Parity of the port's pitch features with the JAX package: the
numpy twins (verbatim but for their imports) on the 8 kHz speaker
corpus, the pitch verbs through both packages' ``cli.main``, and the
Switchboard recipe's pitch aux rows at the corpus's own sample rate."""

import inspect

import numpy as np
import pytest

from kaldi_cnn_tpu import cli as jcli
from kaldi_cnn_tpu.features import pitch as jp
from kaldi_cnn_tpu_torch import cli as tcli
from kaldi_cnn_tpu_torch.features import pitch as tp
from kaldi_cnn_tpu_torch.io.kaldi_io import read_mat_ark
from kaldi_cnn_tpu_torch.io.wave import write_wave
from kaldi_cnn_tpu_torch.recipes import swbd, wsj

FUNCS = ["PitchOptions", "_candidate_lags", "nccf_frames", "raw_pitch",
         "_nccf_to_pov", "process_pitch", "compute_pitch",
         "compute_and_process_pitch", "add_pitch_features"]


@pytest.fixture(scope="module")
def corpus():
    """The recipe's speaker corpus (8 kHz), 2 speakers x 2 utterances."""
    return swbd.make_corpus(2, 2, seed=43)[0]


@pytest.mark.parametrize("name", FUNCS)
def test_pitch_twins_are_verbatim(name):
    assert inspect.getsource(getattr(tp, name)) == inspect.getsource(
        getattr(jp, name))


def _stream(corpus, chunks, packages):
    """OnlinePitchExtractors of ``packages`` over the corpus's first two
    utterances as one 8 kHz stream, fed in ``chunks`` sizes (cycled);
    with two, checks the committed frames after every chunk (pitch
    equal, pov within 1e-6).  Returns the extractors."""
    wave = np.concatenate([np.asarray(corpus.waves[u], np.float64)
                           for u in sorted(corpus.waves)[:2]])
    exts = [p.OnlinePitchExtractor(p.PitchOptions(samp_freq=8000.0))
            for p in packages]
    i, k = 0, 0
    while i < len(wave):
        n = chunks[k % len(chunks)]
        for e in exts:
            e.accept_waveform(wave[i:i + n])
        i, k = i + n, k + 1
        if len(exts) == 2:
            assert exts[0].num_frames_ready == exts[1].num_frames_ready
            _pitch_equal(exts[0]._committed, exts[1]._committed)
    return exts


def _pitch_equal(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunking", ["1600", "random"])
def test_online_pitch_extractor_matches_jax(corpus, chunking):
    """Chunks of 1600 samples, or of random sizes (1 to 4000): the JAX
    extractor's committed frames and num_frames_ready after every chunk,
    and its final track, frame for frame."""
    r = np.random.default_rng(3)
    chunks = ([1600] if chunking == "1600"
              else r.integers(1, 4000, size=400).tolist())
    ext, jext = _stream(corpus, chunks, (tp, jp))
    got = ext.input_finished()
    assert len(got) > 300
    _pitch_equal(got, jext.input_finished())


def test_online_pitch_extractor_nccf_work_is_linear(corpus, monkeypatch):
    """Over a stream in 400-sample chunks, the NCCF is computed for T
    frames in all, not for every prefix: each frame once (the JAX
    extractor's work on the same stream is the sum of the prefixes)."""
    frames = []
    nccf = tp.nccf_frames

    def count(wave, opts):
        out = nccf(wave, opts)
        frames.append(len(out[0]))
        return out

    monkeypatch.setattr(tp, "nccf_frames", count)
    (ext,) = _stream(corpus, [400], (tp,))
    assert sum(frames) == ext.num_frames == len(ext.input_finished())
    assert len(frames) > 50


def test_pitch_functions_equal_jax_at_8k(corpus):
    topts = tp.PitchOptions(samp_freq=8000.0)
    jopts = jp.PitchOptions(samp_freq=8000.0)
    for u, wave in corpus.waves.items():
        w = np.asarray(wave, np.float64)
        raw = tp.raw_pitch(w, topts)
        np.testing.assert_array_equal(raw, jp.raw_pitch(w, jopts))
        np.testing.assert_array_equal(tp.compute_pitch(w, topts), raw)
        proc = tp.process_pitch(raw, topts)
        np.testing.assert_array_equal(proc, jp.process_pitch(raw, jopts))
        np.testing.assert_array_equal(
            tp.compute_and_process_pitch(w, topts),
            jp.compute_and_process_pitch(w, jopts))
        feats = np.random.default_rng(len(u)).normal(
            size=(len(raw) + 3, 5)).astype(np.float32)
        np.testing.assert_array_equal(tp.add_pitch_features(feats, raw),
                                      jp.add_pitch_features(feats, raw))
        assert raw.shape[1] == 2 and proc.shape == (len(raw), 3)
        assert np.isfinite(proc).all()


def test_pitch_aux_rows_one_per_fbank_frame(corpus):
    """aux_rows(use_pitch=True): the iVector, then exactly one pitch row
    per fbank frame at the corpus's 8 kHz, no edge padding (the JAX
    recipe's 16 kHz default gives about half as many frames and pads
    them; ROADMAP 3.5)."""
    vols = wsj.compute_fbank_volumes(corpus, 12, device="cpu", dither=0.0)
    ivs = {u: np.full(3, 0.5, np.float32) for u in vols}
    aux = swbd.aux_rows(corpus, vols, ivs, use_pitch=True)
    for u, v in vols.items():
        want = jp.compute_and_process_pitch(
            np.asarray(corpus.waves[u], np.float64),
            jp.PitchOptions(samp_freq=8000.0))
        assert aux[u].shape == (v.shape[0], 3 + 3) == (len(want), 6)
        np.testing.assert_array_equal(aux[u][:, 3:], want)
        np.testing.assert_array_equal(aux[u][:, :3], 0.5)
        at_16k = jp.compute_and_process_pitch(
            np.asarray(corpus.waves[u], np.float64))
        assert len(at_16k) < v.shape[0]


def test_pitch_aux_rows_refuse_mismatched_frames(corpus):
    vols = wsj.compute_fbank_volumes(corpus, 12, device="cpu", dither=0.0)
    u = sorted(vols)[0]
    short = {u: vols[u][:-1]}
    with pytest.raises(ValueError, match="pitch frames"):
        swbd.aux_rows(corpus, short, {u: np.zeros(3, np.float32)},
                      use_pitch=True)


def test_pitch_verbs_match_jax(corpus, tmp_path):
    """compute-kaldi-pitch-feats then process-kaldi-pitch-feats through
    both packages' cli.main on 8 kHz WAV files: the same arks."""
    scp = tmp_path / "wav.scp"
    with open(scp, "w") as f:
        for u, wave in sorted(corpus.waves.items()):
            path = tmp_path / f"{u}.wav"
            write_wave(str(path), wave, 8000)
            f.write(f"{u} {path}\n")
    out = {}
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        raw, proc = tmp_path / f"{tag}_raw.ark", tmp_path / f"{tag}_proc.ark"
        assert main(["compute-kaldi-pitch-feats", "--min-f0=60",
                     str(scp), str(raw)]) == 0
        assert main(["process-kaldi-pitch-feats",
                     "--normalization-left-context=50", str(raw),
                     str(proc)]) == 0
        out[tag] = [dict(read_mat_ark(str(p))) for p in (raw, proc)]
    for got, want in zip(out["port"], out["jax"]):
        assert sorted(got) == sorted(want) == sorted(corpus.waves)
        for u in want:
            np.testing.assert_array_equal(got[u], want[u])
    # at each file's own 8 kHz: 200-sample frames every 80 samples
    for u, wave in corpus.waves.items():
        assert out["port"][0][u].shape == ((len(wave) - 200) // 80 + 1, 2)


def test_pitch_verb_has_no_sample_frequency_flag(tmp_path):
    """JAX's --sample-frequency was dead (every file's rate overwrote it);
    the port's verb refuses it."""
    with pytest.raises(SystemExit):
        tcli.main(["compute-kaldi-pitch-feats", "--sample-frequency=8000",
                   str(tmp_path / "wav.scp"), str(tmp_path / "out.ark")])
