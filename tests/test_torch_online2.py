"""Parity of the port's streaming path with the JAX package's, on the CPU:
``OnlineBaseFeature`` (fbank and MFCC through the plain kernel versions)
against the JAX package's at dither 0; the verbatim twins (``online2/``,
``ivector/extractor.py``, the streaming decoder's host commit machinery)
by source text and bit-equal outputs; ``StreamingDecoder`` against
``TpuStreamingDecoder`` and against the port's own ``decode_batch`` on a
long stream; and ``OnlineRecognizer`` with both decoders against the JAX
package's recognizer on the same wave chunks."""

import inspect
import os

import numpy as np
import pytest

from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.topk_decoder import (TpuStreamingDecoder,
                                               TpuTopKDecoder)
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.ivector import extractor as jext
from kaldi_cnn_tpu import online2 as jon
from kaldi_cnn_tpu.online2 import features as jfeat
from kaldi_cnn_tpu.online2 import ivector as jiv
from kaldi_cnn_tpu.recipes import datadir as jdatadir
from kaldi_cnn_tpu_torch.decode import topk_decoder as T
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_cnn_tpu_torch.ivector import extractor as text
from kaldi_cnn_tpu_torch import online2 as ton
from kaldi_cnn_tpu_torch.online2 import features as tfeat
from kaldi_cnn_tpu_torch.online2 import ivector as tiv
from kaldi_cnn_tpu_torch.recipes import datadir as tdatadir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FBANK_ATOL = 1e-3                 # log-mel, port plain vs JAX
MFCC_REL, ENERGY_ATOL = 2e-3, 1e-3   # cepstrum c: MFCC_REL * lifter[c]
COST_ABS = 1e-2                   # best-path cost (the JAX tests' bar)
DELTA_ATOL = 1e-6                 # deltas of N(0, 1) rows, port vs JAX


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def _mapped(text_):
    return text_.replace("from kaldi_cnn_tpu.", "from kaldi_cnn_tpu_torch.")


@pytest.mark.parametrize("path", [
    "online2/__init__.py", "online2/decoder.py", "online2/recognizer.py",
    "online2/ivector.py", "ivector/extractor.py"])
def test_twin_files_are_verbatim(path):
    """Each twin is its original with the imports pointed at the port."""
    assert _source(f"kaldi_cnn_tpu_torch/{path}") == _mapped(
        _source(f"kaldi_cnn_tpu/{path}"))


HOST_MACHINERY = ("_append_level", "_collapse_eps", "_emit_hop",
                  "_step_back", "_try_commit", "_force_commit", "_commit_to",
                  "_level_host", "_trace", "best_path",
                  "trailing_silence_frames", "endpoint_detected")


@pytest.mark.parametrize("name", [
    "features.OnlineCmvnOptions", "features.OnlineCmvn",
    "features.StreamingSplicer",
    "features.OnlineBaseFeature.frame_shift",
    "features.OnlineBaseFeature.accept_waveform",
    "features.OnlineBaseFeature.finish",
    "features.OnlineBaseFeature.num_frames_ready",
    "features.OnlineBaseFeature.get_frames",
    "features.OnlineFeaturePipeline.right_context",
    "features.OnlineFeaturePipeline.accept_waveform",
    "features.OnlineFeaturePipeline.finish",
    "features.OnlineFeaturePipeline.num_frames_ready",
    "datadir.read_key_value_file"]
    + [f"stream.{m}" for m in HOST_MACHINERY])
def test_twin_definitions_are_verbatim(name):
    mod, *attrs = name.split(".")
    pair = {"features": (tfeat, jfeat), "datadir": (tdatadir, jdatadir),
            "stream": (T.StreamingDecoder, TpuStreamingDecoder)}[mod]
    got, want = pair
    for a in attrs:
        got, want = getattr(got, a), getattr(want, a)
    if isinstance(got, property):
        got, want = got.fget, want.fget
    assert inspect.getsource(got) == _mapped(inspect.getsource(want))


# ---------------------------------------------------------------- features

def _options(kind, bins, mod):
    opts = mod.MfccOptions() if kind == "mfcc" else mod.FbankOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.frame_opts.dither = 0.0
    opts.mel_opts.num_bins = bins
    return opts


def _stream(feature, wave, chunk):
    for i in range(0, len(wave), chunk):
        feature.accept_waveform(wave[i:i + chunk])
    feature.finish()
    return feature.get_frames(0, feature.num_frames_ready())


def feature_limits(kind, width):
    """Per-column |port - JAX| limits."""
    if kind == "fbank":
        return np.full(width, FBANK_ATOL)
    lim = MFCC_REL * TF.lifter_coeffs(13, 22.0).astype(np.float64)
    lim[0] = ENERGY_ATOL
    return lim


@pytest.mark.parametrize("kind,bins", [("mfcc", 23), ("fbank", 23),
                                       ("fbank", 36)])
@pytest.mark.parametrize("chunk", [160, 1000, 2048])
def test_online_base_feature_matches_jax(kind, bins, chunk):
    wave = (np.random.default_rng(5).normal(size=6000) * 1000
            ).astype(np.float32)
    want = _stream(jfeat.OnlineBaseFeature(kind, _options(kind, bins, JF)),
                   wave, chunk)
    got = _stream(tfeat.OnlineBaseFeature(kind, _options(kind, bins, TF),
                                          device="cpu"), wave, chunk)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want).max(axis=0)
    assert (err <= feature_limits(kind, got.shape[1])).all(), err


def test_online_base_feature_defaults_to_no_dither():
    a = tfeat.OnlineBaseFeature("fbank", device="cpu")
    assert a.opts.frame_opts.dither == 0.0
    assert jfeat.OnlineBaseFeature("fbank").opts.frame_opts.dither == 0.0


def test_online_base_feature_dithers_from_its_generator():
    """With dither on, the noise comes from the given generator, so two
    runs from one stage agree and another stage differs."""
    from kaldi_cnn_tpu_torch.core.rng import torch_generator
    wave = (np.random.default_rng(6).normal(size=4000) * 100
            ).astype(np.float32)

    def run(index):
        opts = _options("fbank", 23, TF)
        opts.frame_opts.dither = 1.0
        return _stream(tfeat.OnlineBaseFeature(
            "fbank", opts, device="cpu",
            generator=torch_generator(3, "online_dither", index)),
            wave, 1000)
    np.testing.assert_array_equal(run(0), run(0))
    assert np.abs(run(0) - run(1)).max() > 1e-3


def test_online_cmvn_bit_equal():
    x = np.random.default_rng(7).normal(size=(260, 5)).astype(np.float32) + 3
    stats = np.concatenate([np.full((2, 5), 40.0), [[50.0], [0.0]]], axis=1)
    for make in (lambda m: m.OnlineCmvn(),
                 lambda m: m.OnlineCmvn(m.OnlineCmvnOptions(
                     cmn_window=50, min_window=20), global_stats=stats)):
        a, b = make(tfeat), make(jfeat)
        np.testing.assert_array_equal(a.apply(x), b.apply(x))
        np.testing.assert_array_equal(a.apply(x, upto=30),
                                      b.apply(x, upto=30))
        a.freeze(x[0])
        b.freeze(x[0])
        np.testing.assert_array_equal(a.apply(x), b.apply(x))


def test_pipeline_matches_jax_on_the_same_base_frames():
    """Given the same base frames, the pipeline's CMVN equals the JAX
    package's bit for bit; its deltas (fixed-order float32 sums, where
    the JAX package's are an XLA einsum) agree within DELTA_ATOL: the
    two sum the five window terms in other orders."""
    rng = np.random.default_rng(8)
    feats = [rng.normal(size=(n, 13)).astype(np.float32)
             for n in (7, 1, 19, 12)]
    pipes = [tfeat.OnlineFeaturePipeline("mfcc", device="cpu"),
             jfeat.OnlineFeaturePipeline("mfcc")]
    for p in pipes:
        p.base._feats = list(feats)
        p.base._done = sum(len(f) for f in feats)
    n = pipes[0].num_frames_ready()
    assert n == pipes[1].num_frames_ready() == 39 - 4   # right context
    got, want = (p.get_frames(3, n) for p in pipes)
    assert got.shape == want.shape == (32, 39) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :13], want[:, :13])
    np.testing.assert_allclose(got, want, rtol=0, atol=DELTA_ATOL)


@pytest.mark.parametrize("cmvn", ["default", "global_stats", "freeze"])
def test_pipeline_is_incremental_and_equals_the_recomputation(cmvn):
    """ROADMAP 3.26: after every piece of a stream, the port's pipeline
    (which normalizes each frame once and takes the deltas of the range
    asked for) gives the JAX pipeline's whole-stream recomputation on the
    same base frames: CMVN bit for bit, deltas within DELTA_ATOL; the
    frames it normalized over the stream number T; a freeze() mid-stream
    (the mean then applies to every frame) is followed."""
    rng = np.random.default_rng(9)
    pieces = [rng.normal(size=(n, 13)).astype(np.float32) + 2
              for n in (9, 1, 4, 17, 30, 25)]
    stats = np.concatenate([np.full((2, 13), 40.0), [[50.0], [0.0]]],
                           axis=1)

    def make(m):
        if cmvn == "global_stats":
            return m.OnlineCmvn(m.OnlineCmvnOptions(cmn_window=30,
                                                    min_window=20),
                                global_stats=stats)
        return m.OnlineCmvn(m.OnlineCmvnOptions(cmn_window=40))

    port = tfeat.OnlineFeaturePipeline("mfcc", cmvn=make(tfeat), device="cpu")
    ref = jfeat.OnlineFeaturePipeline("mfcc", cmvn=make(jfeat))
    served = 0
    for i, f in enumerate(pieces):
        for p in (port, ref):
            p.base._feats.append(f)
            p.base._done += len(f)
            if cmvn == "freeze" and i == 3:
                p.cmvn.freeze(pieces[0][0])
        n = port.num_frames_ready()
        total = port.base.num_frames_ready()
        # JAX's get_frames(begin, end) is its whole-stream recomputation
        # sliced: one call a piece serves every range
        whole = ref.get_frames(0, total)
        for begin, end in ((served, n), (0, total), (max(total - 3, 0),
                                                      total + 4)):
            got, want = port.get_frames(begin, end), whole[begin:end]
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_array_equal(got[:, :13], want[:, :13])
            np.testing.assert_allclose(got, want, rtol=0, atol=DELTA_ATOL)
        served = n
    if cmvn != "freeze":
        assert port.frames_normalized == sum(len(f) for f in pieces)
    # the range deltas are the whole stream's, bit for bit
    whole = tfeat.OnlineFeaturePipeline("mfcc", cmvn=make(tfeat),
                                        device="cpu")
    whole.base._feats, whole.base._done = [np.concatenate(pieces)], total
    if cmvn == "freeze":
        whole.cmvn.freeze(pieces[0][0])
    np.testing.assert_array_equal(port.get_frames(0, total),
                                  whole.get_frames(0, total))


def test_streaming_splicer_bit_equal():
    rng = np.random.default_rng(8)
    feats = [rng.normal(size=(n, 13)).astype(np.float32)
             for n in (7, 1, 19, 0, 12)]
    w = rng.normal(size=(13 * 9, 4)).astype(np.float32)
    outs = []
    for m in (tfeat, jfeat):
        sp = m.StreamingSplicer(lambda r: r @ w, 4, 4)
        outs.append(np.concatenate([sp(f) for f in feats if len(f)]
                                   + [sp.flush()]))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (39, 4)


def test_ivector_twins_bit_equal():
    rng = np.random.default_rng(9)
    data = [rng.normal(size=(60, 4)) + i for i in range(3)]
    ubms = [m.train_ubm(data, 4, num_iters=2, seed=1) for m in (text, jext)]
    np.testing.assert_array_equal(ubms[0].means, ubms[1].means)
    np.testing.assert_array_equal(ubms[0].vars, ubms[1].vars)
    exts = [m.IvectorExtractor(u, 3, seed=2) for m, u in
            zip((text, jext), ubms)]
    for e in exts:
        e.train(data, num_iters=2)
    np.testing.assert_array_equal(exts[0].M, exts[1].M)
    np.testing.assert_array_equal(exts[0].extract(data[1]),
                                  exts[1].extract(data[1]))
    ivs = [m.OnlineIvectorFeature(e, m.OnlineIvectorOptions(
        ivector_period=5, max_count=50.0)) for m, e in zip((tiv, jiv), exts)]
    for lo in range(0, 60, 13):
        for iv in ivs:
            iv.accept_frames(data[2][lo:lo + 13])
        np.testing.assert_array_equal(ivs[0].ivector(), ivs[1].ivector())
    assert isinstance(ubms[0], DiagGmm)


# ---------------------------------------------------------------- decoding

@pytest.fixture(scope="module")
def setup():
    """A JAX mono GMM on the yesno corpus (as tests/test_online2.py), its
    loglikes, both packages' graphs of the same HCLG, and one JAX
    streaming decoder whose jits compile once."""
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
    from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
    from kaldi_cnn_tpu.recipes import synthetic as jsyn
    from kaldi_cnn_tpu.recipes.yesno import compute_features
    lex = jsyn.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = jsyn.make_corpus(lex, wp, 16, 1, 2, 31)
    feats = compute_features(corpus, seed=31)
    lang = Lang.create(lex)
    am, _ = train_mono(feats, corpus.transcripts, lang,
                       MonoTrainOptions(num_iters=8, totgauss=80))
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(wp))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    jg, g = JGraph(fst, t2p), CompiledGraph(fst, t2p)
    lls = {u: np.asarray(am.loglikes(feats[u]), np.float32)
           for u in sorted(feats)}
    jdec = TpuTopKDecoder(jg, beam=1e8, max_active=jg.num_states + 32,
                          acoustic_scale=0.1)
    return dict(corpus=corpus, lang=lang, am=am, jg=jg, g=g, lls=lls,
                jstream=TpuStreamingDecoder(jdec))


def _port_decoder(setup, **kw):
    kw = {"beam": 1e8, "max_active": setup["g"].num_states + 32, **kw}
    return T.TopKDecoder(setup["g"], acoustic_scale=0.1, device="cpu", **kw)


def _feed(stream, ll, chunk, partials=None):
    stream.reset()
    for i in range(0, ll.shape[0], chunk):
        stream.advance(ll[i:i + chunk])
        part = stream.best_path(use_final=False)
        if partials is not None:
            partials.append(part)
    stream.finalize()
    return stream.best_path()


def test_streaming_decoder_matches_jax(setup):
    """Chunks of 7, 10 and 13 frames (blocks of 8 and 1 and the flush),
    partial best paths read mid-stream: the same tids and words as the
    JAX streaming decoder, and costs within rel 1e-5."""
    stream = T.StreamingDecoder(_port_decoder(setup))
    for n, utt in enumerate(sorted(setup["lls"])[:3]):
        ll = setup["lls"][utt]
        chunk = 7 + 3 * n
        parts, jparts = [], []
        got = _feed(stream, ll, chunk, parts)
        want = _feed(setup["jstream"], ll, chunk, jparts)
        for (t, w, c), (jt, jw, jc) in zip(parts + [got], jparts + [want]):
            assert list(t) == list(jt) and list(w) == list(jw)
            assert c == pytest.approx(jc, rel=1e-5)
        assert stream.num_frames == setup["jstream"].num_frames == len(ll)
    assert stream.capture_seconds == {}        # no graphs on the CPU


def test_streaming_decoder_bounded_long_stream(setup):
    """A 24 s stream (the JAX test runs 61 s; the CPU frame loop is the
    cost here) at beam 30, commit_every 16: the traceback window stays
    within 8 x commit_every, the committed prefix is >= 90 % of the path,
    and the result equals the port's offline decode_batch."""
    rows = np.concatenate([setup["lls"][u] for u in sorted(setup["lls"])]
                          * 3)[:2400]
    dec = _port_decoder(setup, beam=30.0)
    stream = T.StreamingDecoder(dec, commit_every=16)
    max_window = 0
    for i in range(0, rows.shape[0], 25):
        stream.advance(rows[i:i + 25])
        stream.best_path(use_final=False)
        max_window = max(max_window, len(stream._buf))
    stream.finalize()
    tids, words, cost = stream.best_path()
    assert max_window <= 8 * stream.commit_every, max_window
    assert len(stream._ctids) >= 0.9 * len(tids)
    ((tids_o, words_o, cost_o),) = dec.decode_batch([rows])
    assert list(words) == list(words_o) and list(tids) == list(tids_o)
    assert cost == pytest.approx(cost_o, rel=1e-5)


def test_single_utterance_decoder_bit_equal(setup):
    lang = setup["lang"]
    tm, sil = lang.trans_model, lang.phone_table.id("SIL")
    ll = setup["lls"][sorted(setup["lls"])[1]]
    cfg = ton.EndpointConfig(rule_trailing=ton.EndpointRule(
        min_trailing_silence_sec=0.2, max_relative_cost=1e9))
    out = []
    for m, g in ((ton, setup["g"]), (jon, setup["jg"])):
        dec = m.SingleUtteranceDecoder(g, acoustic_scale=0.1, beam=12.0,
                                       max_active=40)
        flags = []
        for i in range(0, len(ll), 9):
            dec.advance(ll[i:i + 9])
            flags.append(dec.endpoint_detected(tm, sil, cfg))
        out.append((dec.best_path(), dec.best_path(use_final=False), flags,
                    dec.trailing_silence_frames(tm, sil)))
    for (a, b) in zip(out[0][:2], out[1][:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    assert out[0][2:] == out[1][2:]


def _mfcc_pipeline(mod, corpus, **kw):
    opts = mod.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 0.0
    return (jon if mod is JF else ton).OnlineFeaturePipeline(
        "mfcc", opts, deltas_order=2, **kw)


@pytest.mark.parametrize("decoder", ["host", "streaming"])
def test_online_recognizer_matches_jax(setup, decoder):
    """The port's recognizer (MFCC through the plain fbank version, the
    host incremental Viterbi or StreamingDecoder) against the JAX
    recognizer with its host decoder on the same wave chunks: the same
    words and the same cost within COST_ABS."""
    corpus, am = setup["corpus"], setup["am"]
    for utt in sorted(corpus.waves)[:2]:
        wave = corpus.waves[utt]
        results = []
        for side in ("port", "jax"):
            if side == "jax":
                rec = jon.OnlineRecognizer(
                    setup["jg"], am.loglikes,
                    pipeline=_mfcc_pipeline(JF, corpus), beam=np.inf,
                    max_active=0)
            else:
                dec = (T.StreamingDecoder(_port_decoder(setup))
                       if decoder == "streaming" else None)
                rec = ton.OnlineRecognizer(
                    setup["g"], am.loglikes,
                    pipeline=_mfcc_pipeline(TF, corpus, device="cpu"),
                    beam=np.inf, max_active=0, decoder=dec)
            for i in range(0, len(wave), 1600):
                rec.accept_waveform(wave[i:i + 1600])
            rec.input_finished()
            results.append(rec.result())
        (t, w, c), (jt, jw, jc) = results
        assert list(w) == list(jw) and len(w) > 0
        assert c == pytest.approx(jc, abs=COST_ABS)
