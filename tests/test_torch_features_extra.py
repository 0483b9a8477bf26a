"""The port's smaller twins against the JAX package's on the CPU:
``decode/biggraph.py`` (the graph array for array at 2000 words, and the
port's top-K decode on it against the host ``viterbi_decode``, JAX's
``test_topk_big_graph_scales`` bar), ``synthetic.large_lexicon``,
``features/resample.py``, ``features/plp.py`` (``compute_plp`` at dither
0 within 2e-3 x lifter, see ``PLP_REL``), ``core/jobs.py`` (launchers'
results and logs, ``split_even``, ``split_scp``) and
``core/profiling.py`` (``accu_profile``, ``StepTimer``, and ``trace``
writing a Chrome trace).  Verbatim parts are held by source text."""

import inspect
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.core import jobs as jjobs
from kaldi_cnn_tpu.core import profiling as jprof
from kaldi_cnn_tpu.decode import biggraph as jbig
from kaldi_cnn_tpu.decode.decoder import viterbi_decode
from kaldi_cnn_tpu.features import plp as jplp
from kaldi_cnn_tpu.features import resample as jres
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu_torch.core import jobs as tjobs
from kaldi_cnn_tpu_torch.core import profiling as tprof
from kaldi_cnn_tpu_torch.decode import biggraph as tbig
from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
from kaldi_cnn_tpu_torch.features import plp as tplp
from kaldi_cnn_tpu_torch.features import resample as tres
from kaldi_cnn_tpu_torch.features.functional import lifter_coeffs
from kaldi_cnn_tpu_torch.recipes import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_FIELDS = ("num_states", "start", "e_src", "e_dst", "e_ilabel",
                "e_olabel", "e_weight", "e_pdf", "n_src", "n_dst",
                "n_olabel", "n_weight", "final")
# PLP, port vs JAX at dither 0: cepstrum c within PLP_REL * lifter[c]
# (phase 9's MFCC rule), the raw log energy (column 0) within
# PLP_ENERGY_ATOL.  The two f32 rffts differ in their last bits and the
# Levinson recursion divides by the prediction error, which is small on
# near-silent frames; the largest error seen on the yesno waves is
# ~4e-6 x lifter, so the rule keeps a wide margin for harder frames.
PLP_REL = 2e-3
PLP_ENERGY_ATOL = 1e-3


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def _mapped(text):
    return text.replace("kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")


@pytest.mark.parametrize("path", [
    "decode/biggraph.py", "features/resample.py", "core/jobs.py"])
def test_twins_are_verbatim(path):
    """Each twin is its original with the imports pointed at the port
    (``core/jobs.py``'s docstring names torch.distributed)."""
    want = _mapped(_source(f"kaldi_cnn_tpu/{path}")).replace(
        "jax.distributed", "torch.distributed").replace(
        "NumPy/JAX", "NumPy/PyTorch")
    assert _source(f"kaldi_cnn_tpu_torch/{path}") == want


@pytest.mark.parametrize("mod,names", [
    ("plp", ("PlpOptions", "_equal_loudness", "_idft_bases", "_levinson",
             "_lpc_to_cepstrum")),
    ("profiling", ("accu_profile", "print_profile", "StepTimer")),
    ("synthetic", ("large_lexicon",))])
def test_verbatim_functions(mod, names):
    jmod, tmod = {"plp": (jplp, tplp), "profiling": (jprof, tprof),
                  "synthetic": (jsyn, tsyn)}[mod]
    for name in names:
        assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(
            getattr(jmod, name)), name


# -------------------------------------------------------------- big graph

@pytest.fixture(scope="module")
def big():
    return (tbig.make_big_graph(num_words=2000, num_pdfs=64, seed=1),
            jbig.make_big_graph(num_words=2000, num_pdfs=64, seed=1))


def test_big_graph_equal(big):
    g, jg = big
    assert g.num_states > 10_000
    for k in GRAPH_FIELDS:
        a, b = getattr(g, k), getattr(jg, k)
        assert np.asarray(a).dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for s in (0, 1):
        np.testing.assert_array_equal(tbig.sample_loglikes(g, 64, 40, s),
                                      jbig.sample_loglikes(jg, 64, 40, s))


def test_topk_big_graph_matches_host_viterbi(big):
    """The port's top-K search (K = 4096, far below the 10^4 states) on
    peaked acoustics gives the host exact Viterbi's words and cost."""
    g, jg = big
    lls = [tbig.sample_loglikes(g, 64, T=40, seed=s) for s in (0, 1)]
    dec = TopKDecoder(g, beam=80.0, max_active=4096, acoustic_scale=1.0,
                      device="cpu")
    for ll, (tids, words, cost) in zip(lls, dec.decode_batch(lls)):
        _, words_h, cost_h = viterbi_decode(jg, ll, acoustic_scale=1.0,
                                            beam=np.inf, max_active=0)
        assert len(tids) == ll.shape[0]
        assert cost == pytest.approx(cost_h, rel=1e-4, abs=0.1)
        assert list(words) == list(words_h)


@pytest.mark.parametrize("num_words,seed", [(60, 7), (500, 3)])
def test_large_lexicon_equal(num_words, seed):
    lex = tsyn.large_lexicon(num_words, seed)
    jlex = jsyn.large_lexicon(num_words, seed)
    assert lex.entries == jlex.entries
    assert len(lex.entries) == num_words
    assert (lex.silence_phone, lex.optional_silence_prob) == (
        jlex.silence_phone, jlex.optional_silence_prob)


# -------------------------------------------------------------- features

@pytest.mark.parametrize("rate_in,rate_out", [
    (16000.0, 8000.0), (8000.0, 16000.0), (16000.0, 11025.0),
    (8000.0, 8000.0)])
def test_resample_equal(rate_in, rate_out):
    wave = np.random.default_rng(3).normal(size=4000).astype(np.float32)
    got = tres.resample_waveform(wave, rate_in, rate_out)
    want = jres.resample_waveform(wave, rate_in, rate_out)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _plp_opts(mod, rate, **kw):
    o = mod.PlpOptions(**kw)
    o.frame_opts.samp_freq = rate
    o.frame_opts.dither = 0.0
    return o


@pytest.mark.parametrize("rate,kw", [
    (8000.0, {}),
    (16000.0, {"lpc_order": 10, "cepstral_lifter": 0.0, "use_energy": False,
               "compress_factor": 0.5})])
def test_plp_matches_jax(rate, kw):
    """Four yesno waves (two at 16 kHz, resampled by the port's
    resampler), cut to one length: the JAX function compiles once a
    length."""
    corpus = tsyn.make_corpus(tsyn.yesno_lexicon(), {"yes": 0.5, "no": 0.5},
                              4, 1, 3, seed=5)
    n = min(len(w) for w in corpus.waves.values())
    opts, jopts = _plp_opts(tplp, rate, **kw), _plp_opts(jplp, rate, **kw)
    lim = PLP_REL * (lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)
                     if opts.cepstral_lifter else np.ones(opts.num_ceps)
                     ).astype(np.float64)
    if opts.use_energy:
        lim[0] = PLP_ENERGY_ATOL
    utts = sorted(corpus.waves)[:4 if rate == corpus.sample_rate else 2]
    for utt in utts:
        wave = corpus.waves[utt][:n]
        if rate != corpus.sample_rate:
            wave = tres.resample_waveform(wave, corpus.sample_rate, rate)
        got = tplp.compute_plp(torch.as_tensor(wave), opts, device="cpu")
        want = jplp.compute_plp(wave, jopts)
        assert got.shape == want.shape and got.dtype == np.float32
        err = np.abs(got.astype(np.float64) - want).max(axis=0)
        assert (err <= lim).all(), (utt, err / lim)


def test_plp_dither_from_generator():
    """Dither noise comes from the given CPU generator: the same seed
    gives the same features, another seed others."""
    wave = np.random.default_rng(5).normal(size=4000).astype(np.float32)
    opts = tplp.PlpOptions()
    opts.frame_opts.samp_freq = 8000.0

    def run(seed):
        return tplp.compute_plp(wave, opts, torch.Generator().manual_seed(
            seed), device="cpu")
    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


# -------------------------------------------------------------- jobs

def _job(job):
    print(f"hello from {job}")
    return job * job


def _masked_log(path):
    """A job log with its clock times blanked."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"# Started at .*", "# Started at T", text)
    text = re.sub(r"time=[0-9.]+s", "time=Ss", text)
    return re.sub(r"\) at .*", ") at T", text)


def test_serial_launcher_logs_equal(tmp_path):
    def boom(job):
        print(f"job {job}")
        if job == 2:
            raise ValueError("boom")
        return job

    for name, fn in (("sq", _job), ("boom", boom)):
        outs = []
        for pkg, jobs in (("jax", jjobs), ("port", tjobs)):
            d = tmp_path / pkg
            try:
                outs.append(jobs.SerialLauncher().run(name, 3, fn,
                                                      log_dir=str(d)))
            except jobs.JobFailure as e:
                outs.append((e.failed, e.total,
                             str(e).replace(str(d), "D")))
        assert outs[0] == outs[1]
        for j in range(1, 4):
            got = _masked_log(tmp_path / "port" / f"{name}.{j}.log")
            want = _masked_log(tmp_path / "jax" / f"{name}.{j}.log")
            # the traceback names each package's own file
            assert got == want.replace(os.sep + "kaldi_cnn_tpu" + os.sep,
                                       os.sep + "kaldi_cnn_tpu_torch" + os.sep)
    assert outs[0] == ([2], 3, "boom: 1 / 3 jobs failed (jobs [2]); "
                       "see D/boom.*.log")


@pytest.mark.parametrize("max_jobs", [None, 2])
def test_local_launcher(tmp_path, max_jobs):
    res = tjobs.LocalLauncher(max_jobs).run("sq", 4, _job,
                                            log_dir=str(tmp_path))
    assert res == jjobs.LocalLauncher(max_jobs).run("sq", 4, _job) == {
        1: 1, 2: 4, 3: 9, 4: 16}
    for j in range(1, 5):
        text = (tmp_path / f"sq.{j}.log").read_text()
        assert f"hello from {j}" in text and "# Ended (code 0)" in text


def test_shell_array_and_splits(tmp_path):
    tjobs.run_shell_array(f"echo shard JOB > {tmp_path}/out.JOB", 3, "sh",
                          str(tmp_path / "log"))
    for j in range(1, 4):
        assert (tmp_path / f"out.{j}").read_text().strip() == f"shard {j}"
    with pytest.raises(tjobs.JobFailure) as ei:
        tjobs.run_shell_array("test JOB -ne 2", 3, "t", str(tmp_path))
    assert ei.value.failed == [2]
    for items, n in ((list(range(7)), 3), ([1], 3), ([], 2),
                     (list(range(10)), 4)):
        assert tjobs.split_even(items, n) == jjobs.split_even(items, n)
    scp = {f"utt{i:02d}": i for i in range(10)}
    for n in (1, 3, 4, 12):
        assert tjobs.split_scp(scp, n) == jjobs.split_scp(scp, n)


# -------------------------------------------------------------- profiling

def test_profiling_equal(tmp_path):
    for prof in (jprof, tprof):
        with prof.accu_profile("unit_stage"):
            time.sleep(0.002)
        with prof.accu_profile("unit_stage"):
            pass
    got, want = tprof.print_profile(reset=True), jprof.print_profile(
        reset=True)
    assert got["unit_stage"]["calls"] == want["unit_stage"]["calls"] == 2
    assert got["unit_stage"]["total_s"] >= 0.002
    assert sorted(got["unit_stage"]) == sorted(want["unit_stage"])
    assert tprof.print_profile() == {}
    timers = (tprof.StepTimer(512), jprof.StepTimer(512))
    for st in timers:
        st._times = [0.5, 0.01, 0.02, 0.015]
    assert timers[0].summary() == timers[1].summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with tprof.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = d.glob("*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
