"""The port's feature, CMVN, scoring and model verbs against the JAX
package's on the CPU (``--device=cpu``), on the same files made from a
numpy seed: fbank and MFCC at dither 0 (fbank 1e-3, MFCC
``test_torch_gmm.mfcc_limits``), CMVN, deltas and splicing (1e-5),
``compute-wer`` stdout, ``compute-cmvn-stats`` (f64, 1e-9), ``gmm-info``,
``nnet-am-info``, ``ali-to-pdf`` and ``arpa2fst`` output equal, and the
``.mdl`` files of ``nnet-am-copy`` / ``nnet-am-average`` read back equal
by both packages' readers.  Also the feature verbs' dither stages, the
CMVN twins of ``features/functional.py``, the verbatim verbs by source
text, and the verb table."""

import inspect
import os

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu import cli as jcli
from kaldi_cnn_tpu import cli_train as jcli_train
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.io import kaldi_model as jmodel
from kaldi_cnn_tpu.io.kaldi_io import write_ark
from kaldi_cnn_tpu.io.wave import write_wave
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu_torch import cli, cli_train
from kaldi_cnn_tpu_torch.features import functional as TF
from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
from kaldi_cnn_tpu_torch.io import kaldi_model as tmodel
from kaldi_cnn_tpu_torch.io.kaldi_io import read_ark, read_mat_ark
from kaldi_cnn_tpu_torch.io.wave import read_wave
from test_torch_gmm import mfcc_limits

FBANK_ATOL = 1e-3         # log-mel, port vs JAX
XFORM_ATOL = 1e-5         # CMVN, deltas, splice
STATS_ATOL = 1e-9         # f64 CMVN stats


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four synthetic yesno waves at 8 kHz (a wav.scp), two feature arks
    of seeded normal rows, speaker maps, and a small CNN .mdl pair."""
    d = str(tmp_path_factory.mktemp("verbs"))

    def p(name):
        return os.path.join(d, name)

    corpus = jsyn.make_corpus(jsyn.yesno_lexicon(), {"yes": 0.5, "no": 0.5},
                              4, 1, 2, seed=5)
    with open(p("wav.scp"), "w") as f:
        for utt in sorted(corpus.waves):
            write_wave(p(f"{utt}.wav"), corpus.waves[utt],
                       corpus.sample_rate)
            f.write(f"{utt} {p(utt + '.wav')}\n")
    rng = np.random.default_rng(41)
    feats = {"u1": rng.normal(1.5, 2.0, (30, 13)).astype(np.float32),
             "u2": rng.normal(-1.0, 0.5, (21, 13)).astype(np.float32),
             "u3": rng.normal(0.3, 1.0, (3, 13)).astype(np.float32)}
    write_ark(p("feats.ark"), feats)
    with open(p("spk2utt"), "w") as f:
        f.write("spkA u1 u2\nspkB u3\n")
    with open(p("utt2spk"), "w") as f:
        f.write("u1 spkA\nu2 spkA\nu3 spkB\n")
    _write_cnn_mdls(p)
    return p, feats, corpus


def _write_cnn_mdls(p):
    """a.mdl and b.mdl: one small JAX CNN at two inits, and its GMM twin
    g.mdl on the same transition model."""
    import jax
    from kaldi_cnn_tpu.gmm.am_gmm import AmDiagGmm
    from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm
    from kaldi_cnn_tpu.lang.topology import HmmTopology
    from kaldi_cnn_tpu.lang.transition_model import (
        MonophoneContextDependency, TransitionModel)
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    net = make_convnet(ConvnetConfig(
        in_t=6, in_f=12, in_c=2, filt_t=3, filt_f=5, num_filters=8,
        pool_t=2, pool_f=2, pool_c=1, num_hidden_layers=1,
        pnorm_input_dim=32, pnorm_output_dim=8, num_pdfs=9))
    topo = HmmTopology([1, 2, 3])
    tm = TransitionModel(topo, MonophoneContextDependency(topo))
    priors = np.random.default_rng(3).dirichlet(np.ones(9))
    for name, seed in (("a", 0), ("b", 1)):
        jmodel.write_am_nnet(p(f"{name}.mdl"), tm, net,
                             net.init(jax.random.PRNGKey(seed)), priors)
    rng = np.random.default_rng(0)
    gmms = [DiagGmm(np.ones(2) / 2, rng.normal(size=(2, 4)),
                    np.ones((2, 4))) for _ in range(tm.num_pdfs)]
    jmodel.write_gmm_model(p("g.mdl"), tm, AmDiagGmm(gmms))


def _both(argv, p, tag, capsys=None):
    """Runs ``argv`` (a verb and its arguments; "OUT" names the output)
    through the JAX verb and the port's (with ``--device=cpu`` where the
    verb takes it); returns the two outputs' paths (and stdouts)."""
    outs, said = [], []
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        out = p(f"{tag}_{pkg}")
        args = [out if a == "OUT" else a for a in argv]
        if pkg == "port" and argv[0] in DEVICE_VERBS:
            args.insert(1, "--device=cpu")
        assert main(args) == 0
        outs.append(out)
        if capsys is not None:
            said.append(capsys.readouterr().out)
    return (outs, said) if capsys is not None else outs


# the verbs of this file that compute on tensors: --device, the card by
# default
DEVICE_VERBS = ("compute-mfcc-feats", "compute-fbank-feats", "apply-cmvn",
                "add-deltas", "apply-cmvn-stats", "nnet-am-info",
                "nnet-am-copy", "nnet-am-average")


# ---- features -----------------------------------------------------------

@pytest.mark.parametrize("kind,bins", [("fbank", 23), ("fbank", 36),
                                       ("mfcc", 23)])
def test_compute_feats_matches_jax(files, kind, bins):
    p, _, corpus = files
    jout, tout = _both([f"compute-{kind}-feats", "--dither=0",
                        f"--num-mel-bins={bins}", p("wav.scp"), "OUT"],
                       p, f"{kind}{bins}")
    want, got = dict(read_mat_ark(jout)), dict(read_mat_ark(tout))
    assert sorted(got) == sorted(want) == sorted(corpus.waves)
    lim = mfcc_limits() if kind == "mfcc" else FBANK_ATOL
    for u in want:
        assert got[u].shape == want[u].shape
        assert got[u].shape[1] == (13 if kind == "mfcc" else bins)
        assert (np.abs(got[u] - want[u]) <= lim).all(), u


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_compute_feats_dithers_as_the_extractor(files, kind):
    """At dither 1, utterance n draws from stage ("<kind>_dither", n) of
    --seed: the features equal ``FeatureExtractor.extract_corpus``'s
    (ROADMAP 3.1: the JAX verb draws ``PRNGKey(seed + n)``)."""
    p, _, corpus = files
    out = p(f"dither_{kind}")
    assert cli.main([f"compute-{kind}-feats", "--device=cpu", "--seed=9",
                     p("wav.scp"), out]) == 0
    opts = TF.MfccOptions() if kind == "mfcc" else TF.FbankOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    waves = {u: read_wave(p(f"{u}.wav"))[0][0] for u in corpus.waves}
    want = FeatureExtractor(opts, device="cpu").extract_corpus(waves, 9)
    got = dict(read_mat_ark(out))
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
    undithered = FeatureExtractor(opts, device="cpu")(waves[u])
    assert not np.array_equal(got[u], undithered)


@pytest.mark.parametrize("argv", [
    ["apply-cmvn"], ["apply-cmvn", "--norm-vars"], ["add-deltas"],
    ["add-deltas", "--delta-order=1"], ["splice-feats"],
    ["splice-feats", "--left-context=2", "--right-context=5"],
    ["copy-feats"]], ids=lambda a: "_".join(a))
def test_transform_verbs_match_jax(files, argv):
    p, feats, _ = files
    tag = "_".join(a.strip("-").replace("=", "") for a in argv)
    jout, tout = _both(argv + [p("feats.ark"), "OUT"], p, tag)
    want, got = dict(read_mat_ark(jout)), dict(read_mat_ark(tout))
    assert sorted(got) == sorted(want) == sorted(feats)
    for u in want:
        assert got[u].dtype == want[u].dtype == np.float32
        np.testing.assert_allclose(got[u], want[u], rtol=0,
                                   atol=XFORM_ATOL)
    if argv == ["copy-feats"]:
        for u in feats:
            np.testing.assert_array_equal(got[u], feats[u])


@pytest.mark.parametrize("spk", [False, True])
def test_cmvn_stats_verbs_match_jax(files, spk):
    p, feats, _ = files
    extra = [f"--spk2utt={p('spk2utt')}"] if spk else []
    jout, tout = _both(["compute-cmvn-stats", *extra, p("feats.ark"),
                        "OUT"], p, f"stats{spk}")
    want, got = dict(read_ark(jout)), dict(read_ark(tout))
    assert sorted(got) == sorted(want) == (["spkA", "spkB"] if spk
                                           else sorted(feats))
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float64
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STATS_ATOL)
    extra = [f"--utt2spk={p('utt2spk')}"] if spk else []
    jn, tn = _both(["apply-cmvn-stats", *extra, "--norm-vars", jout,
                    p("feats.ark"), "OUT"], p, f"norm{spk}")
    want, got = dict(read_mat_ark(jn)), dict(read_mat_ark(tn))
    for u in feats:
        np.testing.assert_allclose(got[u], want[u], rtol=0, atol=XFORM_ATOL)


def test_compute_wer_stdout_equal(tmp_path, capsys):
    (tmp_path / "ref.txt").write_text("u1 yes no yes\nu2 no\nu3 yes yes\n")
    (tmp_path / "hyp.txt").write_text("u1 yes yes\nu2 no no\nu3\n")

    def p(name):
        return str(tmp_path / name)
    _, (want, got) = _both(["compute-wer", p("ref.txt"), p("hyp.txt")], p,
                           "wer", capsys)
    assert got == want and want.startswith("%WER 66.67")


# ---- models ---------------------------------------------------------------

@pytest.mark.parametrize("verb,mdl,line", [
    ("gmm-info", "g.mdl", "number of pdfs 9"),
    ("nnet-am-info", "a.mdl", "num-pdfs 9")])
def test_info_verbs_stdout_equal(files, capsys, verb, mdl, line):
    p, _, _ = files
    _, (want, got) = _both([verb, p(mdl)], p, verb, capsys)
    assert got == want and line in want.splitlines()


@pytest.mark.parametrize("mdl", ["g.mdl", "a.mdl"])
def test_ali_to_pdf_matches_jax(files, mdl):
    p, _, _ = files
    write_ark(p("ali.ark"), {"u1": np.asarray([1, 1, 2, 3, 5], np.int32),
                             "u2": np.asarray([4, 4, 6], np.int32)})
    jout, tout = _both(["ali-to-pdf", p(mdl), p("ali.ark"), "OUT"], p,
                       f"pdf_{mdl}")
    want, got = dict(read_ark(jout)), dict(read_ark(tout))
    assert sorted(got) == sorted(want) == ["u1", "u2"]
    for u in want:
        assert got[u].dtype == want[u].dtype
        np.testing.assert_array_equal(got[u], want[u])


def test_arpa2fst_output_equal(files):
    p, _, _ = files
    with open(p("lm.arpa"), "w") as f:
        f.write(make_unigram_arpa({"yes": 0.3, "no": 0.5, "maybe": 0.2}))
    with open(p("words.txt"), "w") as f:
        f.write("<eps> 0\nyes 1\nno 2\nmaybe 3\n")
    jout, tout = _both(["arpa2fst", p("lm.arpa"), p("words.txt"), "OUT"], p,
                       "G")
    with open(jout) as a, open(tout) as b:
        assert b.read() == a.read()


def _read_both(path):
    """(JAX reader's, port reader's) parameters and priors of a .mdl."""
    _, _, jp, jpr = jmodel.read_am_nnet(path)
    _, _, tp, tpr = tmodel.read_am_nnet(path, device="cpu")
    return (jp, jpr), (tp, tpr)


@pytest.mark.parametrize("verb", ["nnet-am-copy", "nnet-am-average"])
def test_nnet_am_copy_and_average_read_back_equal(files, verb):
    p, _, _ = files
    ins = [p("a.mdl")] + ([p("b.mdl")] if verb == "nnet-am-average" else [])
    jout, tout = _both([verb, *ins, "OUT"], p, verb)
    (jp, jpr), (tp, tpr) = _read_both(tout)
    (wp, wpr), _ = _read_both(jout)
    for pr in (jpr, tpr):
        np.testing.assert_array_equal(pr, wpr)
    for got in (jp, tp):
        assert len(got) == len(wp)
        for a, b in zip(got, wp):
            assert sorted(a or {}) == sorted(b or {})
            for k in a or {}:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
    if verb == "nnet-am-average":
        (ap, _), _ = _read_both(p("a.mdl"))
        (bp, _), _ = _read_both(p("b.mdl"))
        w = np.asarray(wp[-2]["w"])
        np.testing.assert_allclose(
            w, (np.asarray(ap[-2]["w"]) + np.asarray(bp[-2]["w"])) / 2,
            rtol=1e-6, atol=1e-7)
    else:
        with open(tout, "rb") as a, open(p("a.mdl"), "rb") as b:
            assert a.read() == b.read()


# ---- the CMVN twins ------------------------------------------------------

def test_cmvn_stats_twin_is_verbatim():
    assert inspect.getsource(TF.cmvn_stats) == inspect.getsource(
        JF.cmvn_stats)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_apply_cmvn_twins_match_jax(files, norm_vars):
    _, feats, _ = files
    for f in feats.values():
        t = torch.as_tensor(f)
        np.testing.assert_allclose(
            TF.apply_cmvn(t, norm_vars).numpy(),
            np.asarray(JF.apply_cmvn(f, norm_vars)), rtol=0,
            atol=XFORM_ATOL)
        stats = JF.cmvn_stats(f) + JF.cmvn_stats(f[:2])
        np.testing.assert_allclose(
            TF.apply_cmvn_stats(t, stats, norm_vars).numpy(),
            np.asarray(JF.apply_cmvn_stats(f, stats, norm_vars)), rtol=0,
            atol=XFORM_ATOL)


@pytest.mark.parametrize("window,center", [(600, True), (7, True),
                                           (8, True), (5, False),
                                           (600, False)])
def test_sliding_window_cmn_matches_jax(files, window, center):
    _, feats, _ = files
    for f in feats.values():
        np.testing.assert_allclose(
            TF.sliding_window_cmn(torch.as_tensor(f), window, center).numpy(),
            np.asarray(JF.sliding_window_cmn(f, window, center)), rtol=0,
            atol=XFORM_ATOL)


# ---- the twins by source text, the verb table ---------------------------

VERBATIM = {
    cli: ("cmd_compute_wer", "cmd_compute_cmvn_stats", "_load_word_table",
          "cmd_gmm_info", "cmd_arpa2fst"),
    cli_train: ("_load_lang", "_read_text", "write_fst_archive",
                "read_fst_archive", "cmd_prepare_lang",
                "cmd_compile_train_graphs", "cmd_gmm_train_mono",
                "cmd_gmm_align", "cmd_nnet_get_egs", "cmd_mkgraph")}


@pytest.mark.parametrize("mod,name", [(m, n) for m, ns in VERBATIM.items()
                                      for n in ns],
                         ids=lambda x: getattr(x, "__name__", x))
def test_verbs_are_verbatim(mod, name):
    """Each host verb is its JAX original with the imports mapped."""
    jmod = jcli if mod is cli else jcli_train
    assert inspect.getsource(getattr(mod, name)) == inspect.getsource(
        getattr(jmod, name)).replace("kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")


PORTED = ("compute-mfcc-feats", "compute-fbank-feats", "apply-cmvn",
          "add-deltas", "splice-feats", "copy-feats", "compute-wer",
          "compute-cmvn-stats", "apply-cmvn-stats", "nnet-am-info",
          "nnet-am-copy", "nnet-am-average", "gmm-info", "ali-to-pdf",
          "arpa2fst", "prepare-lang", "compile-train-graphs",
          "gmm-train-mono", "gmm-align", "nnet-get-egs", "nnet-train",
          "mkgraph", "latgen-faster")


def test_help_lists_the_ported_verbs(capsys):
    assert len(PORTED) == 23
    assert cli.main(["--help"]) == 0
    listed = capsys.readouterr().out.split("verbs:")[-1]
    listed = {v.strip() for v in listed.split(",")}
    lattice = {"lattice-best-path", "lattice-copy", "lattice-mbr-decode",
               "lattice-nbest", "lattice-prune", "lattice-push",
               "lattice-minimize", "lattice-determinize", "lattice-scale",
               "lattice-lmrescore", "lattice-to-post"}
    assert set(PORTED) | lattice | {"online2-wav-latgen", "run-recipe",
                                    "compute-kaldi-pitch-feats",
                                    "process-kaldi-pitch-feats"} == listed
    assert set(PORTED) <= set(jcli.VERBS)
    assert listed == set(jcli.VERBS)
