"""The port's ``online2-wav-latgen`` verb against the JAX package's, on the
CPU (``--device=cpu``), on the same files (``tests/test_cli_pipeline.py``'s
streaming test at a smaller size): a mono GMM trained by the JAX
package's verbs, both decode paths (the host incremental Viterbi and the
streaming top-K search), equal hyp files, and the port's lattice one-bests
equal to its hyps.  And a CNN ``.mdl`` through the port's verb: its
spliced rows reach the Conv2D laid out (t, f, c), so its hyps equal the
offline decode of correctly laid-out volumes."""

import os

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu import cli as jcli
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.datadir import write_data_dir, write_lexicon_file
from kaldi_cnn_tpu_torch import cli, cli_train
from kaldi_cnn_tpu_torch.cli_train import _load_am
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import load_lattices, shortest_path
from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.io.kaldi_model import read_gmm_model, write_am_nnet
from kaldi_cnn_tpu_torch.lang.fst import Fst
from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable
from kaldi_cnn_tpu_torch.models.components import AffineComponent
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.online2 import OnlineCmvn, OnlineFeaturePipeline
from kaldi_cnn_tpu_torch.recipes.wsj import splice_volume

NUM_BINS = 23             # the verb's default mel bins
COST_ABS = 1e-2           # streamed vs offline best-path cost


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A yesno corpus on disk (its test half as a data dir), a lang dir,
    a JAX mono GMM on MFCC + deltas (the yesno recipe's features) as a
    .mdl and the unigram HCLG from the JAX package's ``mkgraph`` verb."""
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    from kaldi_cnn_tpu.io.kaldi_model import write_gmm_model as j_write_gmm
    from kaldi_cnn_tpu.lang.hclg import Lang
    from kaldi_cnn_tpu.recipes.yesno import compute_features
    d = str(tmp_path_factory.mktemp("cli"))

    def p(name):
        return os.path.join(d, name)

    lex = jsyn.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = jsyn.make_corpus(lex, wp, 12, 1, 3, seed=29)
    train, test = corpus.split(0.25)
    write_data_dir(p("test"), test.waves, test.transcripts, None,
                   corpus.sample_rate)
    write_lexicon_file(p("lexicon.txt"), lex)
    with open(p("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(wp))
    lang = Lang.create(lex)
    am, _ = train_mono(compute_features(train, seed=29), train.transcripts,
                       lang, MonoTrainOptions(num_iters=8, totgauss=60))
    j_write_gmm(p("mono.mdl"), lang.trans_model, am)
    for argv in (["prepare-lang", p("lexicon.txt"), p("lang")],
                 ["mkgraph", p("lang"), p("unigram.arpa"), p("HCLG.txt")]):
        assert jcli.main(argv) == 0
    return p, test


def _verb(main, p, mdl, tag, extra):
    argv = ["online2-wav-latgen", "--beam=200", "--max-active=0",
            "--acoustic-scale=1.0", f"--lang-dir={p('lang')}",
            "--no-online-cmvn",           # the GMM trained on raw MFCC
            f"--lattice-wspecifier={p('lats_' + tag + '.npz')}", *extra,
            p(mdl), p("HCLG.txt"), os.path.join(p("test"), "wav.scp"),
            p(f"hyp_{tag}.txt")]
    assert main(argv) == 0
    with open(p(f"hyp_{tag}.txt")) as f:
        return f.read()


@pytest.fixture(scope="module")
def streamed(workdir):
    """The port's verb on the streaming path at the verb's 0.2 s chunks
    on the CPU, run once for the two tests that read it: its hypotheses
    (lattices in ``lats_port_streaming.npz``) and each utterance's
    advance sizes, keyed by its recorder."""
    p, _ = workdir
    sizes = {}
    advance = cli_train.AdvanceRecorder.advance

    def counted(self, ll):      # keyed by the recorder: one an utterance
        sizes.setdefault(self, []).append(len(ll))
        advance(self, ll)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train.AdvanceRecorder, "advance", counted)
        hyps = _verb(cli.main, p, "mono.mdl", "port_streaming",
                     ["--device=cpu"])
    return hyps, sizes


@pytest.mark.parametrize("path", ["host", "streaming"])
def test_online2_wav_latgen_matches_jax(workdir, request, path):
    """The streaming path at the verb's 0.2 s chunks; the host path at
    1 s chunks, since the JAX package's eager MFCC costs ~0.1 s a chunk
    on the CPU."""
    p, test = workdir
    extra = (["--host-decode", "--chunk-seconds=1.0"] if path == "host"
             else [])
    want = _verb(jcli.main, p, "mono.mdl", f"jax_{path}", extra)
    got = (request.getfixturevalue("streamed")[0] if path == "streaming"
           else _verb(cli.main, p, "mono.mdl", f"port_{path}",
                      extra + ["--device=cpu"]))
    assert got == want
    hyps = dict((ln.split(None, 1) + [""])[:2] for ln in got.splitlines())
    assert sorted(hyps) == sorted(test.waves)
    assert sum(len(h.split()) for h in hyps.values()) > 0
    words = SymbolTable.read(p("lang") + "/words.txt")
    lats = load_lattices(p(f"lats_port_{path}.npz"))
    assert set(lats) == set(hyps)
    for utt, lat in lats.items():
        _, wids, _ = shortest_path(lat, 1.0, 1.0)
        assert " ".join(words.sym(int(w)) for w in wids) == hyps[utt].strip()


@pytest.mark.parametrize("path,seconds", [("host", 0.2), ("streaming", 0.2),
                                          ("streaming", 0.5)])
def test_verb_advances_the_decoder_once_a_chunk(workdir, monkeypatch,
                                                 request, path, seconds):
    """The recognizer's pieces are the chunk's frame count: every chunk
    reaches the decoder as one advance of its 20 (50) frames, and the
    last advance an utterance takes what is left.  The streaming path
    at 0.2 s (the verb's default) is the run ``streamed`` keeps."""
    p, test = workdir
    if (path, seconds) == ("streaming", 0.2):
        sizes = request.getfixturevalue("streamed")[1]
    else:
        sizes = {}
        advance = cli_train.AdvanceRecorder.advance

        def counted(self, ll):  # keyed by the recorder: one an utterance
            sizes.setdefault(self, []).append(len(ll))
            advance(self, ll)
        monkeypatch.setattr(cli_train.AdvanceRecorder, "advance", counted)
        extra = [f"--chunk-seconds={seconds}", "--device=cpu"]
        _verb(cli.main, p, "mono.mdl", f"pieces_{path}_{seconds}",
              extra + (["--host-decode"] if path == "host" else []))
    step = int(seconds * 100)
    assert len(sizes) == len(test.waves)
    fo = F.FrameExtractionOptions(samp_freq=float(test.sample_rate))
    frames = sorted(F.num_frames(len(w), fo) for w in test.waves.values())
    assert sorted(sum(n) for n in sizes.values()) == frames
    for n in sizes.values():
        assert set(n[:-1]) <= {step} and 0 < n[-1] <= step


def test_verb_without_a_card_raises(workdir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA GPU")
    p, _ = workdir
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|cuda|NVIDIA"):
        _verb(cli.main, p, "mono.mdl", "nocard", [])


# each verb that computes on tensors, with file arguments it never opens:
# without a card it raises before it reads anything
CARD_VERBS = {
    "compute-mfcc-feats": ["wav.scp", "mfcc.ark"],
    "compute-fbank-feats": ["wav.scp", "fbank.ark"],
    "apply-cmvn": ["feats.ark", "cmvn.ark"],
    "add-deltas": ["feats.ark", "deltas.ark"],
    "apply-cmvn-stats": ["stats.ark", "feats.ark", "out.ark"],
    "nnet-am-info": ["am.mdl"],
    "nnet-am-copy": ["am.mdl", "copy.mdl"],
    "nnet-am-average": ["a.mdl", "b.mdl", "avg.mdl"],
    "nnet-train": ["mono.mdl", "egs.npz", "am.mdl"],
    "latgen-faster": ["--lang-dir=lang", "am.mdl", "HCLG.txt", "feats.scp",
                      "lats.npz", "hyp.txt"]}


@pytest.mark.parametrize("verb", sorted(CARD_VERBS))
def test_card_verbs_without_a_card_raise(verb, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA GPU")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|cuda|NVIDIA"):
        cli.main([verb, *CARD_VERBS[verb]])
    assert os.listdir(tmp_path) == []


def test_unknown_verb_and_help(capsys):
    assert cli.main(["no-such-verb"]) == 2
    assert cli.main([]) == 0
    assert "online2-wav-latgen" in capsys.readouterr().out


@pytest.mark.parametrize("recipe", ["yesno", "rm", "wsj", "swbd",
                                    "librispeech"])
def test_run_recipe_dispatches_with_the_device(recipe, monkeypatch, capsys):
    """run-recipe calls the recipe's ``run`` with --device, the card by
    default (each ``run`` here a stand-in that records its arguments)."""
    import importlib
    mod = importlib.import_module(f"kaldi_cnn_tpu_torch.recipes.{recipe}")
    calls = []
    monkeypatch.setattr(mod, "run",
                        lambda **kw: calls.append(kw) or {"wer": 0.0})
    assert cli.main(["run-recipe", recipe, "--device", "cpu"]) == 0
    assert cli.main(["run-recipe", recipe]) == 0
    assert calls == [{"device": "cpu"}, {"device": "cuda"}]
    assert "'wer': 0.0" in capsys.readouterr().out


def test_run_recipe_refuses_an_unknown_recipe():
    with pytest.raises(SystemExit):
        cli.main(["run-recipe", "timit"])


@pytest.fixture(scope="module")
def cnn_mdl(workdir):
    """A 23-bin CNN .mdl on the mono GMM's transition model, seeded
    random weights (the output affine drawn at random, so that the
    posteriors vary from frame to frame)."""
    p, _ = workdir
    tm, _ = read_gmm_model(p("mono.mdl"))
    cfg = ConvnetConfig(in_t=11, in_f=NUM_BINS, in_c=3, filt_t=4, filt_f=6,
                        num_filters=8, pool_t=2, pool_f=3, pool_c=1,
                        num_hidden_layers=1, pnorm_input_dim=40,
                        pnorm_output_dim=8, num_pdfs=tm.num_pdfs)
    net = make_convnet(cfg, device="cpu")
    gen = torch_generator(5, "cli_cnn")
    net.init(gen)
    out = [c for c in net.components if isinstance(c, AffineComponent)][-1]
    with torch.no_grad():
        out.w.copy_(3.0 * torch.randn(out.w.shape, generator=gen)
                    / out.input_dim ** 0.5)
    write_am_nnet(p("cnn.mdl"), tm, net)
    return p("cnn.mdl")


def _offline_volumes(wave, rate):
    """The verb's features finished in one call, as (t, f, c) volumes."""
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(rate)
    opts.mel_opts.num_bins = NUM_BINS
    cmvn = OnlineCmvn()
    cmvn.freeze(np.zeros(NUM_BINS, np.float32))
    pipe = OnlineFeaturePipeline("fbank", opts, cmvn=cmvn, device="cpu")
    pipe.accept_waveform(wave)
    pipe.finish()
    f = pipe.get_frames(0, pipe.num_frames_ready())
    return f.reshape(len(f), 3, NUM_BINS).transpose(0, 2, 1)


def test_cnn_rows_reach_the_conv_laid_out_t_f_c(workdir, cnn_mdl):
    """The verb's scorer on the pipeline's spliced (t, c, f) rows equals
    the model on wsj.splice_volume's (t, f, c) rows of the same volumes;
    on the rows as they come (the JAX verb's way) it does not."""
    p, test = workdir
    tm, scorer, dim = _load_am(cnn_mdl, "cpu")
    from kaldi_cnn_tpu_torch.io.kaldi_model import read_am_nnet
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    _, nnet, _, priors = read_am_nnet(cnn_mdl, "cpu")
    am = AmNnet(nnet, tm.num_pdfs)
    am.priors = np.asarray(priors, np.float64)
    utt = sorted(test.waves)[0]
    vol = _offline_volumes(test.waves[utt], test.sample_rate)
    T = len(vol)
    rows_tcf = splice_volume(vol.transpose(0, 2, 1).reshape(T, -1), 5, 5)
    want = am.loglikes(splice_volume(vol, 5, 5))
    assert dim == rows_tcf.shape[1] == 11 * NUM_BINS * 3
    np.testing.assert_allclose(scorer(rows_tcf), want, rtol=0, atol=1e-5)
    assert np.abs(am.loglikes(rows_tcf) - want).max() > 1e-2


def test_cnn_verb_matches_offline_decode(workdir, cnn_mdl):
    """The 23-bin CNN .mdl through the port's verb on the CPU (fbank,
    streaming search): its hyps equal TopKDecoder.decode_batch on the
    offline loglikes of correctly laid-out volumes."""
    p, test = workdir
    got = _verb(cli.main, p, "cnn.mdl", "cnn",
                ["--feature-type=fbank", "--device=cpu",
                 "--acoustic-scale=0.1"])
    tm, scorer, _ = _load_am(cnn_mdl, "cpu")
    graph = CompiledGraph(Fst.read_text(open(p("HCLG.txt"))),
                          tm.trans_id_to_pdf_array())
    from kaldi_cnn_tpu_torch.io.kaldi_model import read_am_nnet
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    _, nnet, _, priors = read_am_nnet(cnn_mdl, "cpu")
    am = AmNnet(nnet, tm.num_pdfs)
    am.priors = np.asarray(priors, np.float64)
    utts = sorted(test.waves)
    lls = [am.loglikes(splice_volume(_offline_volumes(
        test.waves[u], test.sample_rate), 5, 5)) for u in utts]
    dec = TopKDecoder(graph, beam=200.0, max_active=graph.num_states,
                      acoustic_scale=0.1, device="cpu")
    words = SymbolTable.read(p("lang") + "/words.txt")
    want = "".join(
        f"{u} {' '.join(words.sym(int(w)) for w in wids)}".rstrip() + "\n"
        for u, (_, wids, _) in zip(utts, dec.decode_batch(lls)))
    assert got == want
    assert any(len(ln.split()) > 1 for ln in got.splitlines())
