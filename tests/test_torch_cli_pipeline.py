"""A small shell-only yesno pipeline through both packages' verbs on the
CPU (``tests/test_cli_pipeline.py`` at a smaller size, not marked slow):
the features made once, then prepare-lang ->
gmm-train-mono -> compile-train-graphs -> gmm-align -> nnet-get-egs ->
nnet-train -> mkgraph in each package.  The lang files, graph archives,
HCLG text, mono ``.mdl``, alignments and egs are bit-equal; ``nnet-train``
at one epoch (the port's init replaced by the JAX init) is within the
limits ``test_torch_train.py`` holds ``train_nnet`` to; ``latgen-faster``
on the same ``.mdl`` gives the same words and one-best costs within rel
1e-4 / abs 5e-2 on the default and ``--host-decode`` paths."""

import os

import jax
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu import cli as jcli
from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.models import factory as jfactory
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.datadir import write_data_dir, write_lexicon_file
from kaldi_cnn_tpu_torch import cli
from kaldi_cnn_tpu_torch.convert import params_from_jax
from kaldi_cnn_tpu_torch.decode.lattice import load_lattices, shortest_path
from kaldi_cnn_tpu_torch.io.kaldi_io import read_ark
from kaldi_cnn_tpu_torch.io.kaldi_model import read_am_nnet, read_gmm_model
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.train.egs import Egs
from test_torch_lang import load_jax_native

SEED, CONTEXT, ACOUSTIC_SCALE = 23, 4, 0.1
DNN = dict(num_hidden_layers=1, pnorm_input_dim=200, pnorm_output_dim=40)
TRAIN = ["--num-epochs=1", "--minibatch-size=128",
         "--initial-learning-rate=0.04", "--final-learning-rate=0.004",
         "--num-hidden-layers=1", "--pnorm-input-dim=200",
         "--pnorm-output-dim=40"]
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4     # train_nnet, port vs JAX
COST_REL, COST_ABS = 1e-4, 5e-2         # one-best cost, port vs JAX


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(num_pdfs):
    """The JAX ``nnet-train``'s initial parameters (its ``train_nnet``
    draws them from stage "init" of the seed, 0 by default)."""
    net = jfactory.make_pnorm_dnn(jfactory.PnormDnnConfig(
        input_dim=39 * (2 * CONTEXT + 1), num_pdfs=num_pdfs, **DNN))
    return jax.device_get(net.init(jax.random.PRNGKey(
        int(stage_key(0, "init")[1]))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 16-utterance yesno corpus as two data dirs, its MFCC + deltas
    (and the test set spliced +-4) from the port's verbs (their parity
    is ``test_torch_cli_verbs.py``'s; the JAX verbs' eager MFCC compiles
    once an utterance length), then the pipeline
    in ``<d>/jax`` by the JAX verbs and in ``<d>/port`` by the port's on
    the CPU, the port's DNN started from the JAX init."""
    load_jax_native(tmp_path_factory)
    d = str(tmp_path_factory.mktemp("pipeline"))

    def p(*names):
        return os.path.join(d, *names)

    lex = jsyn.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = jsyn.make_corpus(lex, wp, 16, 1, 3, seed=SEED)
    train, test = corpus.split(0.25)
    for part, c in (("train", train), ("test", test)):
        write_data_dir(p(part), c.waves, c.transcripts, None,
                       corpus.sample_rate)
    write_lexicon_file(p("lexicon.txt"), lex)
    with open(p("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(wp))
    for part in ("train", "test"):
        for argv in (["compute-mfcc-feats", "--dither=0",
                      p(part, "wav.scp"), p(f"{part}_mfcc.ark")],
                     ["add-deltas", p(f"{part}_mfcc.ark"),
                      p(f"{part}_feats.ark"),
                      f"--out-scp={p(f'{part}_feats.scp')}"]):
            assert cli.main([argv[0], "--device=cpu", *argv[1:]]) == 0
    assert cli.main(["splice-feats", f"--left-context={CONTEXT}",
                     f"--right-context={CONTEXT}", p("test_feats.ark"),
                     p("test_spliced.ark"),
                     f"--out-scp={p('test_spliced.scp')}"]) == 0

    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        os.makedirs(p(pkg))

        def q(name):
            return p(pkg, name)
        dev = ["--device=cpu"] if pkg == "port" else []
        steps = [
            ["prepare-lang", p("lexicon.txt"), q("lang")],
            ["gmm-train-mono", "--num-iters=10", "--totgauss=100", q("lang"),
             p("train_feats.scp"), p("train", "text"), q("mono.mdl"),
             q("ali0.ark")],
            ["compile-train-graphs", q("lang"), p("train", "text"),
             q("graphs.txt")],
            ["gmm-align", "--beam=200", q("mono.mdl"), q("graphs.txt"),
             p("train_feats.scp"), q("ali.ark")],
            ["nnet-get-egs", f"--left-context={CONTEXT}",
             f"--right-context={CONTEXT}", q("mono.mdl"),
             p("train_feats.scp"), q("ali.ark"), q("egs.npz")],
            ["nnet-train", *TRAIN, *dev, q("mono.mdl"), q("egs.npz"),
             q("am.mdl")],
            ["mkgraph", q("lang"), p("unigram.arpa"), q("HCLG.txt")]]
        for argv in steps:
            with pytest.MonkeyPatch.context() as mp:
                if argv[0] == "nnet-train" and pkg == "port":
                    init = _jax_init(read_gmm_model(q("mono.mdl"))[0]
                                     .num_pdfs)
                    mp.setattr(Nnet, "init",
                               lambda self, gen: params_from_jax(self, init))
                assert main(argv) == 0, argv
    return p


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", [
    "lang/lexicon.txt", "lang/phones.txt", "lang/words.txt", "mono.mdl",
    "graphs.txt", "HCLG.txt"])
def test_pipeline_files_bit_equal(runs, name):
    got, want = _bytes(runs("port", name)), _bytes(runs("jax", name))
    assert len(want) > 0 and got == want


@pytest.mark.parametrize("name", ["ali0.ark", "ali.ark"])
def test_pipeline_alignments_bit_equal(runs, name):
    got, want = (dict(read_ark(runs(pkg, name))) for pkg in ("port", "jax"))
    assert sorted(got) == sorted(want) and len(want) == 12
    for u in want:
        assert got[u].dtype == want[u].dtype
        np.testing.assert_array_equal(got[u], want[u])


def test_pipeline_egs_bit_equal(runs):
    got, want = (Egs.load(runs(pkg, "egs.npz")) for pkg in ("port", "jax"))
    assert want.x.shape[1] == 39 * (2 * CONTEXT + 1)
    for k in ("x", "y", "weights"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_nnet_train_within_the_train_limits(runs):
    """One epoch from the same init: parameters within the limits of
    ``test_torch_train.test_train_nnet_matches_jax``, priors equal."""
    (_, _, got, gpr), (_, _, want, wpr) = (
        read_am_nnet(runs(pkg, "am.mdl"), device="cpu")
        for pkg in ("port", "jax"))
    np.testing.assert_array_equal(gpr, wpr)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a or {}) == sorted(b or {})
        for k in a or {}:
            np.testing.assert_allclose(a[k], b[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


@pytest.mark.parametrize("path", ["default", "host"])
def test_latgen_faster_matches_jax(runs, path):
    """Both packages' verbs decode the test set with the JAX package's
    DNN .mdl: the same words, one-best costs within rel 1e-4 / abs
    5e-2, and the port's hyps the best paths of its lattices."""
    lats, hyps = {}, {}
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        extra = (["--host-decode"] if path == "host" else []) + (
            ["--device=cpu"] if pkg == "port" else [])
        out = runs(pkg, f"lats_{path}.npz")
        text = runs(pkg, f"hyp_{path}.txt")
        assert main(["latgen-faster", "--beam=1e9", "--max-active=0",
                     "--batch-size=4",
                     f"--acoustic-scale={ACOUSTIC_SCALE}", *extra,
                     f"--lang-dir={runs('jax', 'lang')}",
                     runs("jax", "am.mdl"), runs("jax", "HCLG.txt"),
                     runs("test_spliced.scp"), out, text]) == 0
        lats[pkg] = load_lattices(out)
        with open(text) as f:
            hyps[pkg] = f.read()
    assert hyps["port"] == hyps["jax"]
    assert sorted(lats["port"]) == sorted(lats["jax"])
    assert len(lats["jax"]) == 4
    assert sum(len(ln.split()) - 1 for ln in hyps["jax"].splitlines()) > 0
    for u, want in lats["jax"].items():
        _, jw, jc = shortest_path(want, 1.0, ACOUSTIC_SCALE)
        _, tw, tc = shortest_path(lats["port"][u], 1.0, ACOUSTIC_SCALE)
        assert list(tw) == list(jw)
        assert tc == pytest.approx(jc, rel=COST_REL, abs=COST_ABS)
