"""The ported WSJ serving slice as a whole against the JAX path: waves ->
fbank volumes -> CNN loglikes -> top-K best path -> words, at dither 0;
the corpus twin; and the port's independence from jax (chip_smoke.py and
every port module import with jax blocked)."""

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.features.extractor import FeatureExtractor as JFE
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.wsj import splice_volume as j_splice
from kaldi_cnn_tpu_torch.convert import params_from_jax
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_BINS = 12
CFG = dict(in_t=11, in_f=NUM_BINS, in_c=3, filt_t=4, filt_f=5,
           num_filters=8, pool_t=2, pool_f=2, pool_c=1,
           num_hidden_layers=1, pnorm_input_dim=64, pnorm_output_dim=16)


def test_corpus_twin_is_bit_equal():
    lex, jlex = synthetic.digits_lexicon(), jsyn.digits_lexicon()
    assert lex.entries == jlex.entries and lex.phones == jlex.phones
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    a = synthetic.make_noisy_corpus(lex, wp, 4, 2, 5, seed=37)
    b = jsyn.make_noisy_corpus(jlex, wp, 4, 2, 5, seed=37)
    assert a.transcripts == b.transcripts and a.sample_rate == b.sample_rate
    assert list(a.waves) == list(b.waves)
    for u in a.waves:
        np.testing.assert_array_equal(a.waves[u], b.waves[u])
    ta, te = a.split(0.25)
    assert sorted(te.waves) == sorted(b.split(0.25)[1].waves)


@pytest.fixture(scope="module")
def slice_setup():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 3, 1, 3, seed=37)
    lang = Lang.create(lex)
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(wp))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    P = lang.trans_model.num_pdfs
    # the JAX path's volumes: Pallas fbank at dither 0, deltas over the
    # true frames (the JAX extractor's own deltas read its length-bucket
    # padding at the last frames; see test_torch_features)
    jo = JF.FbankOptions()
    jo.frame_opts.samp_freq = float(corpus.sample_rate)
    jo.frame_opts.dither = 0.0
    jo.mel_opts.num_bins = NUM_BINS
    jex = JFE("fbank", jo, device="cpu", use_pallas=True)
    jvol = {}
    for u, f in jex.extract_corpus(corpus.waves).items():
        d = np.asarray(JF.compute_deltas(jnp.asarray(f), 2, 2))
        jvol[u] = d.reshape(len(d), 3, NUM_BINS).transpose(0, 2, 1)
    return corpus, lang, fst, t2p, P, jvol


@pytest.mark.parametrize("fused", [False, True])
def test_slice_words_match_jax_path(slice_setup, fused):
    """Unfused: f32 throughout against JAX use_pallas=False.  Fused: the
    served configuration (conv+maxpool with bf16 operands) against JAX
    use_pallas=True (the Pallas kernel in interpret mode)."""
    corpus, lang, fst, t2p, P, jvol = slice_setup
    jnet = j_make_convnet(JCfg(num_pdfs=P, **CFG), use_pallas=fused)
    p = [dict(d) for d in jax.device_get(jnet.init(jax.random.PRNGKey(2)))]
    p[-2]["w"] = (np.random.default_rng(2).normal(size=p[-2]["w"].shape)
                  / np.sqrt(p[-2]["w"].shape[1])).astype(np.float32)
    jam = JAmNnet(jnet, P)
    jlls = jam.loglikes_batch(p, {u: j_splice(v, 5, 5)
                                  for u, v in jvol.items()}, batch_size=256)
    utts = sorted(jlls)
    jres = TpuTopKDecoder(JGraph(fst, t2p), beam=60.0, max_active=2000,
                          acoustic_scale=0.1).decode_batch(
                              [jlls[u] for u in utts])

    am = AmNnet(make_convnet(ConvnetConfig(num_pdfs=P, **CFG), fused=fused,
                             device="cpu"), P)
    params_from_jax(am, p, priors=jam.priors)
    vol = wsj.compute_fbank_volumes(corpus, NUM_BINS, device="cpu",
                                    dither=0.0)
    for u in utts:
        np.testing.assert_allclose(vol[u], jvol[u], rtol=0, atol=1e-3)
    res = wsj.decode(am, corpus, CompiledGraph(fst, t2p), lang.word_table,
                     volumes=vol)
    tol = 1e-3 if fused else 1e-4
    for u, (_, jw, jc) in zip(utts, jres):
        np.testing.assert_allclose(res["loglikes"][u], jlls[u], rtol=0,
                                   atol=tol)
        assert res["hyps"][u] == [lang.word_table.sym(int(w)) for w in jw]
        assert res["costs"][u] == pytest.approx(jc, rel=1e-5, abs=1e-2)
    assert res["words"] == sum(len(t) for t in corpus.transcripts.values())
    assert 0.0 <= res["wer"] and res["missing_utts"] == 0


def test_port_imports_without_jax():
    """chip_smoke.py and every kaldi_cnn_tpu_torch module import in a
    process where importing jax or the JAX package fails, and neither was
    loaded (kaldi_cnn_tpu_torch shares the JAX package's name as a prefix,
    so the names are compared exactly)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kaldi_cnn_tpu'] = None\n"
        "import chip_smoke, kaldi_cnn_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "def loaded(name):\n"
        "    return [m for m in sys.modules if (m == name or m.startswith("
        "name + '.')) and sys.modules[m] is not None]\n"
        "assert not loaded('jax'), loaded('jax')\n"
        "assert not loaded('kaldi_cnn_tpu'), loaded('kaldi_cnn_tpu')\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 93
    assert {f"kaldi_cnn_tpu_torch.{m}" for m in (
        "core.mesh", "parallel", "parallel.dp", "parallel.multihost",
        "parallel.rank_check", "recipes.librispeech",
        "train.sharded_egs", "gmm.ebw", "models.utils",
        "train.discriminative", "io.native_io", "io.compressed",
        "io.kaldi_lattice", "lang.const_arpa", "decode.biggraph",
        "features.plp", "features.resample", "core.jobs",
        "core.profiling")} <= mods


BANNED_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax\b|kaldi_cnn_tpu(?!_torch)\b)"
    r"|(?:import_module|__import__)\(\s*f?[\"'](?:jax\b|kaldi_cnn_tpu"
    r"(?!_torch)\b)")


def banned_imports(text):
    """The lines of ``text`` that import jax or the JAX package, at any
    depth (a verb body's lazy import included)."""
    return [ln for ln in text.splitlines() if BANNED_IMPORT.search(ln)]


def test_banned_imports_finds_lazy_imports():
    for ln in ("import jax", "    import jax.numpy as jnp",
               "from jax import lax", "        from kaldi_cnn_tpu.io import x",
               "import kaldi_cnn_tpu", "import kaldi_cnn_tpu.cli as c",
               "    m = importlib.import_module(f'kaldi_cnn_tpu.recipes.x')",
               "__import__('jax')"):
        assert banned_imports(ln) == [ln], ln
    for ln in ("import jaxtyping_like_name_is_not_jax_x",
               "from kaldi_cnn_tpu_torch.io import x",
               "import kaldi_cnn_tpu_torch",
               "importlib.import_module(f'kaldi_cnn_tpu_torch.recipes.x')",
               "# the JAX package (kaldi_cnn_tpu/cli.py:31) draws jax keys"):
        assert banned_imports(ln) == [], ln


def test_port_sources_import_no_jax():
    """A source scan of every port module and chip_smoke.py: no import of
    jax or the JAX package anywhere, inside function bodies too (which
    ``test_port_imports_without_jax`` cannot see)."""
    paths = sorted(glob.glob(os.path.join(ROOT, "kaldi_cnn_tpu_torch", "**",
                                          "*.py"), recursive=True))
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(paths) >= 94
    found = {}
    for path in paths:
        with open(path) as f:
            bad = banned_imports(f.read())
        if bad:
            found[os.path.relpath(path, ROOT)] = bad
    assert found == {}


def _tiny_graph():
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    lang = Lang.create(lex)
    return CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())


@pytest.mark.parametrize("entry", [
    "make_convnet", "FeatureExtractor", "TopKDecoder",
    "compute_fbank_volumes", "Conv2DComponent", "ng_init", "wsj.run",
    "compute_features", "mfcc FeatureExtractor", "make_pnorm_dnn",
    "OnlineBaseFeature", "OnlineRecognizer", "StreamingDecoder",
    "swbd.run", "make_convnet_ivector", "librispeech.run",
    "compute-fbank-feats verb", "add-deltas verb", "nnet-train verb",
    "latgen-faster verb", "compute_plp", "DenseViterbiDecoder"])
def test_entry_points_default_to_the_card(entry):
    """Left without ``device``, the port's entry points run on the card;
    where there is none they raise, at construction or at the first call,
    and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA GPU")
    from kaldi_cnn_tpu_torch.features import functional as TF
    from kaldi_cnn_tpu_torch.features.extractor import FeatureExtractor
    from kaldi_cnn_tpu_torch.decode.topk_decoder import TopKDecoder
    from kaldi_cnn_tpu_torch.models.components import Conv2DComponent
    from kaldi_cnn_tpu_torch.models.factory import (make_convnet_ivector,
                                                    make_pnorm_dnn)
    from kaldi_cnn_tpu_torch.recipes import librispeech, swbd
    from kaldi_cnn_tpu_torch.models.ng_sgd import OnlineNaturalGradient
    from kaldi_cnn_tpu_torch.decode.topk_decoder import StreamingDecoder
    from kaldi_cnn_tpu_torch.online2 import (OnlineBaseFeature,
                                             OnlineRecognizer)
    from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
    from kaldi_cnn_tpu_torch.features.plp import compute_plp
    from kaldi_cnn_tpu_torch.decode.tpu_decoder import DenseViterbiDecoder
    from kaldi_cnn_tpu_torch import cli
    wave = np.zeros(800, np.float32)
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    calls = {
        "make_convnet": lambda: make_convnet(ConvnetConfig(**CFG)),
        "FeatureExtractor": lambda: FeatureExtractor(TF.FbankOptions())(
            wave),
        "TopKDecoder": lambda: TopKDecoder(_tiny_graph()).decode_batch(
            [np.zeros((3, 60), np.float32)]),
        "compute_fbank_volumes": lambda: wsj.compute_fbank_volumes(
            synthetic.make_noisy_corpus(lex, wp, 1, 1, 1, seed=1), NUM_BINS),
        "Conv2DComponent": lambda: Conv2DComponent(6, 10, 1, 2, 3, 8),
        "ng_init": lambda: OnlineNaturalGradient().init(8),
        "wsj.run": lambda: wsj.run(num_utts=2, nnet_epochs=1),
        "compute_features": lambda: compute_features(
            synthetic.make_noisy_corpus(lex, wp, 1, 1, 1, seed=1)),
        "mfcc FeatureExtractor": lambda: FeatureExtractor(
            TF.MfccOptions())(wave),
        "make_pnorm_dnn": lambda: make_pnorm_dnn(),
        "OnlineBaseFeature": lambda: OnlineBaseFeature("fbank")
        .accept_waveform(wave),
        "OnlineRecognizer": lambda: OnlineRecognizer(
            _tiny_graph(), lambda f: f).accept_waveform(wave),
        "StreamingDecoder": lambda: StreamingDecoder(
            TopKDecoder(_tiny_graph())),
        "swbd.run": lambda: swbd.run(num_speakers=2, utts_per_speaker=2,
                                     nnet_epochs=1),
        "librispeech.run": lambda: librispeech.run(num_utts=4,
                                                   nnet_epochs=1),
        "make_convnet_ivector": lambda: make_convnet_ivector(
            ConvnetConfig(**CFG), ivector_dim=4),
        "compute-fbank-feats verb": lambda: cli.main([
            "compute-fbank-feats", "wav.scp", "feats.ark"]),
        "add-deltas verb": lambda: cli.main([
            "add-deltas", "feats.ark", "deltas.ark"]),
        "nnet-train verb": lambda: cli.main([
            "nnet-train", "mono.mdl", "egs.npz", "am.mdl"]),
        "latgen-faster verb": lambda: cli.main([
            "latgen-faster", "--lang-dir=lang", "am.mdl", "HCLG.txt",
            "feats.scp", "lats.npz", "hyp.txt"]),
        "compute_plp": lambda: compute_plp(wave),
        "DenseViterbiDecoder": lambda: DenseViterbiDecoder(
            _tiny_graph()).decode_batch([np.zeros((3, 60), np.float32)]),
    }
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|NVIDIA|cuda"):
        calls[entry]()


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No ok line and a non-zero exit without CUDA, and when the script
    stands alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA GPU")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        env = dict(os.environ, PYTHONPATH="")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
