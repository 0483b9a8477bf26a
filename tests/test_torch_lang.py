"""The port's own copies of the JAX package's jax-free modules
(``kaldi_cnn_tpu_torch/{core/config,core/logging,lang/*,native}``) against
the originals: the same graphs arc by arc, the same transition model, the
same config behaviour, and the copied C++ Viterbi core giving the JAX
package's alignment."""

import dataclasses
import os

import numpy as np
import pytest

from kaldi_cnn_tpu.core import config as jconfig
from kaldi_cnn_tpu.core import logging as jlogging
from kaldi_cnn_tpu.decode.decoder import viterbi_align as j_viterbi_align
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.lang import arpa as jarpa
from kaldi_cnn_tpu.lang import hclg as jhclg
from kaldi_cnn_tpu.lang import lexicon as jlexicon
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu_torch import native
from kaldi_cnn_tpu_torch.core import config as tconfig
from kaldi_cnn_tpu_torch.core import logging as tlogging
from kaldi_cnn_tpu_torch.decode import decoder as tdecoder
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.lang import arpa as tarpa
from kaldi_cnn_tpu_torch.lang import hclg as thclg
from kaldi_cnn_tpu_torch.lang import lexicon as tlexicon
from kaldi_cnn_tpu_torch.recipes import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSCRIPTS = [["one"], ["two", "zero", "nine"], ["five", "five", "eight"]]


def _arcs(fst):
    return [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
            for arcs in fst.arcs]


def assert_fst_equal(a, b):
    assert type(a).__module__.startswith("kaldi_cnn_tpu_torch.")
    assert a.num_states == b.num_states and a.start == b.start
    assert list(a.final) == list(b.final)
    assert _arcs(a) == _arcs(b)


def load_jax_native(tmp_path_factory):
    """Loads both packages' native libraries, the JAX package's from a
    build directory of this test process's own, and asserts that both
    loaded.  The JAX loader (``kaldi_cnn_tpu/native/__init__.py``)
    compiles straight into its shared ``_build/``, loads any library
    there newer than the sources, and turns an ``OSError`` into None.  So
    under xdist a process can load another's half-written library, and
    its ``viterbi_align`` then takes the numpy path for the rest of its
    life while the port's takes the C++ one, and the two give different
    alignments.  Fixtures that hold the JAX package's alignments (and
    all that is trained on them) bit-equal to the port's call this
    first."""
    from kaldi_cnn_tpu import native as jnative
    d = tmp_path_factory.getbasetemp() / "jax_native"
    d.mkdir(exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_build_dir", lambda: str(d))
        jnative._TRIED, jnative._LIB = False, None
        jlib = jnative.load()
    assert jlib is not None, (
        "the JAX package's native library did not build or load from "
        f"{d} (no g++, or KALDI_CNN_TPU_NATIVE=0): its viterbi_align "
        "would take the numpy path and its alignments differ from the "
        "port's C++ ones")
    assert native.load() is not None, (
        "the port's native library did not build or load from "
        f"{native.LIB_PATH} (no g++?)")


@pytest.fixture(scope="module")
def langs(tmp_path_factory):
    load_jax_native(tmp_path_factory)
    lex, jlex = synthetic.digits_lexicon(), jsyn.digits_lexicon()
    assert isinstance(lex, tlexicon.Lexicon)
    assert isinstance(jlex, jlexicon.Lexicon)
    return thclg.Lang.create(lex), jhclg.Lang.create(jlex)


def test_lang_create_matches(langs):
    lang, jlang = langs
    for t, j in ((lang.phone_table, jlang.phone_table),
                 (lang.word_table, jlang.word_table)):
        assert [t.sym(i) for i in range(len(t))] == [
            j.sym(i) for i in range(len(j))]
    assert lang.num_disambig == jlang.num_disambig
    assert lang.disambig_phone_ids == jlang.disambig_phone_ids
    tm, jtm = lang.trans_model, jlang.trans_model
    assert tm.num_pdfs == jtm.num_pdfs
    assert tm.num_transition_states == jtm.num_transition_states
    np.testing.assert_array_equal(tm.trans_id_to_pdf_array(),
                                  jtm.trans_id_to_pdf_array())
    np.testing.assert_array_equal(tm.trans_id_to_logprob_array(),
                                  jtm.trans_id_to_logprob_array())


def test_unigram_hclg_matches_arc_by_arc(langs):
    lang, jlang = langs
    wp = {w: 1.0 / len(lang.lexicon.entries) for w in lang.lexicon.entries}
    text = tarpa.make_unigram_arpa(wp)
    assert text == jarpa.make_unigram_arpa(wp)
    assert_fst_equal(thclg.make_hclg_from_arpa(lang, text),
                     jhclg.make_hclg_from_arpa(jlang, text))


@pytest.mark.parametrize("words", TRANSCRIPTS)
def test_training_graph_matches_arc_by_arc(langs, words):
    lang, jlang = langs
    assert_fst_equal(thclg.compile_training_graph(lang, words),
                     jhclg.compile_training_graph(jlang, words))


def _config_classes(configclass):
    """The same nested config, declared with the given decorator."""
    @configclass
    class Inner:
        frame_shift_ms: float = 10.0
        snip_edges: bool = True

    @configclass
    class Outer:
        name: str = "x"
        rate: int = 8000
        inner: Inner = dataclasses.field(default_factory=Inner)
        dims: list = dataclasses.field(default_factory=lambda: [1, 2])

    return Outer


@pytest.mark.parametrize("argv", [
    [],
    ["--rate=16000", "--inner.frame-shift-ms", "12.5"],
    ["--inner.snip-edges=false", "--dims=[3, 4, 5]", "--name", "y"],
])
def test_configclass_round_trips_like_the_original(argv):
    outer = _config_classes(tconfig.configclass)
    got = tconfig.parse_cli(outer, argv)
    want = jconfig.parse_cli(_config_classes(jconfig.configclass), argv)
    flat = tconfig.asdict_flat(got)
    assert flat == jconfig.asdict_flat(want)
    # flat leaves -> overrides -> the same config again
    assert tconfig.parse_cli(outer, [f"--{k}={v}" for k, v in flat.items()
                                     ]) == got


def test_logging_copy_times_and_names_like_the_original():
    assert tlogging.get_logger("kct.test").name == \
        jlogging.get_logger("kct.test").name
    t = tlogging.Timer()
    assert 0.0 <= t.elapsed() < 60.0


def test_native_viterbi_copy_matches_jax_alignment(langs):
    """The port's copy of native/viterbi.cc, built into the port's
    _build/, aligns an utterance as the JAX package's viterbi_align."""
    lang, jlang = langs
    lib = native.load()
    assert lib is not None and hasattr(lib, "kct_viterbi")
    assert os.path.dirname(native.LIB_PATH) == os.path.join(
        ROOT, "kaldi_cnn_tpu_torch", "_build")
    t2p = lang.trans_model.trans_id_to_pdf_array()
    words = TRANSCRIPTS[1]
    g = CompiledGraph(thclg.compile_training_graph(lang, words), t2p)
    jg = JGraph(jhclg.compile_training_graph(jlang, words), t2p)
    rng = np.random.default_rng(5)
    ll = rng.normal(size=(60, lang.trans_model.num_pdfs)).astype(np.float32)
    got = tdecoder.viterbi_align(g, ll)
    want = j_viterbi_align(jg, ll)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    # the numpy path agrees with the copied C++ core
    ids, _, _ = tdecoder._viterbi(tdecoder._PenalizedGraph(g, 0.0), ll, 1.0,
                                  require_final=True)
    np.testing.assert_array_equal(ids, got)
