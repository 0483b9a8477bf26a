"""The port's lattice and Table I/O layer against the JAX package's on
the CPU: the verbatim twins (``io/{native_io,compressed,kaldi_lattice}.py``,
``lang/const_arpa.py``, ``native/tableio.cc``) by source text; the native
mmap readers (the port's library really loaded, ``ArkIndex`` opens) giving
the same keys and arrays as ``kaldi_io.read_ark`` and as the JAX readers,
an int-vector ark and one of more than 1024 entries included; compressed
matrices blob for blob; Kaldi-binary CompactLattice arks byte for byte
equal between the two packages' writers and read by either; and
``ConstArpaLm`` (``log_prob`` on every n-gram of a bigram LM, ``save`` /
``load`` array for array)."""

import os

import numpy as np
import pytest

from kaldi_cnn_tpu.decode import lattice as jlat
from kaldi_cnn_tpu.io import compressed as jcomp
from kaldi_cnn_tpu.io import kaldi_lattice as jkl
from kaldi_cnn_tpu.io import native_io as jnio
from kaldi_cnn_tpu.lang import arpa as jarpa
from kaldi_cnn_tpu.lang import const_arpa as jca
from kaldi_cnn_tpu_torch import native
from kaldi_cnn_tpu_torch.decode import lattice as tlat
from kaldi_cnn_tpu_torch.decode.biggraph import make_big_graph, sample_loglikes
from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
from kaldi_cnn_tpu_torch.io import compressed as tcomp
from kaldi_cnn_tpu_torch.io import kaldi_lattice as tkl
from kaldi_cnn_tpu_torch.io import native_io as tnio
from kaldi_cnn_tpu_torch.io.kaldi_io import read_ark, write_ark
from kaldi_cnn_tpu_torch.lang import arpa as tarpa
from kaldi_cnn_tpu_torch.lang import const_arpa as tca
from test_torch_lang import load_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("num_states", "start", "state_time", "arc_src", "arc_dst",
          "arc_ilabel", "arc_olabel", "arc_graph", "arc_acoustic",
          "final_graph")


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


@pytest.mark.parametrize("path", [
    "io/native_io.py", "io/compressed.py", "io/kaldi_lattice.py",
    "lang/const_arpa.py", "native/tableio.cc"])
def test_twins_are_verbatim(path):
    """Each twin is its original with the imports pointed at the port."""
    want = _source(f"kaldi_cnn_tpu/{path}").replace(
        "kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.").replace(
        "from kaldi_cnn_tpu import", "from kaldi_cnn_tpu_torch import")
    assert _source(f"kaldi_cnn_tpu_torch/{path}") == want


# ---------------------------------------------------------------- lattices

def hand_lattice():
    """``tests/test_cli.py``'s two-word lattice (the ``lat_npz`` fixture):
    'yes' at graph+acoustic 4.0 + 1.5, 'no' at 3.5 + 1.5."""
    return tlat.Lattice(
        num_states=4, start=0,
        state_time=np.asarray([0, 1, 1, 2], np.int32),
        arc_src=np.asarray([0, 0, 1, 2], np.int32),
        arc_dst=np.asarray([1, 2, 3, 3], np.int32),
        arc_ilabel=np.asarray([5, 6, 7, 7], np.int32),
        arc_olabel=np.asarray([1, 2, 0, 0], np.int32),
        arc_graph=np.asarray([1.0, 2.0, 0.5, 0.5], np.float32),
        arc_acoustic=np.asarray([3.0, 1.5, 1.0, 1.0], np.float32),
        final_graph=np.asarray([np.inf, np.inf, np.inf, 0.25], np.float32))


def decoded_lattices(n=3):
    """``hand_lattice`` and ``n`` host lattices (the port's verbatim
    ``lattice_decode``) of a 40-word ``make_big_graph`` on seeded
    ``sample_loglikes``: eps hub arcs, word arcs, pass-through chains."""
    g = make_big_graph(num_words=40, num_pdfs=16, min_len=2, max_len=4,
                       seed=3)
    lats = {"utt0": hand_lattice()}
    for s in range(n):
        ll = sample_loglikes(g, 16, T=30, seed=s)
        lats[f"utt{s + 1}"] = lattice_decode(
            g, ll, acoustic_scale=0.5, beam=10.0, lattice_beam=6.0)
    return lats


def to_jax(lat):
    return jlat.Lattice(**{k: getattr(lat, k) for k in FIELDS})


def assert_lattices_equal(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


@pytest.fixture(scope="module")
def lats():
    return decoded_lattices()


def test_compact_lattices_equal(lats):
    for utt, lat in lats.items():
        got, want = (tkl.lattice_to_compact(lat),
                     jkl.lattice_to_compact(to_jax(lat)))
        assert got.num_states > 0 and got.num_arcs > 0
        for k in ("num_states", "start", "arc_src", "arc_dst", "arc_word",
                  "arc_graph", "arc_acoustic", "final_graph",
                  "final_acoustic"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=f"{utt} {k}")
        for a, b in zip(got.arc_string, want.arc_string):
            np.testing.assert_array_equal(a, b)
        assert_lattices_equal(tkl.compact_to_lattice(got),
                              jkl.compact_to_lattice(want))


def test_lattice_arks_byte_equal_and_cross_read(lats, tmp_path):
    t_ark, j_ark = str(tmp_path / "t.lat"), str(tmp_path / "j.lat")
    tkl.write_compact_lattice_ark(t_ark, lats)
    jkl.write_compact_lattice_ark(j_ark, {u: to_jax(l)
                                          for u, l in lats.items()})
    with open(t_ark, "rb") as f, open(j_ark, "rb") as g:
        raw = f.read()
        assert raw == g.read()
    assert raw.startswith(b"utt0 \0B")
    by_port, by_jax = (tkl.read_compact_lattice_ark(j_ark),
                       jkl.read_compact_lattice_ark(t_ark))
    assert sorted(by_port) == sorted(by_jax) == sorted(lats)
    for utt in lats:
        assert_lattices_equal(by_port[utt], by_jax[utt])
        # the one-best survives the archive
        want = tlat.shortest_path(lats[utt], 1.0, 0.5)
        got = tlat.shortest_path(by_port[utt], 1.0, 0.5)
        assert list(got[0]) == list(want[0])
        assert list(got[1]) == list(want[1])
        assert got[2] == pytest.approx(want[2], rel=1e-5, abs=1e-3)


# ------------------------------------------------------------- native I/O

@pytest.fixture(scope="module")
def arks(tmp_path_factory):
    """Both libraries loaded (the JAX one from a build directory of this
    process's own), a mixed ark (f32/f64 matrices, a vector, an int
    vector) and a 1500-entry ark."""
    load_jax_native(tmp_path_factory)
    assert native.load() is not None
    rng = np.random.default_rng(13)
    d = tmp_path_factory.mktemp("arks")
    mixed = {"utt_a": rng.normal(size=(17, 13)).astype(np.float32),
             "utt_b": rng.normal(size=(5, 4)).astype(np.float64),
             "utt_c": rng.normal(size=23).astype(np.float32),
             "utt_d": np.asarray([3, 1, 4, 1, 5, 9], np.int32)}
    big = {f"u{i:05d}": rng.normal(size=(2, 3)).astype(np.float32)
           for i in range(1500)}
    paths = {"mixed": str(d / "mixed.ark"), "big": str(d / "big.ark")}
    write_ark(paths["mixed"], mixed)
    write_ark(paths["big"], big)
    return paths, {"mixed": mixed, "big": big}


@pytest.mark.parametrize("name", ["mixed", "big"])
def test_native_readers_match(arks, name):
    paths, data = arks
    path = paths[name]
    index = tnio.ArkIndex(path)          # the native scan, no fallback
    assert len(index) == len(data[name])
    want = list(read_ark(path))
    seq = list(tnio.SequentialArkReader(path))
    jseq = list(jnio.SequentialArkReader(path))
    assert [k for k, _ in seq] == [k for k, _ in want] == \
        [k for k, _ in jseq] == list(data[name])
    for (k, v), (_, w), (_, j) in zip(seq, want, jseq):
        assert v.dtype == w.dtype == j.dtype, k
        np.testing.assert_array_equal(v, w)
        np.testing.assert_array_equal(v, j)
    ra, jra = tnio.RandomAccessArkReader(path), jnio.RandomAccessArkReader(
        path)
    assert ra.keys() == jra.keys() == list(data[name])
    assert "nope" not in ra
    for k in ra.keys()[::97] + ra.keys()[-1:]:
        np.testing.assert_array_equal(ra[k], jra[k])
        np.testing.assert_array_equal(ra[k], data[name][k])


def test_compressed_matrices_equal(tmp_path):
    rng = np.random.default_rng(17)
    mats = {f"u{i}": (rng.normal(size=(30 + 7 * i, 13)) * 10
                      ).astype(np.float32) for i in range(3)}
    mats["flat"] = np.full((4, 5), 2.5, np.float32)   # zero column range
    for u, m in mats.items():
        got, want = tcomp.compress_matrix(m), jcomp.compress_matrix(m)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=u)
        np.testing.assert_array_equal(tcomp.decompress_matrix(got),
                                      jcomp.decompress_matrix(want))
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tcomp.save_compressed_ark(t_path, mats)
    jcomp.save_compressed_ark(j_path, mats)
    for a, b in ((t_path, j_path), (j_path, t_path)):
        got, want = tcomp.load_compressed_ark(a), jcomp.load_compressed_ark(b)
        assert sorted(got) == sorted(want) == sorted(mats)
        for u in mats:
            np.testing.assert_array_equal(got[u], want[u])


# ---------------------------------------------------------------- LM

TRANSCRIPTS = [["yes", "no"], ["yes", "yes"], ["no", "yes"], ["no"],
               ["yes", "no", "yes"], ["maybe", "no"]]
VOCAB = {"yes": 1, "no": 2, "maybe": 3, "<s>": 10, "</s>": 11}


def test_const_arpa_equal(tmp_path):
    text = tarpa.estimate_bigram_arpa(TRANSCRIPTS)
    assert text == jarpa.estimate_bigram_arpa(TRANSCRIPTS)
    lm = tca.ConstArpaLm.from_arpa(tarpa.parse_arpa(text), VOCAB)
    jlm = jca.ConstArpaLm.from_arpa(jarpa.parse_arpa(text), VOCAB)
    assert (lm.vocab, lm.base, lm.bos_id, lm.eos_id, lm.max_order) == (
        jlm.vocab, jlm.base, jlm.bos_id, jlm.eos_id, jlm.max_order)
    ids = sorted(VOCAB.values())
    for h in [[]] + [[i] for i in ids]:
        for w in ids:
            assert lm.log_prob(h, w) == jlm.log_prob(h, w), (h, w)
            assert lm.advance(tuple(h), w) == jlm.advance(tuple(h), w)
    for words in ([1, 2, 1], [3, 3], [2]):
        assert lm.sentence_logprob(words) == jlm.sentence_logprob(words)
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    lm.save(t_path)
    jlm.save(j_path)
    with np.load(t_path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back, jback = tca.ConstArpaLm.load(j_path), jca.ConstArpaLm.load(t_path)
    assert back.vocab == jback.vocab == lm.vocab
    for k in range(lm.max_order):
        for f in ("keys", "logp", "bow"):
            np.testing.assert_array_equal(getattr(back, f)[k],
                                          getattr(jback, f)[k])
