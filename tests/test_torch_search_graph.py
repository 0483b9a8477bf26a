"""The port's device-resident search on the CPU, against the JAX
package's and against the per-frame loop it replaced: the best-path
backtrace on the JAX decoder's own histories (bit-equal to
``_backtrace_impl``, also with a broken backpointer, which the host
repair then mends to JAX ``decode_batch``'s words and cost), the block
function at S = 1, 4 and 16 level for level equal to the old frame loop
(a copy of it is kept here), and ``decode_utterances`` assembling and
determinizing exactly one lattice per utterance.  On the card the same
block function and backtrace run as CUDA graphs
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 4 and 15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.decode import topk_decoder as T
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.recipes import synthetic

SCALE = 0.1


@pytest.fixture(scope="module")
def mono():
    """The digits lexicon's monophone HCLG (163 states) in both packages
    and four utterances of peaked numpy loglikes."""
    lex = synthetic.digits_lexicon()
    lang = Lang.create(lex)
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(
        {w: 0.1 for w in lex.entries}))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    P = lang.trans_model.num_pdfs
    rng = np.random.default_rng(11)
    lls = []
    for n in (33, 26, 41, 18):
        ll = rng.normal(size=(n, P)).astype(np.float32)
        path = np.repeat(rng.integers(0, P, size=n // 4 + 1), 4)[:n]
        ll[np.arange(n), path] += 6.0
        lls.append(ll)
    g = CompiledGraph(fst, t2p)
    assert g.num_states == 163
    return g, JGraph(fst, t2p), lls


def _path_slot(fs, fc, ba, bp, final, n_e, row, length, level):
    """(level, slot) of ``row``'s best path at ``level`` (numpy histories
    [B, T + 1, K]), walking the backpointers from the row's best final
    token and stepping a level back on each emitting arc."""
    valid = fs[row, length] != np.iinfo(np.int32).max
    tot = np.where(valid, fc[row, length] + final[
        np.where(valid, fs[row, length], 0)], np.float32(1e30))
    t, slot = length, int(np.argmin(tot))
    while t > level:
        a, slot = int(ba[row, t, slot]), int(bp[row, t, slot])
        if a < n_e:
            t -= 1
    return t, slot


def _jax_histories(jdec, lls):
    """JAX's best-path histories on the device ([B, T + 1, K] as numpy,
    level 0 first) and the lengths, as its decode_batch builds them."""
    r, _, lengths = jdec._run(lls, a_lat=0, to_host=False)
    hist = [np.asarray(jnp.concatenate([r["init"][i][:, None],
                                        jnp.swapaxes(r[k], 0, 1)], 1))
            for i, k in enumerate(("fs", "fc", "bp_arc", "bp_prev"))]
    return hist, lengths


def _bt_equal(dec, jdec, hist, lengths):
    """The port's eager backtrace bit-equal to ``_backtrace_impl`` on
    ``hist``; returns the fail flags."""
    want = jax.device_get(jax.jit(jdec._backtrace_impl)(
        *(jnp.asarray(h) for h in hist), jnp.asarray(lengths)))
    got = dec._backtrace_eager(*(torch.tensor(h) for h in hist),
                               torch.as_tensor(lengths))
    arcs, n, cost, fail, empty = (x.numpy() for x in got)
    assert arcs.shape == want[0].shape
    np.testing.assert_array_equal(arcs, want[0])
    np.testing.assert_array_equal(n, want[1])
    np.testing.assert_array_equal(cost.view(np.int32),
                                  np.asarray(want[2]).view(np.int32))
    np.testing.assert_array_equal(fail, want[3])
    np.testing.assert_array_equal(empty, want[4])
    return fail


def test_backtrace_bit_equal_to_jax_and_repaired(mono, monkeypatch):
    """On JAX's own best-path histories: arcs, n, cost, fail and empty
    bit-equal to ``_backtrace_impl``; the same with one backpointer on
    row 0's path set to -1 (fail on row 0 only); and the port's
    decode_batch with that backpointer broken in its own history repairs
    the row on the host to JAX decode_batch's words and cost."""
    g, jg, lls = mono
    kw = dict(beam=60.0, max_active=g.num_states, acoustic_scale=SCALE)
    dec = T.TopKDecoder(g, device="cpu", **kw)
    jdec = TpuTopKDecoder(jg, **kw)
    hist, lengths = _jax_histories(jdec, lls)
    assert not _bt_equal(dec, jdec, hist, lengths).any()

    level, n_e = int(lengths[0]) // 2, g.num_emitting_arcs
    t, slot = _path_slot(*hist, g.final, n_e, 0, int(lengths[0]), level)
    broken = [h.copy() for h in hist]
    broken[2][0, t, slot] = -1
    fail = _bt_equal(dec, jdec, broken, lengths)
    assert fail.tolist() == [True, False, False, False]

    decode, best_path, repaired = (T.TopKDecoder._decode,
                                   T.TopKDecoder._best_path, [])

    def corrupt(self, am, lattice=False):
        r = decode(self, am, lattice)
        hist = [x.numpy() for x in self._split(r["lv"])]
        t, slot = _path_slot(*hist, g.final, n_e, 0, len(lls[0]), level)
        r["lv"][t, 2, 0, slot] = -1
        return r

    def count(self, *a):
        repaired.append(a[2])
        return best_path(self, *a)

    monkeypatch.setattr(T.TopKDecoder, "_decode", corrupt)
    monkeypatch.setattr(T.TopKDecoder, "_best_path", count)
    got = dec.decode_batch(lls)
    want = jdec.decode_batch(lls)
    assert repaired == [len(lls[0])]
    for (tt, tw, tc), (jt, jw, jc) in zip(got, want):
        assert list(tt) == list(jt) and list(tw) == list(jw)
        assert tc == pytest.approx(jc, rel=1e-5)


def _start(dec, B):
    """The start token's level before its eps closure, [B, K]."""
    s0 = torch.full((B, dec.K), T._INVALID, dtype=torch.int32)
    s0[:, 0] = dec.g.start
    c0 = torch.full((B, dec.K), T._BIG, dtype=torch.float32)
    c0[:, 0] = 0.0
    return s0, c0


def _old_decode(dec, am, lattice=False):
    """The per-frame loop the block function replaced (the port's
    ``_decode`` before the search ran as CUDA graphs), kept as the
    reference: per level (fs, fc, bp_arc, bp_prev), or per level the
    states and (records, counts) of the lattice variant."""
    B, T_, _ = am.shape
    s0, c0 = _start(dec, B)
    fs, fc = dec._eps_fixpoint(s0, c0, dec._am_ext(am[:, 0]))
    am_next = torch.cat([am[:, 1:], am[:, -1:]], dim=1)
    if lattice:
        r = {"fs": [fs], "e": [None], "n": [dec._eps_records(fs, fc)]}
        for t in range(T_):
            fs, fc, e, n = dec._frame(fs, fc, am[:, t], am_next[:, t],
                                      lattice=True)
            r["fs"].append(fs)
            r["e"].append(e)
            r["n"].append(n)
        return r
    root = torch.full((B, dec.K), -1, dtype=torch.int64)
    levels = [(fs, fc) + dec._resolve_bp(fs, fc, s0, c0, root, root)]
    for t in range(T_):
        levels.append(dec._frame(fs, fc, am[:, t], am_next[:, t]))
        fs, fc = levels[-1][0], levels[-1][1]
    return levels


def _level_pairs(out, want, t, lattice):
    """(block function's, old loop's) tensors of frame t's level."""
    if lattice:
        (er, ec), (nr, nc) = want["e"][t + 1], want["n"][t + 1]
        return zip([out[k][t] for k in ("fs", "e_rec", "e_cnt", "n_rec",
                                        "n_cnt")],
                   [want["fs"][t + 1], er, ec, nr, nc], strict=True)
    fs, fc, ba, bp = want[t + 1]
    return zip(list(out["lv"][t]), [fs, fc.view(torch.int32), ba, bp],
               strict=True)


@pytest.mark.parametrize("lattice", [False, True])
def test_block_function_equals_the_frame_loop(mono, lattice):
    """The block function over blocks of S = 1, 4 and 16 frames (and
    ``_decode``, which runs it once over all frames on the CPU), level
    for level equal to the old per-frame loop, at K = 48 (top-K pruning
    active) on three utterances padded to the longest; ``_decode``'s
    level 0 too."""
    g, _, lls = mono
    dec = T.TopKDecoder(g, beam=60.0, max_active=48, acoustic_scale=SCALE,
                        lattice_arcs_per_frame=None, device="cpu")
    am = torch.as_tensor(dec._pad(lls[:3])[0])
    B, T_, _ = am.shape
    want = _old_decode(dec, am, lattice)
    rows = torch.cat([am, am[:, -1:]], 1).transpose(0, 1).contiguous()
    carry = dec._eps_fixpoint(*_start(dec, B), dec._am_ext(am[:, 0]))
    runs = {}
    for S in (1, 4, 16):
        fs, fc = carry
        out = dec._levels(T_, B, lattice, "cpu")
        for i in range(0, T_, S):
            fs, fc = dec._block(fs, fc, rows[i:i + S + 1],
                                {k: v[i:i + S] for k, v in out.items()},
                                lattice)
        runs[S] = out
    r = dec._decode(am, lattice)
    if lattice:
        runs["decode"] = {"fs": r["fs"][1:], "e_rec": r["e_rec"],
                          "e_cnt": r["e_cnt"], "n_rec": r["n_rec"][1:],
                          "n_cnt": r["n_cnt"][1:]}
        level0 = [(r["fs"][0], want["fs"][0]),
                  (r["n_rec"][0], want["n"][0][0]),
                  (r["n_cnt"][0], want["n"][0][1])]
    else:
        runs["decode"] = {"lv": r["lv"][1:]}
        fs, fc, ba, bp = want[0]
        level0 = zip(list(r["lv"][0]), [fs, fc.view(torch.int32), ba, bp])
    for name, out in runs.items():
        for t in range(T_):
            for a, b in _level_pairs(out, want, t, lattice):
                assert torch.equal(a, b.to(torch.int32)), (name, t)
    for a, b in level0:
        assert torch.equal(a, b.to(torch.int32))


def test_decode_utterances_assembles_one_lattice_per_utterance(
        mono, monkeypatch):
    """Five utterances in batches of 4 (one bucket of 64 frames): the
    short last batch is searched 4 rows wide, but exactly five lattices
    are assembled and determinized, and the last one equals its
    utterance decoded alone (no padding rows)."""
    g, _, lls = mono
    lls = dict(zip("abcde", lls + [lls[0][:20]]))
    calls = {"assemble": 0, "determinize": 0, "rows": []}
    assemble, determinize = (T.TopKDecoder._assemble_lattice,
                             T.determinize_lattice)
    decode = T.TopKDecoder._decode

    def count(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    def rows(self, am, lattice=False):
        calls["rows"].append(am.shape[0])
        return decode(self, am, lattice)

    monkeypatch.setattr(T.TopKDecoder, "_assemble_lattice",
                        count("assemble", assemble))
    monkeypatch.setattr(T, "determinize_lattice",
                        count("determinize", determinize))
    monkeypatch.setattr(T.TopKDecoder, "_decode", rows)
    dec = T.TopKDecoder(g, beam=16.0, max_active=64, acoustic_scale=SCALE,
                        lattice_arcs_per_frame=None, device="cpu")
    got = T.decode_utterances(g, lls, acoustic_scale=SCALE, beam=16.0,
                              max_active=64, batch_size=4,
                              bucket_frames=64, decoder=dec, device="cpu")
    assert sorted(got) == sorted(lls)
    assert calls["assemble"] == calls["determinize"] == len(lls)
    assert calls["rows"] == [4, 4]
    alone = dec.decode_batch_lattice([lls["e"]], pad_frames=64)[0]
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel",
              "arc_graph", "arc_acoustic", "final_graph", "state_time"):
        np.testing.assert_array_equal(getattr(alone, k),
                                      getattr(got["e"], k))
