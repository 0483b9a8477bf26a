"""Parity of the port's top-K best-path decoder with the JAX package's
TpuTopKDecoder and the host Viterbi decoder, on numpy-made loglikes
(no GMM training), plus the graph and WER twins and the recombination
primitive."""

import copy
import math

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode.biggraph import make_big_graph, sample_loglikes
from kaldi_cnn_tpu.decode.decoder import viterbi_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.score import wer_details as j_wer_details
from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.decode import topk_decoder as T
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.score import edit_distance, wer_details
from kaldi_cnn_tpu_torch.recipes import synthetic

SCALE = 0.1


def _check(results, lls, ref, scale=SCALE):
    """Same words and cost within rel 1e-5 / abs 1e-2 (test_topk_decoder)."""
    assert len(results) == len(ref) == len(lls)
    for ll, (tids, words, cost), (_, rw, rc) in zip(lls, results, ref):
        assert list(words) == list(rw)
        assert len(tids) == ll.shape[0]
        assert cost == pytest.approx(rc, rel=1e-5, abs=1e-2)


@pytest.fixture(scope="module")
def digits():
    lex = synthetic.digits_lexicon()
    wp = {w: 0.1 for w in lex.entries}
    lang = Lang.create(lex)
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(wp))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    P = lang.trans_model.num_pdfs
    rng = np.random.default_rng(5)
    # peaked numpy loglikes: each utterance follows a random pdf path
    lls = []
    for T_ in (40, 55, 31, 47):
        ll = rng.normal(size=(T_, P)).astype(np.float32)
        path = np.repeat(rng.integers(0, P, size=T_ // 4 + 1), 4)[:T_]
        ll[np.arange(T_), path] += 6.0
        lls.append(ll)
    return CompiledGraph(fst, t2p), JGraph(fst, t2p), lls


def _host(g, lls, scale=SCALE):
    return [viterbi_decode(g, ll, acoustic_scale=scale, beam=np.inf,
                           max_active=0) for ll in lls]


@pytest.mark.parametrize("beam,max_active", [(1e8, None), (60.0, 48)])
def test_decode_batch_matches_jax_and_host(digits, beam, max_active):
    g, jg, lls = digits
    ma = max_active or g.num_states + 32
    got = T.TopKDecoder(g, beam=beam, max_active=ma, acoustic_scale=SCALE,
                        device="cpu").decode_batch(lls)
    _check(got, lls, _host(jg, lls))
    want = TpuTopKDecoder(jg, beam=beam, max_active=ma,
                          acoustic_scale=SCALE).decode_batch(lls)
    _check(got, lls, want)
    for (ta, _, _), (tb, _, _) in zip(got, want):
        assert list(ta) == list(tb)


def test_padding_and_degree_caps_do_not_change_result(digits):
    g, _, lls = digits
    a = T.TopKDecoder(g, beam=1e8, max_active=g.num_states + 32,
                      acoustic_scale=SCALE, device="cpu").decode_batch(lls[:2])
    # a third, 70-frame utterance pads the first two to 70 frames
    longer = np.concatenate([lls[1], lls[0][:15]])
    b = T.TopKDecoder(g, beam=1e8, max_active=2 * g.num_states,
                      acoustic_scale=SCALE, max_emit_deg=2, max_eps_deg=2,
                      device="cpu").decode_batch(lls[:2] + [longer])[:2]
    for (ta, wa, ca), (tb, wb, cb) in zip(a, b):
        assert list(ta) == list(tb) and list(wa) == list(wb)
        assert ca == pytest.approx(cb, rel=1e-5, abs=1e-2)


def test_last_reached_final_reports_the_end_state(digits):
    """``last_reached_final`` (ref: ReachedFinal()): every row's best
    path ends in a final state on the digits graph, and none with every
    final weight infinite, where each row ends on its cheapest token."""
    g, _, lls = digits
    kw = dict(beam=1e8, max_active=g.num_states + 32, acoustic_scale=SCALE,
              device="cpu")
    dec = T.TopKDecoder(g, **kw)
    assert dec.last_reached_final is None
    dec.decode_batch(lls[:2])
    assert dec.last_reached_final.tolist() == [True, True]
    g2 = copy.copy(g)
    g2.final = np.full_like(g.final, np.inf)
    dec = T.TopKDecoder(g2, **kw)
    got = dec.decode_batch(lls[:2])
    assert dec.last_reached_final.tolist() == [False, False]
    assert all(np.isfinite(c) and len(t) == len(ll)
               for (t, _, c), ll in zip(got, lls))


def _eps_exit_graph(num_words=12, num_pdfs=16, seed=0):
    """Word loop whose words end in an eps arc (carrying the word label)
    back into the hub: the hub's eps in-degree exceeds the in-CSR cap, so
    backpointer resolution takes the in-hub path, and the eps depth is 2
    (word end -> hub -> word start)."""
    rng = np.random.default_rng(seed)
    e, n = [], []
    s = 1
    for w in range(num_words):
        n.append((0, s, 0, math.log(num_words) + rng.uniform(-1, 1)))
        for _ in range(int(rng.integers(2, 4))):
            pdf = int(rng.integers(num_pdfs))
            e += [(s, s, pdf, 0.7), (s, s + 1, pdf, 0.7)]
            s += 1
        n.append((s, 0, w + 1, 0.0))
        s += 1
    g = CompiledGraph.__new__(CompiledGraph)
    g.num_states, g.start = s, 0
    g.e_src, g.e_dst = (np.array([a[i] for a in e], np.int32)
                        for i in (0, 1))
    g.e_pdf = np.array([a[2] for a in e], np.int32)
    g.e_ilabel = g.e_pdf + 1
    g.e_olabel = np.zeros(len(e), np.int32)
    g.e_weight = np.array([a[3] for a in e], np.float32)
    g.n_src, g.n_dst, g.n_olabel = (np.array([a[i] for a in n], np.int32)
                                    for i in (0, 1, 2))
    g.n_weight = np.array([a[3] for a in n], np.float32)
    g.final = np.full(s, np.inf, np.float32)
    g.final[0] = 0.0
    return g


@pytest.mark.parametrize("kind", ["eps_exit", "big"])
def test_hub_graphs_match_jax_and_host(kind):
    if kind == "eps_exit":
        g, P = _eps_exit_graph(), 16
        lls = [sample_loglikes(g, P, T=30, seed=s) for s in (0, 1)]
    else:
        g, P = make_big_graph(num_words=300, num_pdfs=32, min_len=3,
                              max_len=5, seed=3), 32
        lls = [sample_loglikes(g, P, T=25, seed=s) for s in (0, 1)]
    dec = T.TopKDecoder(g, beam=80.0, max_active=256, acoustic_scale=1.0,
                        device="cpu")
    if kind == "eps_exit":
        assert dec.Hni > 0 and dec.eps_iters == 2
    else:
        assert dec.Hn > 0
    got = dec.decode_batch(lls)
    _check(got, lls, _host(g, lls, 1.0), 1.0)
    _check(got, lls, TpuTopKDecoder(g, beam=80.0, max_active=256,
                                    acoustic_scale=1.0).decode_batch(lls))


def test_topk_graph_twin_equals_jax(digits):
    from kaldi_cnn_tpu.decode.topk_decoder import TopKGraph as JTopKGraph
    g, jg, _ = digits
    a, b = T.TopKGraph(g), JTopKGraph(jg)
    for k, v in vars(b).items():
        np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)


def test_compiled_graph_twin_is_bit_equal(digits):
    g, jg, _ = digits
    assert vars(g).keys() == vars(jg).keys()
    for k, v in vars(jg).items():
        np.testing.assert_array_equal(getattr(g, k), v, err_msg=k)
        assert np.asarray(getattr(g, k)).dtype == np.asarray(v).dtype


def test_wer_twin_equals_jax():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "d"]
    refs = {f"u{i}": list(rng.choice(words, rng.integers(0, 6)))
            for i in range(20)}
    hyps = {u: list(rng.choice(words, rng.integers(0, 6)))
            for u in list(refs)[:-2]}
    assert wer_details(refs, hyps) == j_wer_details(refs, hyps)
    assert edit_distance("abc", "abd") == (1, 1, 0, 0)


def test_recombine_keeps_cheapest_per_state_sorted():
    """The packed (dst, cost) key orders negative, zero and positive
    costs; duplicates keep the cheapest; output is state-sorted with
    INVALID padding last."""
    inv = T._INVALID
    dst = torch.tensor([[5, 3, 5, 3, inv, 9, 1]], dtype=torch.int32)
    cost = torch.tensor([[2.0, -1.5, -3.0, 0.0, 0.0, 4.0, 1e30]])
    pay = torch.arange(7)[None]
    s, c, p = T._recombine_topk(dst, cost, (pay,), 5, 100.0)
    assert s.tolist() == [[3, 5, 9, inv, inv]]
    assert c[0, :3].tolist() == [-1.5, -3.0, 4.0]
    assert p[0, :3].tolist() == [1, 2, 5]
    # beam cutoff: min -3 + 5 = 2 drops the cost-4 token
    s, c = T._recombine_topk(dst, cost, (), 5, 5.0)
    assert s[0, :3].tolist() == [3, 5, inv]
    keys = T._sort_key(torch.zeros(5, dtype=torch.int32),
                       torch.tensor([3.0, -0.0, -2.0, 0.0, -1e30]))
    assert torch.argsort(keys).tolist() == [4, 2, 1, 3, 0]
