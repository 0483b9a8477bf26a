"""Parity of the port's lattice decode with the JAX package's, on the CPU:
the ``tree/`` and ``decode/lattice.py`` twins, the host decoders, the
record compaction, ``TopKDecoder.decode_batch_lattice`` against
``TpuTopKDecoder.decode_batch_lattice`` (raw lattices arc for arc where K
covers every state; determinized one-best words and costs elsewhere),
overflow reporting and auto-grow, ``decode_utterances``, ``score_sweep``
and ``recipes.wsj.decode_and_score``.  The loglikes come from a JAX mono
GMM on digit utterances (the setup of tests/test_topk_decoder.py) and are
fed to both packages."""

import inspect
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode import decoder as jdecoder
from kaldi_cnn_tpu.decode.biggraph import make_big_graph, sample_loglikes
from kaldi_cnn_tpu.decode import lattice as jlat
from kaldi_cnn_tpu.decode.graph import CompiledGraph as JGraph
from kaldi_cnn_tpu.decode.score import wer_details as j_wer_details
from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
from kaldi_cnn_tpu.decode.topk_decoder import \
    decode_utterances as j_decode_utterances
from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.features.extractor import FeatureExtractor as JFE
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.models.factory import (ConvnetConfig as JCfg,
                                          make_convnet as j_make_convnet)
from kaldi_cnn_tpu.models.nnet import AmNnet as JAmNnet
from kaldi_cnn_tpu.recipes import rm as jrm
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu.recipes.wsj import splice_volume as j_splice
from kaldi_cnn_tpu.recipes.yesno import compute_features
from kaldi_cnn_tpu_torch.convert import params_from_jax
from kaldi_cnn_tpu_torch.decode import decoder as tdecoder
from kaldi_cnn_tpu_torch.decode import lattice as tlat
from kaldi_cnn_tpu_torch.decode import topk_decoder as T
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes import rm as trm
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj
from test_torch_decoder import _eps_exit_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.1
# determinized one-best costs, port vs JAX (tests/test_topk_decoder.py)
COST_REL, COST_ABS = 1e-4, 5e-2
ARC_ATOL = 1e-5           # raw lattice arc costs, port vs JAX
FIELDS = ("state_time", "arc_src", "arc_dst", "arc_ilabel", "arc_olabel")
COSTS = ("arc_graph", "arc_acoustic", "final_graph")


@pytest.fixture(scope="module")
def setup():
    """A JAX mono GMM's loglikes of 6 digit utterances, both packages'
    graphs of the same HCLG, the transition model and the transcripts."""
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    lex = jsyn.digits_lexicon()
    wp = {w: 0.1 for w in lex.entries}
    corpus = jsyn.make_corpus(lex, wp, 24, 1, 3, 23)
    feats = compute_features(corpus, seed=23)
    lang = Lang.create(lex)
    am, _ = train_mono(feats, corpus.transcripts, lang,
                       MonoTrainOptions(num_iters=8, totgauss=150))
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(wp))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    utts = sorted(feats)[:6]
    lls = {u: np.asarray(am.loglikes(feats[u]), np.float32) for u in utts}
    return dict(g=CompiledGraph(fst, t2p), jg=JGraph(fst, t2p), lls=lls,
                utts=utts, lang=lang,
                refs={u: corpus.transcripts[u] for u in utts})


def _port_lattice(lat) -> tlat.Lattice:
    return tlat.Lattice(**{k: getattr(lat, k) for k in (
        "num_states", "start") + FIELDS + COSTS})


def assert_lattices_equal(a, b, atol=ARC_ATOL):
    assert (a.num_states, a.start) == (b.num_states, b.start)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    for k in COSTS:
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=0,
                                   atol=atol, err_msg=k)


def _source(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


# ROADMAP 3.24: the port's determinize_lattice (and its helper) returns the
# raw lattice's best path where the JAX one runs out of pops and returns an
# empty lattice; the rest of the file is its original
LATTICE_DIVERGENT = ("determinize_lattice", "_best_path_by_words")


def _without_defs(text_, names):
    """``text_`` with its top-level functions ``names`` cut out, each with
    the blank lines before it."""
    import ast
    lines = text_.splitlines(keepends=True)
    cut = set()
    for node in ast.parse(text_).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            start = node.lineno - 1
            while start > 0 and not lines[start - 1].strip():
                start -= 1
            cut.update(range(start, node.end_lineno))
    return "".join(x for i, x in enumerate(lines) if i not in cut)


@pytest.mark.parametrize("port,ref", [
    ("kaldi_cnn_tpu_torch/tree/event_map.py",
     "kaldi_cnn_tpu/tree/event_map.py"),
    ("kaldi_cnn_tpu_torch/tree/stats.py", "kaldi_cnn_tpu/tree/stats.py"),
    ("kaldi_cnn_tpu_torch/decode/lattice.py",
     "kaldi_cnn_tpu/decode/lattice.py"),
    ("lattice_decode", "lattice_decode"),
    ("viterbi_decode", "viterbi_decode"),
    ("score_sweep", "score_sweep")])
def test_twins_are_verbatim(port, ref):
    """Each twin is its original with the imports (and the docstrings'
    module paths) pointed at the port."""
    if port.endswith(".py"):
        got, want = _source(port), _source(ref)
        if port.endswith("decode/lattice.py"):
            got = _without_defs(got, LATTICE_DIVERGENT)
            want = _without_defs(want, LATTICE_DIVERGENT)
    else:
        mods = {"score_sweep": (trm, jrm)}.get(port, (tdecoder, jdecoder))
        got, want = (inspect.getsource(getattr(m, port)) for m in mods)
    want = want.replace("kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")
    assert got == want


@pytest.fixture(scope="module")
def host_lattices(setup):
    """JAX host lattice of the first utterance, in both packages' types."""
    lat = jdecoder.lattice_decode(setup["jg"], setup["lls"][setup["utts"][0]],
                                  acoustic_scale=SCALE, beam=14.0,
                                  lattice_beam=7.0, max_active=0)
    return lat, _port_lattice(lat)


def _equal(a, b):
    if isinstance(a, (jlat.Lattice, tlat.Lattice)):
        assert_lattices_equal(a, b, atol=0)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn", [
    "shortest_path", "prune_lattice", "determinize_lattice", "nbest",
    "word_alignment", "arc_posteriors", "mbr_decode", "push_lattice",
    "minimize_lattice", "save_load"])
def test_lattice_functions_equal_jax(setup, host_lattices, fn, tmp_path):
    """The lattice twin gives the JAX module's results bit for bit."""
    jl, tl = host_lattices

    def run(mod, lat):
        if fn == "shortest_path":
            return mod.shortest_path(lat, 1.0, 0.08, -0.5)
        if fn == "prune_lattice":
            return mod.prune_lattice(lat, 3.0, acoustic_scale=SCALE)
        if fn == "determinize_lattice":
            return mod.determinize_lattice(lat, acoustic_scale=SCALE)
        if fn == "nbest":
            return mod.nbest(lat, 5, acoustic_scale=SCALE)
        if fn == "word_alignment":
            tids, words, _ = mod.shortest_path(lat, acoustic_scale=SCALE)
            return mod.word_alignment(lat, tids, words,
                                      setup["lang"].trans_model)
        if fn == "arc_posteriors":
            return mod.arc_posteriors(lat, acoustic_scale=SCALE)
        if fn == "mbr_decode":
            return mod.mbr_decode(lat, acoustic_scale=SCALE)
        if fn == "push_lattice":
            return mod.push_lattice(lat)
        if fn == "minimize_lattice":
            return mod.minimize_lattice(mod.determinize_lattice(lat))
        path = str(tmp_path / f"{mod.__name__}.npz")
        mod.save_lattices(path, {"u": lat})
        return mod.load_lattices(path)["u"]

    _equal(run(tlat, tl), run(jlat, jl))


def _flat_lattice(mod, per_frame=2, frames=18):
    """A chain of ``frames`` frames, each ``per_frame`` parallel arcs at
    equal costs (a word on every third frame, the same on each of its
    arcs): every alignment ties, so the ranked path search pops each of
    the 2^t partial paths before any reaches the final state, past its
    200,000-pop budget at 18 frames."""
    src = np.repeat(np.arange(frames), per_frame).astype(np.int32)
    n = len(src)
    return mod.Lattice(
        num_states=frames + 1, start=0,
        state_time=np.arange(frames + 1, dtype=np.int32),
        arc_src=src, arc_dst=src + 1,
        arc_ilabel=(np.arange(n) % per_frame + 1).astype(np.int32),
        arc_olabel=np.where(src % 3 == 0, src // 3 + 1, 0).astype(np.int32),
        arc_graph=np.full(n, 0.5, np.float32),
        arc_acoustic=np.full(n, 10.0, np.float32),
        final_graph=np.r_[np.full(frames, np.inf), 0.0].astype(np.float32))


def test_determinize_falls_back_to_the_best_path_when_pops_run_out():
    """ROADMAP 3.24: on a flat lattice whose path search runs out of pops,
    the JAX function returns an empty lattice (1 state, no arc); the
    port's returns the raw lattice's one-best words and cost."""
    want = jlat.determinize_lattice(_flat_lattice(jlat), acoustic_scale=SCALE)
    assert (want.num_states, want.num_arcs) == (1, 0)
    raw = _flat_lattice(tlat)
    got = tlat.determinize_lattice(raw, acoustic_scale=SCALE)
    _, words, cost = tlat.shortest_path(got, acoustic_scale=SCALE)
    _, best_words, best_cost = tlat.shortest_path(raw, acoustic_scale=SCALE)
    assert got.num_arcs == 18 and list(words) == list(best_words)
    assert list(best_words) == list(range(1, 7))
    np.testing.assert_allclose(cost, best_cost, rtol=COST_REL)


@pytest.mark.parametrize("fn", ["lattice_decode", "viterbi_decode"])
def test_host_decoders_equal_jax(setup, fn):
    for u in setup["utts"][:3]:
        ll = setup["lls"][u]
        kw = dict(acoustic_scale=SCALE, beam=14.0, max_active=60)
        if fn == "lattice_decode":
            kw["lattice_beam"] = 7.0
        got = getattr(tdecoder, fn)(setup["g"], ll, **kw)
        want = getattr(jdecoder, fn)(setup["jg"], ll, **kw)
        _equal(got, want)


@pytest.mark.parametrize("n,out_len,density", [
    (50, 64, 0.3), (300, 64, 0.5), (300, 64, 0.0), (200, 200, 1.0),
    (1000, 128, 0.05)])
def test_compact_equals_jax(n, out_len, density):
    """Records, order and TRUE counts; some rows count more than out_len."""
    rng = np.random.default_rng(n + out_len)
    B = 3
    mask = rng.random((B, n)) < density
    arrays = [rng.integers(0, 10_000, (B, n)) for _ in range(3)]
    rec, cnt = T.TopKDecoder._compact(
        torch.as_tensor(mask), tuple(torch.as_tensor(a) for a in arrays),
        out_len)
    assert rec.shape == (B, 3, out_len)
    for b in range(B):
        *want, want_cnt = jax.device_get(TpuTopKDecoder._compact(
            jnp.asarray(mask[b]),
            tuple(jnp.asarray(a[b], jnp.int32) for a in arrays), out_len))
        assert int(cnt[b]) == int(want_cnt) == int(mask[b].sum())
        np.testing.assert_array_equal(rec[b].numpy(), np.stack(want))


def _decoders(setup, **kw):
    return (T.TopKDecoder(setup["g"], device="cpu", **kw),
            TpuTopKDecoder(setup["jg"], **kw))


@pytest.mark.parametrize("kind", ["digits", "eps_exit", "big"])
def test_raw_lattices_equal_jax_arc_for_arc(setup, kind):
    """K covers every state: the same tokens, records in the same order,
    hence the same pruned raw lattices, arc for arc.  ``eps_exit`` takes
    the eps in-hub records (eps depth 2), ``big`` the emit hub arcs (an
    emit degree cap of 1) and the eps hub arcs (tests/test_torch_decoder.py's
    graphs)."""
    if kind == "digits":
        g, jg, scale = setup["g"], setup["jg"], SCALE
        lls = [setup["lls"][u] for u in setup["utts"][:4]]
    else:
        if kind == "eps_exit":
            g, P = _eps_exit_graph(), 16
        else:
            g, P = make_big_graph(num_words=60, num_pdfs=32, min_len=3,
                                  max_len=5, seed=3), 32
        jg, scale = g, 1.0
        lls = [sample_loglikes(g, P, T=25, seed=s) for s in (0, 1)]
    kw = dict(beam=14.0, max_active=g.num_states + 32, acoustic_scale=scale,
              lattice_beam=7.0, lattice_arcs_per_frame=2048,
              max_emit_deg=1 if kind == "big" else 16)
    tdec = T.TopKDecoder(g, device="cpu", **kw)
    jdec = TpuTopKDecoder(jg, **kw)
    if kind == "eps_exit":
        assert tdec.Hni > 0 and tdec.eps_iters == 2
    elif kind == "big":
        assert tdec.He > 0 and tdec.Hn > 0
    got = tdec.decode_batch_lattice(lls, determinize=False)
    want = jdec.decode_batch_lattice(lls, determinize=False)
    assert tdec.last_overflow == jdec.last_overflow == (0, 0)
    for a, b in zip(got, want):
        assert a.num_arcs > 0
        assert_lattices_equal(a, b)


@pytest.fixture(scope="module")
def determinized(setup):
    """Determinized lattices of 4 utterances from both packages, with K
    covering every state and with K = 48 (fewer than the states)."""
    lls = [setup["lls"][u] for u in setup["utts"][:4]]
    out = {}
    for ma in ("all", 48):
        tdec, jdec = _decoders(
            setup, beam=14.0, acoustic_scale=SCALE, lattice_beam=7.0,
            lattice_arcs_per_frame=2048,
            max_active=setup["g"].num_states + 32 if ma == "all" else ma)
        out[ma] = (tdec.decode_batch_lattice(lls),
                   jdec.decode_batch_lattice(lls))
    return out


@pytest.mark.parametrize("max_active", ["all", 48])
@pytest.mark.parametrize("scale", [0.08, 0.1, 0.12])
def test_determinized_one_best_equals_jax(determinized, max_active, scale):
    for a, b in zip(*determinized[max_active]):
        _, w, c = tlat.shortest_path(a, acoustic_scale=scale)
        _, wj, cj = jlat.shortest_path(b, acoustic_scale=scale)
        assert list(w) == list(wj)
        assert c == pytest.approx(cj, rel=COST_REL, abs=COST_ABS)


def test_determinized_lattices_equal_jax_where_k_covers(determinized):
    for a, b in zip(*determinized["all"]):
        assert_lattices_equal(a, b)


def test_overflow_reported_and_autogrown_like_jax(setup, caplog):
    """A record buffer of 8 overflows: the same (dropped, frames) as JAX's
    and a warning; auto-grow reaches (0, 0) at JAX's capacity."""
    ll = [setup["lls"][setup["utts"][0]]]
    kw = dict(beam=1e4, max_active=setup["g"].num_states + 32,
              acoustic_scale=SCALE, lattice_beam=1e4)
    tdec, jdec = _decoders(setup, lattice_arcs_per_frame=8, **kw)
    with caplog.at_level(logging.WARNING):
        small = tdec.decode_batch_lattice(ll, determinize=False,
                                          auto_grow=False)
    jdec.decode_batch_lattice(ll, determinize=False, auto_grow=False)
    assert tdec.last_overflow == jdec.last_overflow
    assert tdec.last_overflow[0] > 0 and tdec.last_overflow[1] > 0
    assert any("overflow" in r.getMessage() and
               r.name == T.__name__ for r in caplog.records)
    tdec, jdec = _decoders(setup, lattice_arcs_per_frame=8, **kw)
    grown = tdec.decode_batch_lattice(ll, determinize=False, max_grow=12)
    want = jdec.decode_batch_lattice(ll, determinize=False, max_grow=12)
    assert tdec.last_overflow == jdec.last_overflow == (0, 0)
    assert tdec.A_lat == jdec.A_lat > 8
    assert grown[0].num_arcs >= small[0].num_arcs
    assert_lattices_equal(grown[0], want[0])


def test_derive_lattice_arcs(setup):
    for k in (1, 163, 1024, 1025, 2000, 7000):
        assert (T.TopKDecoder._derive_lattice_arcs(k)
                == TpuTopKDecoder._derive_lattice_arcs(k))
    assert T.TopKDecoder._derive_lattice_arcs(163) == 2048
    dec = T.TopKDecoder(setup["g"], beam=16.0, max_active=200,
                        acoustic_scale=SCALE, lattice_arcs_per_frame=None,
                        device="cpu")
    assert dec.A_lat == T.TopKDecoder._derive_lattice_arcs(dec.K)
    lats = dec.decode_batch_lattice(
        [setup["lls"][u] for u in setup["utts"][:2]], determinize=False)
    assert dec.last_overflow == (0, 0)
    assert all(lat.num_arcs > 0 for lat in lats)
    assert T.TopKDecoder(setup["g"], device="cpu").A_lat == 0
    with pytest.raises(ValueError, match="lattice_arcs_per_frame"):
        T.TopKDecoder(setup["g"], device="cpu").decode_batch_lattice(
            [setup["lls"][setup["utts"][0]]])


@pytest.fixture(scope="module")
def utterance_lattices(setup):
    """decode_utterances in batches of 4 and buckets of 32 frames, both
    packages, of the first quarter of each of the 6 utterances (21-52
    frames: two buckets of three, each batch padded with a repeat)."""
    lls = {u: ll[:len(ll) // 4] for u, ll in setup["lls"].items()}
    kw = dict(acoustic_scale=SCALE, beam=14.0, lattice_beam=7.0,
              max_active=setup["g"].num_states + 32,
              lattice_arcs_per_frame=2048, batch_size=4, bucket_frames=32)
    return (lls, T.decode_utterances(setup["g"], lls, device="cpu", **kw),
            j_decode_utterances(setup["jg"], lls, **kw))


def test_decode_utterances_equal_jax(setup, utterance_lattices):
    lls, got, want = utterance_lattices
    assert sorted(got) == sorted(want) == sorted(setup["utts"])
    buckets = [-(-len(ll) // 32) for ll in lls.values()]
    assert len(set(buckets)) > 1 and max(map(buckets.count, buckets)) < 4
    for u in want:
        assert_lattices_equal(got[u], want[u])


def test_score_sweep_equals_jax(setup, utterance_lattices):
    _, got, want = utterance_lattices
    wt = setup["lang"].word_table
    wer, pt, res = trm.score_sweep(got, setup["refs"], wt)
    j_wer, j_pt, j_res = jrm.score_sweep(want, setup["refs"], wt)
    assert (wer, pt) == (j_wer, j_pt)
    assert res == j_res


NUM_BINS = 12
CFG = dict(in_t=11, in_f=NUM_BINS, in_c=3, filt_t=4, filt_f=5,
           num_filters=8, pool_t=2, pool_f=2, pool_c=1,
           num_hidden_layers=1, pnorm_input_dim=64, pnorm_output_dim=16)


def test_decode_and_score_matches_jax_chain():
    """wsj.decode_and_score at dither 0 against the JAX chain on the same
    weights: volumes -> loglikes_batch -> decode_utterances -> score_sweep
    on dev -> shortest_path at the point on test -> wer_details."""
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 4, 1, 1, seed=37)
    dev, test = corpus.split(0.5)
    lang = Lang.create(lex)
    fst = make_hclg_from_arpa(lang, make_unigram_arpa(wp))
    t2p = lang.trans_model.trans_id_to_pdf_array()
    P = lang.trans_model.num_pdfs
    jo = JF.FbankOptions()
    jo.frame_opts.samp_freq = float(corpus.sample_rate)
    jo.frame_opts.dither = 0.0
    jo.mel_opts.num_bins = NUM_BINS
    jvol = {}
    for u, f in JFE("fbank", jo, device="cpu").extract_corpus(
            corpus.waves).items():
        d = np.asarray(JF.compute_deltas(jnp.asarray(f), 2, 2))
        jvol[u] = d.reshape(len(d), 3, NUM_BINS).transpose(0, 2, 1)
    jnet = j_make_convnet(JCfg(num_pdfs=P, **CFG))
    p = [dict(d) for d in jax.device_get(jnet.init(jax.random.PRNGKey(2)))]
    p[-2]["w"] = (np.random.default_rng(2).normal(size=p[-2]["w"].shape)
                  / np.sqrt(p[-2]["w"].shape[1])).astype(np.float32)
    jam = JAmNnet(jnet, P)
    # the decoder decode_utterances would make, shared by dev and test
    # so that its jit cache compiles once
    jdec = TpuTopKDecoder(JGraph(fst, t2p), beam=60.0, max_active=2000,
                          acoustic_scale=0.1, lattice_beam=8.0,
                          lattice_arcs_per_frame=None)

    def j_lattices(c):
        lls = jam.loglikes_batch(p, {u: j_splice(jvol[u], 5, 5)
                                     for u in c.waves})
        return j_decode_utterances(jdec.g0, lls, decoder=jdec)

    wt = lang.word_table
    j_dev_wer, j_pt, _ = jrm.score_sweep(j_lattices(dev), dev.transcripts,
                                         wt)
    j_hyps = {u: [wt.sym(int(w)) for w in jlat.shortest_path(
        lat, 1.0, j_pt[0], j_pt[1])[1]]
        for u, lat in j_lattices(test).items()}
    want = j_wer_details(test.transcripts, j_hyps)

    am = AmNnet(make_convnet(ConvnetConfig(num_pdfs=P, **CFG),
                             device="cpu"), P)
    params_from_jax(am, p, priors=jam.priors)
    vol = wsj.compute_fbank_volumes(corpus, NUM_BINS, device="cpu",
                                    dither=0.0)
    res = wsj.decode_and_score(am, dev, test, CompiledGraph(fst, t2p), wt,
                               volumes=vol)
    assert res["hyps"] == j_hyps
    assert (res["dev_wer"], res["point"]) == (j_dev_wer, j_pt)
    for k in want:
        assert res[k] == want[k], k
    assert sorted(res["lattices"]) == sorted(corpus.waves)
