"""The port's ``recipes/datadir.py`` (a whole-file twin of the JAX
package's) and the recipes' real-data flags, on the CPU: the twin by
source text; ``DataDir`` load / validate / fix / split, segments and a
piped ``wav.scp``, equal to the JAX package's on the same directories;
the lexicon round trip, ``corpus_from_data_dir`` and its lexicon lookup,
``load_alignments_ark`` / ``load_feats_scp`` equal to JAX's; the ``wsj``
and ``yesno`` ``__main__`` flags reaching ``run``; both ``__main__``s
with ``--data-dir`` end to end (wsj's depth cut); and ``wsj.run``'s
``ext_ali_mdl`` (its transition model maps the external ark's ids to
pdfs) and its out-of-range error."""

import json
import os

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.io.kaldi_io import write_ark
from kaldi_cnn_tpu.recipes import datadir as jdd
from kaldi_cnn_tpu_torch.io.kaldi_model import write_gmm_model
from kaldi_cnn_tpu_torch.io.wave import write_wave
from kaldi_cnn_tpu_torch.lang.hclg import Lang
from kaldi_cnn_tpu_torch.recipes import datadir as tdd
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj, yesno

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once,
    and the recipe runs here contend for the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_datadir_twin_is_verbatim():
    with open(os.path.join(ROOT, "kaldi_cnn_tpu_torch/recipes/datadir.py")
              ) as f:
        got = f.read()
    with open(os.path.join(ROOT, "kaldi_cnn_tpu/recipes/datadir.py")) as f:
        want = f.read()
    assert got == want.replace("kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")


def _corpus(n=8, seed=3, lex=None):
    lex = lex or synthetic.yesno_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    return synthetic.make_corpus(lex, wp, n, 1, 2, seed)


def _fields(dd):
    return (dd.wav_scp, dd.text, dd.utt2spk, dd.feats_scp,
            None if dd.segments is None else
            {u: (s.recording, s.start, s.end) for u, s in dd.segments.items()})


def _assert_same_dirs(got, want):
    assert type(got).__module__ == "kaldi_cnn_tpu_torch.recipes.datadir"
    assert got.path == want.path and _fields(got) == _fields(want)
    assert got.utts() == want.utts() and got.spk2utt == want.spk2utt


def _assert_same_waves(got, want):
    (gw, gr), (ww, wr) = got, want
    assert gr == wr and sorted(gw) == sorted(ww)
    for u in ww:
        assert gw[u].dtype == ww[u].dtype
        np.testing.assert_array_equal(gw[u], ww[u])


@pytest.fixture
def speaker_dir(tmp_path):
    corpus = _corpus(n=12)
    utt2spk = {u: f"spk{int(u[3:]) % 4}" for u in corpus.waves}
    dd = tdd.write_data_dir(str(tmp_path), corpus.waves, corpus.transcripts,
                            utt2spk, corpus.sample_rate)
    return str(tmp_path), corpus, dd


def test_write_and_load_match_jax(speaker_dir):
    path, corpus, written = speaker_dir
    got, want = tdd.DataDir.load(path), jdd.DataDir.load(path)
    _assert_same_dirs(got, want)
    assert got.text == written.text == corpus.transcripts
    assert got.validate() == want.validate() == []
    _assert_same_waves(got.load_waves(), want.load_waves())
    for name in ("wav.scp", "text", "utt2spk", "spk2utt"):
        assert os.path.isfile(os.path.join(path, name))


@pytest.mark.parametrize("jobs", [2, 3, 5])
def test_split_matches_jax(speaker_dir, jobs):
    path, _, _ = speaker_dir
    got = tdd.DataDir.load(path).split(jobs)
    want = jdd.DataDir.load(path).split(jobs)
    assert len(got) == len(want) == jobs
    for g, w in zip(got, want):
        _assert_same_dirs(g, w)
    assert sorted(u for g in got for u in g.utts()) == sorted(
        tdd.DataDir.load(path).utts())
    owner = {}
    for j, g in enumerate(got):       # no speaker straddles jobs
        for u in g.utts():
            assert owner.setdefault(g.utt2spk[u], j) == j


@pytest.mark.parametrize("drop", ["text", "utt2spk"])
def test_validate_fix_matches_jax(speaker_dir, drop):
    path, _, _ = speaker_dir
    dirs = tdd.DataDir.load(path), jdd.DataDir.load(path)
    victim = dirs[0].utts()[1]
    for dd in dirs:
        del getattr(dd, drop)[victim]
        dd.text["extra_utt"] = ["yes"]
    issues = [dd.validate(fix=True) for dd in dirs]
    assert issues[0] == issues[1] and len(issues[0]) == 2
    _assert_same_dirs(*dirs)
    assert victim not in dirs[0].utts() and "extra_utt" not in dirs[0].text
    assert dirs[0].validate() == []


def _segment_dirs(tmp_path, missing: bool):
    """One recording of two utterances, read through a ``cat ... |``
    pipe and cut by ``segments``; with ``missing``, a third segment of a
    recording that ``wav.scp`` lacks."""
    corpus = _corpus(n=2)
    utts = sorted(corpus.waves)
    wav = str(tmp_path / "reco1.wav")
    write_wave(wav, np.concatenate([corpus.waves[u] for u in utts]),
               corpus.sample_rate)
    t0 = len(corpus.waves[utts[0]]) / corpus.sample_rate
    segs = {utts[0]: ("reco1", 0.0, t0), utts[1]: ("reco1", t0, -1.0)}
    text = {u: corpus.transcripts[u] for u in utts}
    if missing:
        segs["utt_orphan"] = ("reco_missing", 0.0, -1.0)
        text["utt_orphan"] = ["no"]
    out = []
    for mod in (tdd, jdd):
        out.append(mod.DataDir(
            path=str(tmp_path), wav_scp={"reco1": f"cat {wav} |"},
            text=dict(text), utt2spk={u: "spk0" for u in text},
            segments={u: mod.Segment(*s) for u, s in segs.items()}))
    return out, corpus, utts


def test_segments_and_piped_wav_scp_match_jax(tmp_path):
    (got, want), corpus, utts = _segment_dirs(tmp_path, missing=False)
    assert got.validate() == want.validate() == []
    waves = got.load_waves()
    _assert_same_waves(waves, want.load_waves())
    for u in utts:                        # int16 quantisation on write
        ref = np.round(np.clip(corpus.waves[u], -32768, 32767))
        n = min(len(waves[0][u]), len(ref))
        assert abs(len(waves[0][u]) - len(ref)) <= 1
        np.testing.assert_allclose(waves[0][u][:n], ref[:n], atol=1.0)


def test_fix_drops_segments_of_a_missing_recording_as_jax(tmp_path):
    (got, want), _, utts = _segment_dirs(tmp_path, missing=True)
    issues = got.validate(fix=True)
    assert issues == want.validate(fix=True) and issues
    _assert_same_dirs(got, want)
    assert got.utts() == utts
    _assert_same_waves(got.load_waves(), want.load_waves())


@pytest.mark.parametrize("body", [
    None, "abc 1.0 a b\nabc 0.4 a c\nd 0.9 d\n",
    "ma 1 a\nma 2 a\nba b a\n"], ids=["digits", "lexiconp", "numeric"])
def test_lexicon_round_trip_matches_jax(tmp_path, body):
    path = str(tmp_path / "lexicon.txt")
    if body is None:
        tdd.write_lexicon_file(path, synthetic.digits_lexicon())
    else:
        with open(path, "w") as f:
            f.write(body)
    got, want = tdd.read_lexicon_file(path), jdd.read_lexicon_file(path)
    assert type(got).__module__ == "kaldi_cnn_tpu_torch.lang.lexicon"
    assert got.entries == want.entries and got.phones == want.phones
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tdd.write_lexicon_file(out_t, got)
    jdd.write_lexicon_file(out_j, want)
    with open(out_t) as a, open(out_j) as b:
        assert a.read() == b.read()
    assert tdd.read_lexicon_file(out_t).entries == got.entries


@pytest.mark.parametrize("where", ["inside", "local_dict", "given"])
def test_corpus_from_data_dir_matches_jax(tmp_path, where):
    """The lexicon from ``<dir>/lexicon.txt``, from the reference layout
    ``<dir>/../local/dict/lexicon.txt``, or given."""
    corpus = _corpus(n=6, seed=11)
    data = tmp_path / "data" / "train"
    tdd.write_data_dir(str(data), corpus.waves, corpus.transcripts, None,
                       corpus.sample_rate)
    lex_path = {"inside": data / "lexicon.txt",
                "local_dict": tmp_path / "data" / "local" / "dict"
                / "lexicon.txt",
                "given": tmp_path / "my_lexicon.txt"}[where]
    lex_path.parent.mkdir(parents=True, exist_ok=True)
    tdd.write_lexicon_file(str(lex_path), corpus.lexicon)
    arg = str(lex_path) if where == "given" else None
    got = tdd.corpus_from_data_dir(str(data), arg)
    want = jdd.corpus_from_data_dir(str(data), arg)
    assert type(got).__module__ == "kaldi_cnn_tpu_torch.recipes.synthetic"
    assert got.transcripts == want.transcripts == corpus.transcripts
    assert got.word_probs == want.word_probs
    assert got.lexicon.entries == want.lexicon.entries
    assert got.sample_rate == want.sample_rate == corpus.sample_rate
    _assert_same_waves((got.waves, 0), (want.waves, 0))
    if where != "given":
        os.remove(lex_path)
        with pytest.raises(FileNotFoundError, match="lexicon"):
            tdd.corpus_from_data_dir(str(data))


def test_load_alignments_ark_and_feats_scp_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    ali = {f"u{i}": rng.integers(1, 40, 5 + i).astype(np.int32)
           for i in range(4)}
    feats = {f"u{i}": rng.normal(size=(6 + i, 5)).astype(np.float32)
             for i in range(4)}
    ark, fark, scp = (str(tmp_path / n) for n in ("ali.ark", "f.ark",
                                                  "f.scp"))
    write_ark(ark, ali)
    write_ark(fark, feats, scp)
    for got, want in ((tdd.load_alignments_ark(ark),
                       jdd.load_alignments_ark(ark)),
                      (tdd.load_feats_scp(scp), jdd.load_feats_scp(scp))):
        assert sorted(got) == sorted(want) == sorted(ali)
        for u in want:
            assert got[u].dtype == want[u].dtype
            np.testing.assert_array_equal(got[u], want[u])


# ---- the recipes' flags ---------------------------------------------------

@pytest.fixture
def digits_dir(tmp_path):
    corpus = _corpus(n=6, seed=13, lex=synthetic.digits_lexicon())
    d = str(tmp_path / "data")
    tdd.write_data_dir(d, corpus.waves, corpus.transcripts, None,
                       corpus.sample_rate)
    lex = str(tmp_path / "lexicon.txt")
    tdd.write_lexicon_file(lex, corpus.lexicon)
    return d, lex, corpus


def _recorded_run(monkeypatch, mod):
    calls = []
    monkeypatch.setattr(mod, "run", lambda **kw: calls.append(kw)
                        or {"wer": 0.0})
    return calls


def test_wsj_main_flags_reach_run(monkeypatch, capsys, tmp_path, digits_dir):
    d, lex, corpus = digits_dir
    ali = {u: np.arange(1, 4, dtype=np.int32) for u in corpus.waves}
    ark = str(tmp_path / "ali.ark")
    write_ark(ark, ali)
    calls = _recorded_run(monkeypatch, wsj)
    assert wsj.main(["--device", "cpu", "--data-dir", d, "--lexicon", lex,
                     "--ali-ark", ark, "--ali-mdl", "final.mdl"]) == 0
    assert wsj.main([]) == 0
    (kw, default) = calls
    assert kw["device"] == "cpu" and kw["ext_ali_mdl"] == "final.mdl"
    assert kw["corpus"].transcripts == corpus.transcripts
    assert sorted(kw["ext_alignments"]) == sorted(ali)
    for u in ali:
        np.testing.assert_array_equal(kw["ext_alignments"][u], ali[u])
    assert (default["device"], default["corpus"], default["ext_alignments"],
            default["ext_ali_mdl"]) == ("cuda", None, None, None)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "wer": 0.0}


def test_yesno_main_flags_reach_run(monkeypatch, digits_dir):
    d, lex, corpus = digits_dir
    calls = _recorded_run(monkeypatch, yesno)
    assert yesno.main(["--device", "cpu", "--data-dir", d, "--lexicon",
                       lex]) == 0
    assert yesno.main([]) == 0
    assert calls[0]["device"] == "cpu"
    assert calls[0]["corpus"].transcripts == corpus.transcripts
    assert calls[1] == {"device": "cuda", "corpus": None}


def test_yesno_runs_from_a_data_dir(tmp_path, capsys):
    """``python -m kaldi_cnn_tpu_torch.recipes.yesno --data-dir D`` on the
    CPU, from a ``write_data_dir`` directory with its lexicon inside."""
    corpus = _corpus(n=24, seed=11)
    d = str(tmp_path / "yesno")
    tdd.write_data_dir(d, corpus.waves, corpus.transcripts, None,
                       corpus.sample_rate)
    tdd.write_lexicon_file(os.path.join(d, "lexicon.txt"), corpus.lexicon)
    rc = yesno.main(["--device", "cpu", "--data-dir", d])
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == (0 if res["wer"] == 0.0 else 1)
    assert res["words"] == sum(len(corpus.transcripts[u]) for u in
                               sorted(corpus.waves)[-6:])
    assert res["wer"] <= 20.0


class _AtEgs(Exception):
    """Raised where ``wsj.run`` makes its egs: the test has seen enough."""


def _run_to_egs(monkeypatch, ext, ali_mdl):
    """``wsj.run`` up to its egs stage with the bootstrap and features
    stubbed (a digits Lang stands in for the triphone tree); returns the
    alignments and tid->pdf map that reached ``make_cnn_egs``."""
    boot = Lang.create(synthetic.digits_lexicon())
    monkeypatch.setattr(wsj, "compute_features", lambda *a, **k: {})
    monkeypatch.setattr(wsj, "train_mono", lambda *a, **k: (None, None))
    monkeypatch.setattr(wsj, "train_deltas",
                        lambda *a, **k: (None, {"boot": None}, boot))
    monkeypatch.setattr(wsj, "compute_fbank_volumes", lambda *a, **k: {})
    seen = {}

    def egs(volumes, alignments, tid2pdf, *a):
        seen.update(ali=alignments, tid2pdf=tid2pdf)
        raise _AtEgs
    monkeypatch.setattr(wsj, "make_cnn_egs", egs)
    with pytest.raises(_AtEgs):
        wsj.run(num_utts=4, device="cpu", ext_alignments=ext,
                ext_ali_mdl=ali_mdl)
    return seen, boot


@pytest.fixture
def yesno_mdl(tmp_path):
    """A GMM .mdl on the yesno Lang's transition model: another tree than
    the digits stand-in's."""
    from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm
    tm = Lang.create(synthetic.yesno_lexicon()).trans_model
    gmms = [DiagGmm(np.ones(1), np.zeros((1, 3)), np.ones((1, 3)))
            for _ in range(tm.num_pdfs)]
    path = str(tmp_path / "ali.mdl")
    write_gmm_model(path, tm, AmDiagGmm(gmms))
    return path, tm


def test_ext_ali_mdl_maps_the_ark_ids(monkeypatch, yesno_mdl):
    path, tm = yesno_mdl
    ext = {"u1": np.asarray([1, 2, 2, tm.num_transition_ids], np.int32)}
    seen, boot = _run_to_egs(monkeypatch, ext, path)
    want = tm.trans_id_to_pdf_array()
    np.testing.assert_array_equal(seen["tid2pdf"], want)
    assert seen["ali"] is ext
    assert len(want) != len(boot.trans_model.trans_id_to_pdf_array())
    # without the .mdl the bootstrap's map is used
    seen, _ = _run_to_egs(monkeypatch, {"u1": ext["u1"][:3]}, None)
    np.testing.assert_array_equal(
        seen["tid2pdf"], boot.trans_model.trans_id_to_pdf_array())


@pytest.mark.parametrize("with_mdl", [True, False])
def test_ext_alignment_out_of_range_raises(monkeypatch, yesno_mdl, with_mdl):
    path, tm = yesno_mdl
    boot_ids = len(Lang.create(
        synthetic.digits_lexicon()).trans_model.trans_id_to_pdf_array())
    top = (tm.num_transition_ids + 1) if with_mdl else boot_ids
    ext = {"u1": np.asarray([1, top], np.int32)}
    with pytest.raises(ValueError, match=("supplied" if with_mdl
                                          else "bootstrap")
                       + ".*--ali-mdl"):
        _run_to_egs(monkeypatch, ext, path if with_mdl else None)


def test_wsj_runs_from_a_data_dir(monkeypatch, capsys, tmp_path):
    """``python -m kaldi_cnn_tpu_torch.recipes.wsj --data-dir D --lexicon
    L`` on the CPU, its depth cut (1 epoch, 8 filters, the host lattice
    decode) by wrapping ``run``."""
    import functools
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_corpus(lex, wp, 12, 1, 3, seed=37)
    d, lpath = str(tmp_path / "wsj"), str(tmp_path / "lexicon.txt")
    tdd.write_data_dir(d, corpus.waves, corpus.transcripts, None,
                       corpus.sample_rate)
    tdd.write_lexicon_file(lpath, lex)
    monkeypatch.setattr(wsj, "run", functools.partial(
        wsj.run, nnet_epochs=1, num_filters=8, batched_decode=False))
    rc = wsj.main(["--device", "cpu", "--data-dir", d, "--lexicon", lpath])
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    test = wsj.split_corpus(corpus)[2]
    assert res["words"] == sum(len(t) for t in test.transcripts.values())
    assert res["missing_utts"] == 0 and 0.0 <= res["wer"]
    assert rc == (0 if res["wer"] < 10.0 else 1)
