"""The port's whole WSJ recipe on the CPU: ``wsj.run(device="cpu")`` at a
small size with the matched DNN and the sign test, resuming from a
stage, stage artifacts that hold no torch objects, and the dither seeds
of the dev and test volumes in ``wsj.decode_and_score``."""

import os
import pickle

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu_torch.core.stages import auto_stage
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig, make_convnet
from kaldi_cnn_tpu_torch.models.nnet import AmNnet
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj

# the JAX package's test_wsj_stage_resume configuration
RUN = dict(num_utts=18, nnet_epochs=2, num_filters=8, seed=67,
           noise_std=0.0, formant_jitter=0.0, device="cpu")
STAGES = ["mfcc", "gmm_bootstrap", "fbank", "egs", "nnet_train",
          "dnn_train"]
KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
        "per_utt", "dev_wer", "valid_logprob", "train_audio_ss", "dnn_wer",
        "dnn_dev_wer", "dnn_errors", "dnn_valid_logprob", "cnn_better_utts",
        "dnn_better_utts", "cnn_vs_dnn_p"}


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """wsj.run with the DNN and an exp dir.  The host lattice decoder
    stands in for the batched search, whose CPU frame loop takes ~15 s a
    model here; test_torch_lattice.py holds decode_and_score's batched
    path against the JAX package, and chip_smoke.py runs it in wsj.run
    on the card."""
    exp = str(tmp_path_factory.mktemp("wsj") / "exp")
    res = wsj.run(exp_dir=exp, eval_dnn=True, batched_decode=False, **RUN)
    return exp, res


def test_run_completes_with_the_result_keys(full_run):
    _, res = full_run
    assert KEYS <= set(res)
    assert res["words"] > 0 and res["missing_utts"] == 0
    for k in ("wer", "dev_wer", "dnn_wer", "dnn_dev_wer"):
        assert 0.0 <= res[k] <= 100.0, k
    for k in ("valid_logprob", "dnn_valid_logprob"):
        assert np.isfinite(res[k]) and res[k] < 0, k
    assert res["train_audio_ss"] > 0 and res["decode_rtf"] > 0
    assert 0.0 <= res["cnn_vs_dnn_p"] <= 1.0
    assert (res["cnn_better_utts"] + res["dnn_better_utts"]
            <= len(res["per_utt"]))
    # the triphone tree of the bootstrap, not the monophone graph
    assert res["tree_leaves"] > 60 and res["graph_states"] > 163
    assert set(res["seconds"]) == set(STAGES) | {"decode", "dnn_decode"}


def test_stage_artifacts_hold_host_numpy_only(full_run):
    """Each stage's pickle loads without torch objects in it, so a resumed
    run can put it on whatever device it is given."""
    exp, _ = full_run
    names = sorted(f for f in os.listdir(exp) if f.endswith(".pkl"))
    assert names == [f"stage{i:02d}_{n}.pkl" for i, n in enumerate(STAGES)]

    def walk(x):
        assert not isinstance(x, (torch.Tensor, torch.nn.Module)), type(x)
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            walk(vars(x))

    for n in names:
        with open(os.path.join(exp, n), "rb") as f:
            walk(pickle.load(f))
    with open(os.path.join(exp, "stage04_nnet_train.pkl"), "rb") as f:
        params = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for p in params for v in p.values())


def test_run_resumes_after_the_bootstrap(tmp_path):
    """The JAX package's test_wsj_stage_resume: a run dies after the GMM
    bootstrap; re-run with stage=auto_stage, the completed stages load
    (their artifacts are not rewritten) and the WER is the uninterrupted
    run's."""
    exp = str(tmp_path / "exp")
    kw = dict(RUN, exp_dir=exp, batched_decode=False)
    res_full = wsj.run(**kw)
    keep = {f for f in os.listdir(exp) if f.startswith(("stage00",
                                                        "stage01"))}
    assert len(keep) == 2
    for f in os.listdir(exp):
        if f.startswith("stage") and f not in keep:
            os.remove(os.path.join(exp, f))
    mtimes = {f: os.path.getmtime(os.path.join(exp, f)) for f in keep}
    assert auto_stage(exp) == 2
    res2 = wsj.run(**kw, stage=auto_stage(exp))
    for f in keep:
        assert os.path.getmtime(os.path.join(exp, f)) == mtimes[f]
    assert res2["wer"] == res_full["wer"]
    assert res2["valid_logprob"] == res_full["valid_logprob"]
    assert "mfcc" in res2["seconds"] and auto_stage(exp) == 5


def test_eval_utts_with_a_given_corpus_raises():
    """The reference ignores eval_utts when a corpus is passed; the port
    refuses the combination."""
    lex = synthetic.digits_lexicon()
    corpus = synthetic.make_noisy_corpus(
        lex, {w: 0.1 for w in lex.entries}, 4, 1, 1, seed=3)
    with pytest.raises(ValueError, match="eval_utts"):
        wsj.run(corpus=corpus, eval_utts=10, device="cpu")


class _Stop(Exception):
    pass


def test_make_corpus_and_split_are_the_reference_run_s():
    """wsj.make_corpus and wsj.split_corpus against the corpus the JAX
    package's run draws when none is given (digit strings of 2-5 words at
    uniform word probabilities, noise 250, formant jitter 0.08) and its
    20 % test, then 15 % dev split."""
    from kaldi_cnn_tpu.recipes import synthetic as jsyn
    lex = jsyn.digits_lexicon()
    want = jsyn.make_noisy_corpus(
        lex, {w: 1.0 / len(lex.entries) for w in lex.entries}, 20, 2, 5, 41,
        noise_std=250.0, formant_jitter=0.08)
    got = wsj.make_corpus(20, 41)
    assert got.word_probs == want.word_probs
    assert got.transcripts == want.transcripts
    for u in want.waves:
        np.testing.assert_array_equal(got.waves[u], want.waves[u])
    traindev, test = want.split(0.2)
    train, dev = traindev.split(0.15)
    for g, w in zip(wsj.split_corpus(got), (train, dev, test)):
        assert sorted(g.waves) == sorted(w.waves)


def test_run_draws_make_corpus_and_splits_it(monkeypatch):
    """Without a corpus, run trains on split_corpus(make_corpus(...))'s
    train part, so that a caller can rebuild run's test split."""
    seen = {}

    def stop(train, seed, device):
        seen["train"] = sorted(train.waves)
        raise _Stop
    monkeypatch.setattr(wsj, "compute_features", stop)
    with pytest.raises(_Stop):
        wsj.run(num_utts=20, seed=41, device="cpu")
    assert seen["train"] == sorted(
        wsj.split_corpus(wsj.make_corpus(20, 41))[0].waves)


def test_decode_and_score_dithers_dev_and_test_apart(monkeypatch):
    """Without volumes, decode_and_score computes the dev volumes at
    seed + 1 and the test volumes at seed + 2, as run does: a dev and a
    test utterance with the same samples get different noise."""
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 2, 1, 1, seed=37)
    dev, test = corpus.split(0.5)
    # the same samples under the test utterance's name
    (d,), (t,) = dev.waves, test.waves
    twin = synthetic.SyntheticCorpus(lex, wp, {t: dev.waves[d]},
                                     {t: dev.transcripts[d]},
                                     corpus.sample_rate)
    lang = Lang.create(lex)
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())
    am = AmNnet(make_convnet(ConvnetConfig(
        in_f=12, filt_f=5, num_filters=4, pool_f=2, num_hidden_layers=1,
        pnorm_input_dim=16, pnorm_output_dim=4,
        num_pdfs=lang.trans_model.num_pdfs), device="cpu"))
    seen = []

    def spy(am_, vols, *a, **k):
        seen.append(vols)
        if len(seen) == 2:
            raise _Stop
        return {}

    monkeypatch.setattr(wsj, "nnet_decode", spy)
    with pytest.raises(_Stop):
        wsj.decode_and_score(am, dev, twin, hclg, lang.word_table, seed=5)
    want_dev = wsj.compute_fbank_volumes(dev, seed=6, device="cpu")
    want_test = wsj.compute_fbank_volumes(twin, seed=7, device="cpu")
    for got, want in zip(seen, (want_dev, want_test)):
        assert sorted(got) == sorted(want)
        for u in want:
            np.testing.assert_array_equal(got[u], want[u])
    assert np.abs(seen[0][d] - seen[1][t]).max() > 0
