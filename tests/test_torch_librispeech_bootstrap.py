"""The Librispeech recipe's GMM bootstrap: the port's
(``librispeech.bootstrap``, run on the whole training set) against the
JAX recipe's ``_bootstrap`` on the same MFCC, and the JAX recipe's
per-process bootstrap on each process's utterance shard, which gives
each process its own tree (ROADMAP 3.15, the fault the port does not
copy)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kaldi_cnn_tpu.gmm.train import (DeltasTrainOptions as JDeltas,
                                     MonoTrainOptions as JMono,
                                     train_deltas as j_train_deltas,
                                     train_mono as j_train_mono)
from kaldi_cnn_tpu.lang.hclg import Lang as JLang
from kaldi_cnn_tpu.parallel import multihost as jmh
from kaldi_cnn_tpu.recipes import synthetic as jsyn
from kaldi_cnn_tpu_torch.lang.hclg import Lang
from kaldi_cnn_tpu_torch.recipes import librispeech
from kaldi_cnn_tpu_torch.recipes.yesno import compute_features
from test_torch_lang import load_jax_native

NUM_UTTS, SEED = 24, 71


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch and one BLAS thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mfcc(tmp_path_factory):
    """The port's MFCC of the training set of librispeech.make_corpus
    (and both packages' native libraries loaded, since the tests hold
    the JAX bootstrap's alignments equal to the port's)."""
    load_jax_native(tmp_path_factory)
    train, _, _ = librispeech.make_corpus(NUM_UTTS, SEED)
    return compute_features(train, SEED, "cpu"), train.transcripts


def jax_bootstrap(mfcc, transcripts):
    """The JAX recipe's ``_bootstrap`` (kaldi_cnn_tpu/recipes/
    librispeech.py:103-110) on given MFCC, with a fresh JAX Lang."""
    lang = JLang.create(jsyn.digits_lexicon())
    _, ali0 = j_train_mono(mfcc, transcripts, lang,
                           JMono(num_iters=18, totgauss=300))
    return j_train_deltas(mfcc, transcripts, lang, ali0, lang.trans_model,
                          JDeltas(num_iters=12, totgauss=800,
                                  max_leaves=300))


def test_bootstrap_matches_jax_on_the_same_mfcc(mfcc):
    """Same MFCC, same tree: num_pdfs, the transition-id -> pdf map and
    the alignments equal the JAX bootstrap's."""
    feats, transcripts = mfcc
    _, ali, tri = librispeech.bootstrap(
        feats, transcripts, Lang.create(librispeech.synthetic.digits_lexicon()))
    _, jali, jtri = jax_bootstrap(feats, transcripts)
    assert tri.trans_model.num_pdfs == jtri.trans_model.num_pdfs
    np.testing.assert_array_equal(tri.trans_model.trans_id_to_pdf_array(),
                                  jtri.trans_model.trans_id_to_pdf_array())
    assert sorted(ali) == sorted(jali)
    for u in ali:
        np.testing.assert_array_equal(ali[u], jali[u])


def test_jax_per_shard_bootstrap_gives_two_trees(mfcc):
    """The JAX recipe run as two processes: each bootstraps on its own
    utterance shard and gets its own tree, a different num_pdfs or a
    different transition-id -> pdf map, so their nets' output layers
    could not be averaged (ROADMAP 3.15)."""
    feats, transcripts = mfcc
    trees = []
    for pid in range(2):
        utts = jmh.shard_utterances(
            list(feats), jmh.MultihostConfig(num_processes=2,
                                             process_id=pid))
        _, _, tri = jax_bootstrap({u: feats[u] for u in utts},
                                  {u: transcripts[u] for u in utts})
        trees.append((tri.trans_model.num_pdfs,
                      tri.trans_model.trans_id_to_pdf_array()))
    (n0, t0), (n1, t1) = trees
    assert n0 != n1 or not np.array_equal(t0, t1)
