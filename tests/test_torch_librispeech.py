"""The port's Librispeech-style recipe (``recipes/librispeech.py``) on
the CPU: the JAX smoke test's tiny run at world size 1.  The bootstrap
against the JAX package's is in ``test_torch_librispeech_bootstrap.py``,
the run over two ranks in ``test_torch_ranks.py``."""

import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
from kaldi_cnn_tpu_torch.recipes import librispeech
from test_torch_ranks import one_batch

# the JAX recipe's result keys (kaldi_cnn_tpu/recipes/librispeech.py)
JAX_KEYS = {"wer", "errors", "words", "sub", "ins", "del", "missing_utts",
            "per_utt", "dev_wer", "train_audio_ss", "num_devices"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """librispeech.run with the JAX smoke test's arguments
    (tests/test_recipes_smoke.py:27-33) on the CPU; records the
    bootstrap's calls."""
    calls = []
    bootstrap = librispeech.bootstrap

    def recorded(mfcc, transcripts, lang):
        out = bootstrap(mfcc, transcripts, lang)
        calls.append((mfcc, transcripts, out))
        return out

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    librispeech.bootstrap = recorded
    librispeech.decode_utterances = one_batch
    try:
        with threadpool_limits(1):
            res = librispeech.run(num_utts=36, nnet_epochs=5,
                                  num_filters=16, average_every=8, seed=71,
                                  device="cpu")
    finally:
        librispeech.bootstrap = bootstrap
        librispeech.decode_utterances = decode_utterances
        torch.set_num_threads(n)
    return res, calls


def test_tiny_recipe_at_world_size_one(tiny):
    res, calls = tiny
    assert JAX_KEYS <= set(res)
    assert res["words"] > 10 and 0.0 <= res["wer"] <= 100.0
    assert res["missing_utts"] == 0
    assert (res["num_devices"], res["backend"]) == (1, "gloo")
    assert len(calls) == 1
    assert res["tree_leaves"] == calls[0][2][2].trans_model.num_pdfs
    assert set(res["seconds"]) == {"gmm_bootstrap", "fbank", "egs_store",
                                   "nnet_train", "decode_dev",
                                   "decode_test"}
    assert not dist.is_initialized()       # the group it started is gone
