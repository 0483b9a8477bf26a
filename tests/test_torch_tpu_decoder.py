"""The port's dense Viterbi search (``DenseViterbiDecoder``) against the
JAX package's ``TpuViterbiDecoder`` on the same loglikes: the mono-GMM
fixture of ``tests/test_tpu_decoder.py``, the port on the CPU (the
frame function eagerly; the card replays it as CUDA graphs,
``tests/test_torch_cuda.py``)."""

import copy

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.decode.tpu_decoder import TpuViterbiDecoder
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.tpu_decoder import (DenseViterbiDecoder,
                                                    _eps_depth)
from tests.test_tpu_decoder import setup  # noqa: F401  (the fixture)

SCALE = 0.1


def port_graph(jg) -> CompiledGraph:
    g = CompiledGraph.__new__(CompiledGraph)
    g.__dict__.update(copy.deepcopy(jg.__dict__))
    return g


def assert_same(port, jax_res):
    assert len(port) == len(jax_res)
    for (tids, words, cost), (jt, jw, jc) in zip(port, jax_res):
        np.testing.assert_array_equal(tids, jt)
        assert list(words) == list(jw)
        assert cost == pytest.approx(jc, rel=1e-5, abs=1e-2)


@pytest.fixture(scope="module")
def pair(setup):  # noqa: F811
    hclg, lls = setup
    torch.set_num_threads(2)
    return hclg, port_graph(hclg), lls


@pytest.mark.parametrize("beam,max_active", [(1e9, 0), (200.0, 0),
                                             (1e9, "quarter")])
def test_dense_search_matches_jax(pair, beam, max_active):
    """Same tids and words, cost within rel 1e-5 / abs 1e-2, at beam 1e9,
    beam 200 and max_active = S // 4."""
    jg, g, lls = pair
    if max_active == "quarter":
        max_active = g.num_states // 4
    jax_res = TpuViterbiDecoder(jg, beam=beam, max_active=max_active,
                                acoustic_scale=SCALE).decode_batch(lls)
    dec = DenseViterbiDecoder(g, beam=beam, max_active=max_active,
                              acoustic_scale=SCALE, device="cpu")
    assert dec.eps_iters == _eps_depth(g) > 0
    assert dec.max_active == max_active
    assert_same(dec.decode_batch(lls), jax_res)


def test_batched_equals_solo(pair):
    _, g, lls = pair
    dec = DenseViterbiDecoder(g, beam=1e9, acoustic_scale=SCALE,
                              device="cpu")
    batched = dec.decode_batch(lls[:5])
    for ll, (tids, words, cost) in zip(lls[:5], batched):
        st, sw, sc = dec.decode_batch([ll])[0]
        np.testing.assert_array_equal(tids, st)
        assert list(words) == list(sw)
        assert cost == sc


def test_unreachable_final_states_take_the_fallback(pair):
    """With every final weight infinite, both packages end in the best
    state at the last frame, whatever its final weight."""
    jg, g, lls = pair
    jg2 = copy.copy(jg)
    jg2.final = np.full_like(jg.final, np.inf)
    g2 = port_graph(jg2)
    jax_res = TpuViterbiDecoder(jg2, beam=1e9,
                                acoustic_scale=SCALE).decode_batch(lls[:3])
    port = DenseViterbiDecoder(g2, beam=1e9, acoustic_scale=SCALE,
                               device="cpu").decode_batch(lls[:3])
    assert_same(port, jax_res)
    normal = DenseViterbiDecoder(g, beam=1e9, acoustic_scale=SCALE,
                                 device="cpu").decode_batch(lls[:3])
    assert any(p[2] != n[2] for p, n in zip(port, normal))


def test_backtrace_guard_raises_on_a_pruned_state(pair):
    _, g, lls = pair
    dec = DenseViterbiDecoder(g, beam=1e9, acoustic_scale=SCALE,
                              device="cpu")
    frame = dec._frame

    def broken(cost, am_row, active):
        c, e, n = frame(cost, am_row, active)
        return c, torch.full_like(e, -1), n
    dec._frame = broken
    with pytest.raises(RuntimeError, match="pruned state"):
        dec.decode_batch(lls[:1])
