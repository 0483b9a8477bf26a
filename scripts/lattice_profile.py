#!/usr/bin/env python3
"""Where the lattice decode's time goes on the card.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 scripts/lattice_profile.py

It builds the inputs of ``chip_smoke.py``'s lattice phase (the 16
synthetic utterances, the digits HCLG, the recipe-width CNN with seeded
random weights), scores them on the card, and then, with
``torch.profiler`` (CPU and CUDA activities):

1. the frame loop of one 16-utterance batch (``TopKDecoder._decode``):
   the lattice variant against the best-path variant on the same
   acoustics, padded to the longest utterance (298 frames): wall
   seconds of an unprofiled run, device seconds (the CUDA kernels' time
   in a profiled run), the idle share (1 - device / wall), kernel
   launches a frame, and the kernels that take most device time;
2. ``decode_utterances`` of the dev and test halves, as
   ``wsj.decode_and_score`` calls it: wall and device seconds and the
   idle share (the host's assembly, pruning and determinization
   included).

Prints the card's name and power limit first.  Needs the CUDA build of
PyTorch and nvcc (the scoring runs the port's kernels).  It takes about
ten minutes on an H100: the profiler's own bookkeeping of ~500,000
kernel launches dominates.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph  # noqa: E402
from kaldi_cnn_tpu_torch.decode.topk_decoder import (  # noqa: E402
    TopKDecoder, decode_utterances)
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa  # noqa: E402
from kaldi_cnn_tpu_torch.lang.hclg import (Lang,  # noqa: E402
                                           make_hclg_from_arpa)
from kaldi_cnn_tpu_torch.recipes import synthetic, wsj  # noqa: E402


def profiled(fn):
    """(result, wall s unprofiled, device s, kernel launches, top
    kernels) of fn: one run timed by the host clock, one profiled."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return out, wall, dev, launches, [
        (e.key[:60], round(e.self_device_time_total / 1e3, 1), e.count)
        for e in top]


def main() -> int:
    if not torch.cuda.is_available():
        print("lattice_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"gpu: {cs.gpu_line()}", flush=True)
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus = synthetic.make_noisy_corpus(lex, wp, 16, 2, 5, seed=cs.SEED)
    lang = Lang.create(lex)
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())
    am = cs.wsj_model(lang.trans_model.num_pdfs, "cuda")
    vols = wsj.compute_fbank_volumes(corpus, seed=cs.SEED, device="cuda")
    lls = am.loglikes_batch({u: wsj.splice_volume(v, wsj.CONTEXT,
                                                  wsj.CONTEXT)
                             for u, v in vols.items()})
    utts = sorted(lls)
    dec = TopKDecoder(hclg, beam=60.0, max_active=2000,
                      acoustic_scale=wsj.ACOUSTIC_SCALE,
                      lattice_arcs_per_frame=None, device="cuda")
    am_np, _ = dec._pad([lls[u] for u in utts])
    am_dev = torch.as_tensor(am_np, device="cuda")
    T = am_np.shape[1]
    for lattice in (False, True):          # warm both variants
        dec._decode(am_dev, lattice=lattice)
    for name, lattice in (("best path", False), ("lattice", True)):
        _, wall, dev, n, top = profiled(
            lambda: dec._decode(am_dev, lattice=lattice))
        print(f"frame loop, {name}: 16 utterances x {T} frames (K "
              f"{dec.K}, A_lat {dec.A_lat}): wall {wall:.3f} s, device "
              f"{dev:.3f} s, idle {100 * (1 - dev / wall):.1f}%, "
              f"{n / T:.0f} kernel launches a frame; top kernels (name, "
              f"ms, launches): {top}", flush=True)
    kw = dict(acoustic_scale=wsj.ACOUSTIC_SCALE, beam=60.0,
              lattice_beam=8.0, max_active=2000, device="cuda")
    halves = [{u: lls[u] for u in c.waves} for c in corpus.split(0.5)]

    def both():
        out = {}
        for half in halves:
            out.update(decode_utterances(hclg, half, **kw))
        return out

    both()                                  # warm
    lats, wall, dev, n, top = profiled(both)
    print(f"decode_utterances of the dev and test halves (as "
          f"wsj.decode_and_score; buckets of 128 frames, batches of 16): "
          f"wall {wall:.3f} s, device {dev:.3f} s, idle "
          f"{100 * (1 - dev / wall):.1f}%, {n} kernel launches; top "
          f"kernels: {top}", flush=True)
    arcs = np.array([lat.num_arcs for lat in lats.values()])
    print(f"lattice arcs: {arcs.sum()} total, {arcs.max()} largest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
