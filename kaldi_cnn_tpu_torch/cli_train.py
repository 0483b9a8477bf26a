"""Decoding CLI verbs (twin of a part of ``kaldi_cnn_tpu/cli_train.py``):

  online2-wav-latgen    online2bin/online2-wav-nnet2-latgen-faster.cc

The verb reads a ``wav.scp`` and an nnet2 or GMM ``.mdl``, streams each
waveform in chunks through the online pipeline, and writes one
transcript line an utterance (and, optionally, lattices), so it composes
from the shell like the reference's binary.  It runs on the card unless
``--device=cpu`` is given.  The JAX package's other pipeline verbs are
not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List

import numpy as np


def cmd_online2_wav_latgen(argv: List[str]) -> int:
    """Streaming (online) decode straight from waveforms (ref:
    online2bin/online2-wav-nnet2-latgen-faster.cc): chunked audio ->
    OnlineFeaturePipeline (base features on the fbank kernel + online
    CMVN + deltas) -> chunked pseudo-loglikes -> incremental decode
    carrying token state across chunks (``StreamingDecoder`` by default;
    ``--host-decode`` uses the host incremental Viterbi).  Spliced nnet
    AMs are handled by a StreamingSplicer so results match offline
    decode of the same audio."""
    import torch
    from kaldi_cnn_tpu_torch.core.rng import torch_generator
    from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
    from kaldi_cnn_tpu_torch.features import functional as F
    from kaldi_cnn_tpu_torch.io.wave import read_wave
    from kaldi_cnn_tpu_torch.lang.fst import Fst
    from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable
    from kaldi_cnn_tpu_torch.online2 import (
        OnlineCmvn, OnlineFeaturePipeline, OnlineRecognizer,
        SingleUtteranceDecoder, StreamingSplicer)
    from kaldi_cnn_tpu_torch.recipes.datadir import read_key_value_file

    def load_wave(spec):
        spec = spec.strip()
        if spec.endswith("|"):      # extended rxfilename pipe
            import subprocess
            import tempfile
            data = subprocess.run(spec[:-1], shell=True, check=True,
                                  stdout=subprocess.PIPE).stdout
            with tempfile.NamedTemporaryFile(suffix=".wav") as tf:
                tf.write(data)
                tf.flush()
                samples, rate = read_wave(tf.name)
        else:
            samples, rate = read_wave(spec)
        return samples[0], rate

    p = argparse.ArgumentParser(prog="online2-wav-latgen")
    p.add_argument("--feature-type", default="mfcc",
                   choices=["mfcc", "fbank"])
    p.add_argument("--deltas-order", type=int, default=2)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-active", type=int, default=7000)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--chunk-seconds", type=float, default=0.2,
                   help="audio chunk size fed to the recognizer")
    p.add_argument("--dither", type=float, default=0.0)
    p.add_argument("--no-online-cmvn", action="store_true",
                   help="disable causal CMVN (for models trained on "
                        "un-normalized features)")
    p.add_argument("--host-decode", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where features, the acoustic model and the "
                        "search run")
    p.add_argument("--lattice-wspecifier", default=None,
                   help="also write lattices (npz): the accumulated "
                        "per-utterance loglikes are re-decoded through "
                        "the lattice path after streaming best-path "
                        "decode (ref: online2-wav-nnet2-latgen-faster "
                        "writes CompactLattices)")
    p.add_argument("--lattice-beam", type=float, default=8.0)
    p.add_argument("--lang-dir", required=True)
    p.add_argument("mdl")
    p.add_argument("graph_fst")
    p.add_argument("wav_scp")
    p.add_argument("out_text")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    torch.zeros(1, device=device)      # no card: raise before any work

    words = SymbolTable.read(os.path.join(args.lang_dir, "words.txt"))
    tm, scorer, model_dim = _load_am(args.mdl, device)
    with open(args.graph_fst) as f:
        hclg = Fst.read_text(f)
    graph = CompiledGraph(hclg, tm.trans_id_to_pdf_array())

    if args.feature_type == "mfcc":
        opts = F.MfccOptions()
        base_dim = opts.num_ceps
    else:
        opts = F.FbankOptions()
        base_dim = opts.mel_opts.num_bins
    opts.frame_opts.dither = args.dither
    feat_dim = base_dim * (args.deltas_order + 1)
    context = 0
    if model_dim != feat_dim:
        if model_dim % feat_dim == 0 and (model_dim // feat_dim) % 2:
            context = (model_dim // feat_dim - 1) // 2
        else:
            print(f"online2-wav-latgen: model input dim {model_dim} is "
                  f"not an odd multiple of the feature dim {feat_dim}",
                  file=sys.stderr)
            return 2

    stream_dec = None
    if not args.host_decode:
        from kaldi_cnn_tpu_torch.decode.topk_decoder import (
            StreamingDecoder, TopKDecoder)
        top_k = TopKDecoder(
            graph, beam=args.beam,
            max_active=args.max_active or graph.num_states,
            acoustic_scale=args.acoustic_scale, device=device)
        # ONE streaming decoder for the whole run: its block graphs are
        # captured once; reset() clears token state between utterances
        stream_dec = StreamingDecoder(top_k)

    scp = read_key_value_file(args.wav_scp)
    n_frames = 0
    utt_lls: Dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    with open(args.out_text, "w") as out:
        for i, utt in enumerate(sorted(scp)):
            wave, rate = load_wave(scp[utt])
            opts.frame_opts.samp_freq = rate   # like compute-*-feats:
            #                                    the file's actual rate
            cmvn = None
            if args.no_online_cmvn:
                cmvn = OnlineCmvn()
                cmvn.freeze(np.zeros(base_dim, np.float32))
            pipe = OnlineFeaturePipeline(
                args.feature_type, opts, cmvn=cmvn,
                deltas_order=args.deltas_order, device=device,
                # --dither draws utterance i's noise from its own stage
                generator=torch_generator(0, "online_dither", i))
            fn = (StreamingSplicer(scorer, context, context)
                  if context else scorer)
            if stream_dec is not None:
                stream_dec.reset()
                dec = stream_dec
            else:
                dec = SingleUtteranceDecoder(
                    graph, acoustic_scale=args.acoustic_scale,
                    beam=args.beam, max_active=args.max_active)
            if args.lattice_wspecifier:
                dec = AdvanceRecorder(dec)
            chunk = max(1, int(args.chunk_seconds * rate))
            # one decoder advance a chunk: the recognizer's pieces are the
            # chunk's frame count
            rec = OnlineRecognizer(
                graph, fn, pipeline=pipe, decoder=dec,
                chunk_frames=max(1, chunk // opts.frame_opts.window_shift))
            for j in range(0, len(wave), chunk):
                rec.accept_waveform(wave[j:j + chunk])
            rec.input_finished()
            _, wids, _ = rec.result()
            n_frames += rec.decoder.num_frames if hasattr(
                rec.decoder, "num_frames") else 0
            if args.lattice_wspecifier:
                utt_lls[utt] = (np.concatenate(rec.decoder.rows)
                                if rec.decoder.rows
                                else np.zeros((0, 1), np.float32))
            text = " ".join(words.sym(int(w)) for w in wids)
            out.write(f"{utt} {text}".rstrip() + "\n")
    if args.lattice_wspecifier:
        from kaldi_cnn_tpu_torch.decode.lattice import save_lattices
        if args.host_decode:
            from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
            lats = {u: lattice_decode(
                graph, ll, acoustic_scale=args.acoustic_scale,
                beam=args.beam, lattice_beam=args.lattice_beam,
                max_active=args.max_active)
                for u, ll in utt_lls.items()}
        else:
            from kaldi_cnn_tpu_torch.decode.topk_decoder import (
                decode_utterances)
            lats = decode_utterances(
                graph, utt_lls, acoustic_scale=args.acoustic_scale,
                beam=args.beam, lattice_beam=args.lattice_beam,
                max_active=args.max_active, device=device)
        save_lattices(args.lattice_wspecifier, lats)
    elapsed = time.perf_counter() - t0
    audio_s = n_frames / 100.0
    print(f"online2-wav-latgen: {len(scp)} utterances "
          f"({'host' if args.host_decode else device.type} streaming path"
          + (f", {audio_s:.1f} audio-s in {elapsed:.2f}s, RTF "
             f"{elapsed / audio_s:.4f}" if audio_s else "") + ")",
          file=sys.stderr)
    return 0


class AdvanceRecorder:
    """Wraps an online decoder and records the loglike rows each
    ``advance`` gets, so that the utterance can be re-decoded through the
    lattice path afterwards (the streaming search keeps no lattice
    records); every other attribute is the decoder's."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def advance(self, ll):
        self.rows.append(np.asarray(ll, np.float32))
        self.inner.advance(ll)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _load_am(mdl_path: str, device="cuda"):
    """Sniff GMM vs am-nnet .mdl; return (trans_model,
    loglikes_fn(feats)->[T,num_pdfs], model_input_dim).

    The online pipeline's rows are [static | delta | delta2] blocks, so a
    spliced row is laid out (t, c, f); a Conv2DComponent reads its rows as
    (t, f, c).  When the nnet starts with a Conv2DComponent of more than
    one channel, the scorer reorders each spliced row before the model
    sees it (the JAX verb passes the rows as they are)."""
    from kaldi_cnn_tpu_torch.io.kaldi_model import (read_am_nnet,
                                                    read_gmm_model)
    from kaldi_cnn_tpu_torch.models.components import Conv2DComponent
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    try:
        tm, nnet, params, priors = read_am_nnet(mdl_path, device)
    except (ValueError, KeyError, EOFError):
        tm, am = read_gmm_model(mdl_path)
        return tm, am.loglikes, am.dim
    am = AmNnet(nnet, tm.num_pdfs)
    am.priors = np.asarray(priors, np.float64)
    first = nnet.components[0]
    if isinstance(first, Conv2DComponent) and first.in_c > 1:
        shape = (first.in_t, first.in_c, first.in_f)

        def scorer(f):
            f = np.asarray(f, np.float32)
            rows = f.reshape((len(f),) + shape).transpose(0, 1, 3, 2)
            return am.loglikes(rows.reshape(len(f), -1))
        return tm, scorer, nnet.input_dim
    return tm, am.loglikes, nnet.input_dim


TRAIN_VERBS = {
    "online2-wav-latgen": cmd_online2_wav_latgen,
}
