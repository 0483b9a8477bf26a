"""End-to-end streaming recognizer: wav chunks in, words out.

Clean-room equivalent of src/online2bin/
online2-wav-nnet2-latgen-faster.cc: OnlineFeaturePipeline feeding a
SingleUtteranceDecoder frame-by-frame as audio arrives, with optional
endpointing; the acoustic model is pluggable (GMM loglikes or an
AmNnet with spliced inputs and optional online iVectors).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.online2.decoder import (
    EndpointConfig, SingleUtteranceDecoder)
from kaldi_cnn_tpu_torch.online2.features import OnlineFeaturePipeline
from kaldi_cnn_tpu_torch.online2.ivector import OnlineIvectorFeature


class OnlineRecognizer:
    def __init__(
        self,
        graph: CompiledGraph,
        loglike_fn: Callable[[np.ndarray], np.ndarray],
        pipeline: Optional[OnlineFeaturePipeline] = None,
        ivector: Optional[OnlineIvectorFeature] = None,
        acoustic_scale: float = 0.1,
        beam: float = 60.0,
        max_active: int = 2000,
        chunk_frames: int = 10,
        decoder=None,
    ):
        """loglike_fn: [n, D(+ivec)] feature rows -> [n, num_pdfs]
        pseudo log-likelihoods.  ``decoder``: any object with the
        advance/finalize/best_path/endpoint_detected contract — e.g. a
        decode.topk_decoder.TpuStreamingDecoder to run the chunked
        decode on-device; defaults to the host incremental Viterbi."""
        self.pipeline = pipeline or OnlineFeaturePipeline()
        self.ivector = ivector
        self.loglike_fn = loglike_fn
        self.decoder = decoder or SingleUtteranceDecoder(
            graph, acoustic_scale=acoustic_scale, beam=beam,
            max_active=max_active)
        self.chunk_frames = chunk_frames
        self._consumed = 0

    def accept_waveform(self, chunk: np.ndarray) -> None:
        self.pipeline.accept_waveform(chunk)
        self._advance()

    def input_finished(self) -> None:
        self.pipeline.finish()
        self._advance()
        if hasattr(self.loglike_fn, "flush"):
            # StreamingSplicer-style scorers hold back frames awaiting
            # right context; drain them before finalizing the decode
            ll = self.loglike_fn.flush()
            if ll is not None and len(ll):
                self.decoder.advance(ll)
        if hasattr(self.decoder, "finalize"):
            self.decoder.finalize()

    def _advance(self) -> None:
        ready = self.pipeline.num_frames_ready()
        while ready - self._consumed >= self.chunk_frames or (
                self.pipeline.base.input_finished
                and ready > self._consumed):
            end = min(ready, self._consumed + max(self.chunk_frames, 1))
            feats = self.pipeline.get_frames(self._consumed, end)
            if self.ivector is not None:
                self.ivector.accept_frames(feats)
                iv = self.ivector.ivector()
                feats = np.concatenate(
                    [feats, np.repeat(iv[None, :], len(feats), 0)],
                    axis=1)
            ll = self.loglike_fn(feats.astype(np.float32))
            self.decoder.advance(ll)
            self._consumed = end

    def partial_result(self) -> Tuple[np.ndarray, np.ndarray, float]:
        return self.decoder.best_path(use_final=False)

    def result(self) -> Tuple[np.ndarray, np.ndarray, float]:
        return self.decoder.best_path(use_final=True)

    def endpoint_detected(self, trans_model, silence_phone: int,
                          config: Optional[EndpointConfig] = None
                          ) -> bool:
        return self.decoder.endpoint_detected(trans_model,
                                              silence_phone, config)
