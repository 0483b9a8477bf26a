"""Online/streaming decoding pipeline — re-design of src/online2/
(streaming features, chunked iVectors, incremental decoding,
endpointing); SURVEY.md §3.5."""

from kaldi_cnn_tpu_torch.online2.features import (
    OnlineBaseFeature, OnlineCmvn, OnlineCmvnOptions,
    OnlineFeaturePipeline, StreamingSplicer)
from kaldi_cnn_tpu_torch.online2.decoder import (
    EndpointConfig, EndpointRule, SingleUtteranceDecoder)
from kaldi_cnn_tpu_torch.online2.ivector import (
    OnlineIvectorFeature, OnlineIvectorOptions)
from kaldi_cnn_tpu_torch.online2.recognizer import OnlineRecognizer
