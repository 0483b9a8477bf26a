"""iVector speaker modeling (twin of ``kaldi_cnn_tpu/ivector/``): the
UBM and total-variability extractor, energy VAD and PLDA, host numpy,
for the Switchboard recipe's iVectors and the online recognizer's
i-vector branch."""

from kaldi_cnn_tpu_torch.ivector.extractor import (
    IvectorExtractor, length_normalize, train_ubm, utt_stats)
from kaldi_cnn_tpu_torch.ivector.vad import (VadOptions, compute_vad,
                                             log_energy)
from kaldi_cnn_tpu_torch.ivector.plda import Plda, estimate_plda
