"""iVector speaker modeling (twin of ``kaldi_cnn_tpu/ivector/``): the
UBM and total-variability extractor, host numpy, for the online
recognizer's i-vector branch.  VAD and PLDA are not ported yet."""

from kaldi_cnn_tpu_torch.ivector.extractor import (
    IvectorExtractor, length_normalize, train_ubm, utt_stats)
