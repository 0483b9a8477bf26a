"""Feature-space transforms: LDA, MLLT (semi-tied covariance), fMLLR.

Re-design of src/transform/ (lda-estimate.{h,cc}, mllt.{h,cc},
fmllr-diag-gmm.{h,cc}, cmvn.{h,cc} — CMVN lives in features.functional)
as numpy estimation (offline, float64) + affine application that is a
single matmul on device.
"""

from kaldi_cnn_tpu_torch.transform.lda import (
    LdaEstimate, apply_affine, compose_affine)
from kaldi_cnn_tpu_torch.transform.mllt import MlltAccs
from kaldi_cnn_tpu_torch.transform.fmllr import FmllrAccs, estimate_fmllr_per_spk
