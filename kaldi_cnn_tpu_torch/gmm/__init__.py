"""Diagonal-GMM acoustic models for the bootstrap training stages
(flat-start mono -> deltas -> LDA+MLLT -> SAT), which produce the alignments the
neural AM trains on.  Twin of ``kaldi_cnn_tpu/gmm``: numpy on the host,
as in the JAX package (ref: src/gmm/ DiagGmm, AmDiagGmm,
AccumAmDiagGmm, MleAmDiagGmmUpdate).
"""

from kaldi_cnn_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_cnn_tpu_torch.gmm.am_gmm import AmDiagGmm, AmDiagGmmAccs
from kaldi_cnn_tpu_torch.gmm.train import (
    train_mono, train_deltas, train_lda_mllt, train_sat, align_equal,
    MonoTrainOptions, DeltasTrainOptions, LdaMlltTrainOptions,
    SatTrainOptions)
