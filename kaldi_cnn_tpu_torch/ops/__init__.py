"""See kaldi_cnn_tpu/ops (the JAX twin)."""
