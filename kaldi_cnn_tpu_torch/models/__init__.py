"""See kaldi_cnn_tpu/models (the JAX twin)."""
