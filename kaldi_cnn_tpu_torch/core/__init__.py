"""See kaldi_cnn_tpu/core (the JAX twin)."""
