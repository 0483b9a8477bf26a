"""See kaldi_cnn_tpu/features (the JAX twin)."""
