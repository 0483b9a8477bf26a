"""See kaldi_cnn_tpu/train (the JAX twin)."""
