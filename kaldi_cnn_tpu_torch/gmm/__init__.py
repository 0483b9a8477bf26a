"""See kaldi_cnn_tpu/gmm (the JAX twin)."""
