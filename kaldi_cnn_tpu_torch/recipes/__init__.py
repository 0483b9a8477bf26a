"""See kaldi_cnn_tpu/recipes (the JAX twin)."""
