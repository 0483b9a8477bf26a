"""See kaldi_cnn_tpu/decode (the JAX twin)."""
