"""See kaldi_cnn_tpu/tree (the JAX twin).  Only ``event_map`` and
``stats`` are copied so far; the lattice word alignment needs
``stats.split_to_phones``."""
