"""kaldi_cnn_tpu_torch: the PyTorch + CUDA port of kaldi_cnn_tpu.

A second package beside the JAX one, with the same module layout and
names.  It imports torch and nothing of jax or of kaldi_cnn_tpu (it
keeps its own copies of the numpy-only modules it needs, such as
``lang/``).  Each Pallas TPU kernel on the
ported path is a hand-written CUDA C++ kernel for Hopper (``csrc/``),
built with nvcc at first use and bound with ctypes; each has a plain
PyTorch version that CPU tensors take (``ops/``).  Entry points run on
the card unless given ``device="cpu"``.

Ported so far: the WSJ-style CNN recipe from the fbank volumes on, its
training stage (egs -> NG-SGD training with manual backprop -> model
combination -> priors) and its serving path (fbank -> CNN acoustic
model -> top-K best-path decode -> WER); see ``recipes/wsj.py``.
"""
