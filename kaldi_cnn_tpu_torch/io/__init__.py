"""I/O: wave reading and Kaldi-compatible ark/scp Table I/O (twin of
``kaldi_cnn_tpu/io/``; ref: src/util/kaldi-table.h, kaldi-io.h,
src/feat/wave-reader.{h,cc}), and the ``.mdl`` model files
(``kaldi_model``), the mmap-backed readers over the native ark scanner
(``native_io``), compressed matrices (``compressed``) and Kaldi-binary
CompactLattice archives (``kaldi_lattice``).
"""

from kaldi_cnn_tpu_torch.io.wave import read_wave, write_wave
from kaldi_cnn_tpu_torch.io.kaldi_io import (
    read_ark, write_ark, read_scp, ArkWriter,
    read_vec_int_ark, read_mat_ark,
)
from kaldi_cnn_tpu_torch.io.native_io import (
    RandomAccessArkReader, SequentialArkReader,
)
