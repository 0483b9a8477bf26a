"""Parallel scaling over ``torch.distributed`` ranks: data parallelism
with per-step all-reduces (mode A), replicas with periodic model
averaging, multi-process init (twin of ``kaldi_cnn_tpu/parallel``).

Replaces the reference's shell-scheduler parallelism (SURVEY.md §2.2:
N independent SGD jobs + nnet-am-average per outer iteration,
utils/parallel/{run.pl,queue.pl}): one process a device, the global
minibatch's rows split over the ranks of a replica, and the sums over
rows all-reduced inside the train step (``dp.make_dp_step``); the
reference's periodic-averaging semantics run across replicas
(``multihost.train_multihost``).
"""

from kaldi_cnn_tpu_torch.parallel.dp import average_params, make_dp_step
from kaldi_cnn_tpu_torch.core.mesh import make_mesh
