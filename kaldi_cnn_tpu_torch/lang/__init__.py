"""Language/graph layer: WFSTs, lexicon, ARPA LM, HMM topology,
transition model, decision trees, HCLG graph build.

Pure-Python/NumPy re-design of the reference's offline graph machinery
(ref: src/fstext/, src/hmm/, src/tree/, src/lm/, utils/mkgraph.sh,
utils/prepare_lang.sh).  Runs on CPU: graph construction is offline and
correctness-critical, not perf-critical (SURVEY.md §2 disposition).
"""

from kaldi_cnn_tpu_torch.lang.fst import Fst, NO_LABEL, EPS
from kaldi_cnn_tpu_torch.lang.symbols import SymbolTable
from kaldi_cnn_tpu_torch.lang.topology import HmmTopology
from kaldi_cnn_tpu_torch.lang.transition_model import (
    TransitionModel, MonophoneContextDependency)
from kaldi_cnn_tpu_torch.lang.lexicon import Lexicon, make_lexicon_fst
from kaldi_cnn_tpu_torch.lang.arpa import parse_arpa, arpa_to_fst
from kaldi_cnn_tpu_torch.lang.hclg import make_hclg, compile_training_graph, Lang
