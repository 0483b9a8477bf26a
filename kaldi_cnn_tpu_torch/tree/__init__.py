"""Phonetic-context decision trees.

Re-design of src/tree/ (EventMap serialization, GaussClusterable stats,
ClusterBottomUp question generation, BuildTree greedy splitting) as a
compact pure-Python module: offline, not perf-critical (SURVEY.md §2
disposition: "CPU Python; must be bit-compatible in pdf-id assignment"
— here pdf-id assignment is deterministic given stats + questions).
"""

from kaldi_cnn_tpu_torch.tree.event_map import (
    KEY_PDF_CLASS, ConstantEventMap, EventMap, SplitEventMap,
    TableEventMap)
from kaldi_cnn_tpu_torch.tree.stats import (
    GaussStats, accumulate_tree_stats, frame_events, split_to_phones)
from kaldi_cnn_tpu_torch.tree.questions import (
    cluster_phones, per_phone_stats, questions_for_keys)
from kaldi_cnn_tpu_torch.tree.build import TreeContextDependency, build_tree
