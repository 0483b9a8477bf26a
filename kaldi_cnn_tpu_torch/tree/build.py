"""Greedy decision-tree building + the tree-backed context dependency.

Clean-room equivalent of src/tree/build-tree.{h,cc} (BuildTree) and
src/tree/context-dep.{h,cc} (ContextDependency): roots per central
phone with pdf-classes shared (the reference's default roots file from
prepare_lang.sh: "shared split" per phone line), greedy splitting by
single-Gaussian likelihood gain over question sets, stopping at
max_leaves / min gain (ref: --max-leaves, --cluster-thresh).
"""

from __future__ import annotations

import heapq
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.lang.topology import HmmTopology
from kaldi_cnn_tpu_torch.lang.transition_model import ContextDependencyInterface
from kaldi_cnn_tpu_torch.tree.event_map import (
    KEY_PDF_CLASS, ConstantEventMap, Event, EventMap, SplitEventMap,
    TableEventMap)
from kaldi_cnn_tpu_torch.tree.stats import EventKey, GaussStats

logger = get_logger(__name__)

Items = List[Tuple[Event, GaussStats]]


class _Leaf:
    __slots__ = ("items", "best", "split", "yes", "no")

    def __init__(self, items: Items):
        self.items = items
        self.best = None       # (gain, key, qset)
        self.split = None      # (key, qset) once split
        self.yes: Optional["_Leaf"] = None
        self.no: Optional["_Leaf"] = None

    def find_best_split(self, questions, keys) -> None:
        total = GaussStats.sum_of([s for _, s in self.items])
        base = total.objf()
        best = None
        for key in keys:
            by_val: Dict[int, GaussStats] = {}
            for ev, s in self.items:
                by_val.setdefault(ev.get(key, 0), GaussStats()).add(s)
            if len(by_val) < 2:
                continue
            for q in questions.get(key, ()):
                yes = GaussStats.sum_of(
                    [s for v, s in by_val.items() if v in q])
                if yes.count < 1e-3 or yes.count > total.count - 1e-3:
                    continue
                no = GaussStats()
                no.count = total.count - yes.count
                no.x = total.x - yes.x
                no.x2 = total.x2 - yes.x2
                gain = yes.objf() + no.objf() - base
                if best is None or gain > best[0]:
                    best = (gain, key, q)
        self.best = best

    def do_split(self) -> Tuple["_Leaf", "_Leaf"]:
        _, key, q = self.best
        yes_items = [(e, s) for e, s in self.items if e.get(key, 0) in q]
        no_items = [(e, s) for e, s in self.items
                    if e.get(key, 0) not in q]
        self.split = (key, q)
        self.yes, self.no = _Leaf(yes_items), _Leaf(no_items)
        self.items = None
        return self.yes, self.no


def _materialize(leaf: _Leaf, next_id: List[int]) -> EventMap:
    if leaf.split is None:
        answer = next_id[0]
        next_id[0] += 1
        return ConstantEventMap(answer)
    key, q = leaf.split
    return SplitEventMap(key, q, _materialize(leaf.yes, next_id),
                         _materialize(leaf.no, next_id))


def build_tree(
    stats: Dict[EventKey, GaussStats],
    questions: Dict[int, List[FrozenSet[int]]],
    topo: HmmTopology,
    context_width: int = 3,
    central_position: int = 1,
    max_leaves: int = 2000,
    min_gain: float = 0.0,
) -> "TreeContextDependency":
    """Build the tree from accumulated stats (ref: BuildTree)."""
    by_phone: Dict[int, Items] = {p: [] for p in topo.phones}
    for key, s in stats.items():
        ev = dict(key)
        phone = ev.get(central_position, 0)
        if phone in by_phone:
            by_phone[phone].append((ev, s))

    split_keys = [KEY_PDF_CLASS] + [k for k in range(context_width)
                                    if k != central_position]
    roots: Dict[int, _Leaf] = {}
    heap: List = []
    counter = 0
    num_leaves = 0
    for phone in topo.phones:
        leaf = _Leaf(by_phone[phone])
        roots[phone] = leaf
        num_leaves += 1
        if leaf.items:
            leaf.find_best_split(questions, split_keys)
            if leaf.best and leaf.best[0] > min_gain:
                heapq.heappush(heap, (-leaf.best[0], counter, leaf))
                counter += 1

    while heap and num_leaves < max_leaves:
        neg_gain, _, leaf = heapq.heappop(heap)
        if leaf.best is None or -neg_gain != leaf.best[0]:
            continue
        yes, no = leaf.do_split()
        num_leaves += 1
        for child in (yes, no):
            child.find_best_split(questions, split_keys)
            if child.best and child.best[0] > min_gain:
                heapq.heappush(heap, (-child.best[0], counter, child))
                counter += 1

    # deterministic pdf-id assignment: walk roots in phone order
    next_id = [0]
    table: Dict[int, EventMap] = {}
    for phone in topo.phones:
        table[phone] = _materialize(roots[phone], next_id)
    emap = TableEventMap(central_position, table)
    logger.info("built tree: %d leaves (%d max), %d phones",
                next_id[0], max_leaves, len(topo.phones))
    return TreeContextDependency(emap, context_width, central_position,
                                 next_id[0], topo)


class TreeContextDependency(ContextDependencyInterface):
    """EventMap-backed (phone window, pdf-class) -> pdf-id
    (ref: src/tree/context-dep.{h,cc} ContextDependency::Compute)."""

    def __init__(self, emap: EventMap, context_width: int,
                 central_position: int, num_pdfs: int,
                 topo: HmmTopology):
        self.emap = emap
        self.context_width = context_width
        self.central_position = central_position
        self._num_pdfs = num_pdfs
        self._topo = topo

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        w = list(phone_window)
        if len(w) == 1 and self.context_width > 1:
            pad_l = self.central_position
            pad_r = self.context_width - self.central_position - 1
            w = [0] * pad_l + w + [0] * pad_r
        assert len(w) == self.context_width, (w, self.context_width)
        ev = {k: w[k] for k in range(self.context_width)}
        ev[KEY_PDF_CLASS] = pdf_class
        ans = self.emap.map(ev)
        if ans is None:
            raise ValueError(f"tree has no answer for {ev}")
        return ans

    def pdfs_for(self, phone: int, pdf_class: int) -> Set[int]:
        """All pdf-ids the tree can emit for this (central phone,
        pdf-class) across contexts (ref: ContextDependency::GetPdfInfo
        via EventMap::MultiMap)."""
        partial = {self.central_position: phone, KEY_PDF_CLASS: pdf_class}
        keys = [k for k in range(self.context_width)
                if k != self.central_position]
        return self.emap.multi_map(partial, keys)
