"""HMM topology (ref: src/hmm/hmm-topology.{h,cc} HmmTopology).

A topology entry per phone: a list of emitting states, each with a
pdf_class and a transition list [(next_state, prob)].  The last state
(index num_states) is the implicit non-emitting final state.  Default is
the reference's 3-state Bakis chain (self-loop 0.5 / forward 0.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class HmmState:
    pdf_class: int
    transitions: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class TopologyEntry:
    states: List[HmmState]

    @property
    def num_emitting(self) -> int:
        return len(self.states)


def bakis_entry(num_states: int = 3, self_loop: float = 0.5) -> TopologyEntry:
    states = []
    for i in range(num_states):
        states.append(HmmState(pdf_class=i, transitions=[
            (i, self_loop), (i + 1, 1.0 - self_loop)]))
    return TopologyEntry(states)


class HmmTopology:
    """Maps phone -> TopologyEntry (phones are 1-based symbol ids)."""

    def __init__(self, phones: Sequence[int],
                 entries: Dict[int, TopologyEntry] = None,
                 default_num_states: int = 3):
        self.phones = sorted(phones)
        self._entries: Dict[int, TopologyEntry] = {}
        for p in self.phones:
            if entries and p in entries:
                self._entries[p] = entries[p]
            else:
                self._entries[p] = bakis_entry(default_num_states)

    def entry(self, phone: int) -> TopologyEntry:
        return self._entries[phone]

    def num_pdf_classes(self, phone: int) -> int:
        return 1 + max(s.pdf_class for s in self._entries[phone].states)
