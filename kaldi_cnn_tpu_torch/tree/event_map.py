"""Event maps: the serialized form of phonetic decision trees.

Clean-room equivalent of src/tree/event-map.{h,cc} (EventMap,
ConstantEventMap, TableEventMap, SplitEventMap).  An *event* is a
mapping from integer keys to integer values; key -1 is the pdf-class
(kPdfClass) and keys 0..N-1 are positions in the phone context window
(ref: src/hmm/hmm-topology.h kPdfClass convention).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

KEY_PDF_CLASS = -1

Event = Dict[int, int]


class EventMap:
    def map(self, event: Event) -> Optional[int]:
        """event -> answer (pdf-id), or None if unmapped."""
        raise NotImplementedError

    def multi_map(self, partial_event: Event, keys: Sequence[int]
                  ) -> Set[int]:
        """All answers reachable when the keys NOT in partial_event are
        unconstrained (ref: EventMap::MultiMap, used by GetPdfInfo)."""
        raise NotImplementedError

    def max_answer(self) -> int:
        raise NotImplementedError


class ConstantEventMap(EventMap):
    def __init__(self, answer: int):
        self.answer = answer

    def map(self, event: Event) -> Optional[int]:
        return self.answer

    def multi_map(self, partial_event, keys) -> Set[int]:
        return {self.answer}

    def max_answer(self) -> int:
        return self.answer

    def __repr__(self):
        return f"CE({self.answer})"


class TableEventMap(EventMap):
    """Total table on one key (ref: TableEventMap)."""

    def __init__(self, key: int, table: Dict[int, EventMap]):
        self.key = key
        self.table = table

    def map(self, event: Event) -> Optional[int]:
        v = event.get(self.key)
        sub = self.table.get(v)
        return sub.map(event) if sub is not None else None

    def multi_map(self, partial_event, keys) -> Set[int]:
        if self.key in partial_event:
            sub = self.table.get(partial_event[self.key])
            return sub.multi_map(partial_event, keys) if sub else set()
        out: Set[int] = set()
        for sub in self.table.values():
            out |= sub.multi_map(partial_event, keys)
        return out

    def max_answer(self) -> int:
        return max((s.max_answer() for s in self.table.values()),
                   default=-1)


class SplitEventMap(EventMap):
    """Binary split on key membership in yes_set (ref: SplitEventMap)."""

    def __init__(self, key: int, yes_set: FrozenSet[int],
                 yes_map: EventMap, no_map: EventMap):
        self.key = key
        self.yes_set = frozenset(yes_set)
        self.yes = yes_map
        self.no = no_map

    def map(self, event: Event) -> Optional[int]:
        v = event.get(self.key)
        if v is None:
            return None
        return (self.yes if v in self.yes_set else self.no).map(event)

    def multi_map(self, partial_event, keys) -> Set[int]:
        v = partial_event.get(self.key)
        if v is not None:
            return (self.yes if v in self.yes_set
                    else self.no).multi_map(partial_event, keys)
        return (self.yes.multi_map(partial_event, keys)
                | self.no.multi_map(partial_event, keys))

    def max_answer(self) -> int:
        return max(self.yes.max_answer(), self.no.max_answer())
