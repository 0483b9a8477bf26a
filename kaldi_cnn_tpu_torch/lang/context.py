"""Context expansion: LG -> CLG for context-dependent (triphone) trees.

Clean-room equivalent of src/fstext/context-fst.{h,inl} (ContextFst)
composed via fstcomposecontext — but built directly instead of as a
dynamic composition: CLG states are (LG state, history of the last N-1
phones); consuming phone p from history (a, b) emits one arc labeled
with the context window (a, b, p) whose *central* phone is b (windows
are emitted one phone late; the final phone flushes with right-context
0 at final states).  Since the history is a deterministic function of
the path, the result needs no further determinization — the property
ContextFst is built to preserve.

Window labels live in their own id space (1-based); the returned table
maps label -> phone window tuple for HMM expansion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kaldi_cnn_tpu_torch.lang.fst import EPS, Fst


class ContextWindows:
    """Window-label table (ref: the 'ilabels' sidecar file that
    fstcomposecontext writes for make-h-transducer)."""

    def __init__(self, context_width: int, central_position: int):
        self.context_width = context_width
        self.central_position = central_position
        self._by_window: Dict[Tuple[int, ...], int] = {}
        self.windows: List[Optional[Tuple[int, ...]]] = [None]  # 0 = eps

    def label(self, window: Tuple[int, ...]) -> int:
        lab = self._by_window.get(window)
        if lab is None:
            lab = len(self.windows)
            self.windows.append(window)
            self._by_window[window] = lab
        return lab

    def window(self, label: int) -> Tuple[int, ...]:
        return self.windows[label]

    def central_phone(self, label: int) -> int:
        return self.windows[label][self.central_position]


def compose_context(
    lg: Fst,
    context_width: int = 3,
    central_position: int = 1,
) -> Tuple[Fst, ContextWindows]:
    """LG (phone ilabels, word olabels) -> CLG (window ilabels).

    Currently supports the standard (N, P) with P == N - 2 >= 0 (e.g.
    triphone (3, 1), biphone (2, 0)); monophone callers skip context
    expansion entirely.
    """
    assert central_position == context_width - 2 >= 0, \
        "supported: P == N - 2 (triphone (3,1) / left-biphone (2,0))"
    wins = ContextWindows(context_width, central_position)
    hist0 = (0,) * (context_width - 1)
    out = Fst()
    state_map: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
        return s

    start_key = (lg.start, hist0)
    out.start = get_state(start_key)
    stack = [start_key]
    seen = {start_key}
    final_state: Optional[int] = None
    while stack:
        key = stack.pop()
        s, hist = key
        cur = state_map[key]
        for a in lg.arcs[s]:
            if a.ilabel == EPS:
                nkey = (a.nextstate, hist)
                ns = get_state(nkey)
                out.add_arc(cur, EPS, a.olabel, a.weight, ns)
            else:
                p = a.ilabel
                nhist = hist[1:] + (p,)
                nkey = (a.nextstate, nhist)
                ns = get_state(nkey)
                center = hist[-1]
                if center == 0:
                    # fewer than P+1 phones seen: window not complete yet
                    ilabel = EPS
                else:
                    ilabel = wins.label(hist + (p,))
                out.add_arc(cur, ilabel, a.olabel, a.weight, ns)
            if nkey not in seen:
                seen.add(nkey)
                stack.append(nkey)
        if lg.is_final(s):
            center = hist[-1]
            if center == 0:
                out.final[cur] = lg.final[s]
            else:
                # flush the pending last phone with right-context 0
                if final_state is None:
                    final_state = out.add_state()
                    out.final[final_state] = 0.0
                ilabel = wins.label(hist + (0,))
                out.add_arc(cur, ilabel, EPS, lg.final[s], final_state)
    return out.connect(), wins
