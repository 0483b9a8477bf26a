"""Weighted finite-state transducers over the tropical semiring.

Clean-room Python implementation of the WFST algorithms the reference
relies on (via OpenFst + src/fstext/): composition with the
epsilon-sequencing filter, determinization with epsilon removal and
output-string factoring (ref: src/fstext/determinize-star.{h,inl}
DeterminizeStar), connection/trimming, shortest path, and the test
helper ``equivalent`` (ref: fstext tests use fst::RandEquivalent).

Weights are costs (= -log prob), tropical semiring (min, +).
Label 0 is epsilon on both tapes.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

EPS = 0
NO_LABEL = -1
INF = float("inf")


class Arc:
    __slots__ = ("ilabel", "olabel", "weight", "nextstate")

    def __init__(self, ilabel: int, olabel: int, weight: float, nextstate: int):
        self.ilabel = ilabel
        self.olabel = olabel
        self.weight = weight
        self.nextstate = nextstate

    def __repr__(self):
        return f"Arc({self.ilabel}:{self.olabel}/{self.weight:.3f}->{self.nextstate})"


class Fst:
    """Mutable WFST. states are 0..num_states-1; final[s] is a cost (INF
    = non-final); start is state 0 by convention unless set."""

    def __init__(self):
        self.arcs: List[List[Arc]] = []
        self.final: List[float] = []
        self.start: int = -1

    # -- construction -----------------------------------------------------
    def add_state(self) -> int:
        self.arcs.append([])
        self.final.append(INF)
        return len(self.arcs) - 1

    def add_arc(self, state: int, ilabel: int, olabel: int,
                weight: float, nextstate: int) -> None:
        self.arcs[state].append(Arc(ilabel, olabel, weight, nextstate))

    def set_final(self, state: int, weight: float = 0.0) -> None:
        self.final[state] = weight

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return self.final[s] < INF

    def copy(self) -> "Fst":
        out = Fst()
        out.start = self.start
        for s in range(self.num_states):
            out.add_state()
            out.final[s] = self.final[s]
            for a in self.arcs[s]:
                out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
        return out

    def arcsort(self, key: str = "ilabel") -> "Fst":
        attr = key
        for alist in self.arcs:
            alist.sort(key=lambda a: (getattr(a, attr), a.olabel
                                      if attr == "ilabel" else a.ilabel))
        return self

    # -- text serialization (OpenFst att-format; ref: fstprint/fstcompile
    # convention used throughout the reference's graph recipes) ------------
    def write_text(self, fh) -> None:
        """``src dst ilabel olabel weight`` arc lines (start state's arcs
        first, as fstcompile expects) and ``state weight`` final lines."""
        order = [self.start] + [s for s in range(self.num_states)
                                if s != self.start]
        for s in order:
            for a in self.arcs[s]:
                fh.write(f"{s} {a.nextstate} {a.ilabel} {a.olabel} "
                         f"{a.weight:.9g}\n")
        for s in order:
            if self.is_final(s):
                fh.write(f"{s} {self.final[s]:.9g}\n")

    @staticmethod
    def read_text(fh) -> "Fst":
        f = Fst()

        def ensure(s: int) -> int:
            while f.num_states <= s:
                f.add_state()
            return s

        first = True
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s, d, il, ol = (int(x) for x in parts[:4])
                w = float(parts[4]) if len(parts) > 4 else 0.0
                ensure(max(s, d))
                f.add_arc(s, il, ol, w, d)
                if first:
                    f.start = s
                    first = False
            else:
                s = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                ensure(s)
                f.set_final(s, w)
                if first:
                    f.start = s
                    first = False
        return f

    # -- simple constructors ----------------------------------------------
    @staticmethod
    def linear(labels: Sequence[int], olabels: Optional[Sequence[int]] = None,
               weight_per_arc: float = 0.0) -> "Fst":
        """Linear chain accepting the given label sequence."""
        f = Fst()
        s = f.add_state()
        f.start = s
        if olabels is None:
            olabels = labels
        for il, ol in zip(labels, olabels):
            n = f.add_state()
            f.add_arc(s, il, ol, weight_per_arc, n)
            s = n
        f.set_final(s, 0.0)
        return f

    # -- core algorithms --------------------------------------------------
    def connect(self) -> "Fst":
        """Trim states not on a successful path (ref: fst::Connect)."""
        n = self.num_states
        if self.start < 0 or n == 0:
            return self
        # forward reachability
        fwd = [False] * n
        stack = [self.start]
        fwd[self.start] = True
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if not fwd[a.nextstate]:
                    fwd[a.nextstate] = True
                    stack.append(a.nextstate)
        # backward reachability from finals
        preds: List[List[int]] = [[] for _ in range(n)]
        for s in range(n):
            for a in self.arcs[s]:
                preds[a.nextstate].append(s)
        bwd = [False] * n
        stack = [s for s in range(n) if self.is_final(s)]
        for s in stack:
            bwd[s] = True
        while stack:
            s = stack.pop()
            for p in preds[s]:
                if not bwd[p]:
                    bwd[p] = True
                    stack.append(p)
        keep = [s for s in range(n) if fwd[s] and bwd[s]]
        remap = {s: i for i, s in enumerate(keep)}
        new_arcs: List[List[Arc]] = [[] for _ in keep]
        new_final = [INF] * len(keep)
        for s in keep:
            ns = remap[s]
            new_final[ns] = self.final[s]
            for a in self.arcs[s]:
                if a.nextstate in remap:
                    new_arcs[ns].append(
                        Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate]))
        self.arcs = new_arcs
        self.final = new_final
        self.start = remap.get(self.start, -1)
        return self

    def shortest_distance(self, reverse: bool = False) -> List[float]:
        """Single-source shortest distances (tropical; Dijkstra-like with
        a priority queue; supports negative-free costs typical here)."""
        n = self.num_states
        dist = [INF] * n
        if reverse:
            radj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
            for s in range(n):
                for a in self.arcs[s]:
                    radj[a.nextstate].append((s, a.weight))
            pq = []
            for s in range(n):
                if self.is_final(s):
                    dist[s] = self.final[s]
                    heapq.heappush(pq, (dist[s], s))
            while pq:
                d, s = heapq.heappop(pq)
                if d > dist[s]:
                    continue
                for p, w in radj[s]:
                    nd = d + w
                    if nd < dist[p]:
                        dist[p] = nd
                        heapq.heappush(pq, (nd, p))
            return dist
        if self.start < 0:
            return dist
        dist[self.start] = 0.0
        pq = [(0.0, self.start)]
        while pq:
            d, s = heapq.heappop(pq)
            if d > dist[s]:
                continue
            for a in self.arcs[s]:
                nd = d + a.weight
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    heapq.heappush(pq, (nd, a.nextstate))
        return dist

    def shortest_path(self) -> Tuple[List[int], List[int], float]:
        """Best path: returns (ilabels, olabels, total_cost), eps removed."""
        n = self.num_states
        dist = [INF] * n
        back: List[Optional[Tuple[int, Arc]]] = [None] * n
        dist[self.start] = 0.0
        pq = [(0.0, self.start)]
        while pq:
            d, s = heapq.heappop(pq)
            if d > dist[s]:
                continue
            for a in self.arcs[s]:
                nd = d + a.weight
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (s, a)
                    heapq.heappush(pq, (nd, a.nextstate))
        best_s, best_cost = -1, INF
        for s in range(n):
            if self.is_final(s) and dist[s] + self.final[s] < best_cost:
                best_cost = dist[s] + self.final[s]
                best_s = s
        if best_s < 0:
            return [], [], INF
        ilabels, olabels = [], []
        s = best_s
        while back[s] is not None:
            p, a = back[s]
            if a.ilabel != EPS:
                ilabels.append(a.ilabel)
            if a.olabel != EPS:
                olabels.append(a.olabel)
            s = p
        return ilabels[::-1], olabels[::-1], best_cost


# --------------------------------------------------------------------------
# composition (epsilon-sequencing filter)
# --------------------------------------------------------------------------

def compose(a: Fst, b: Fst) -> Fst:
    """a ∘ b matching a.olabel with b.ilabel, with the standard 3-state
    epsilon filter so eps paths aren't double counted
    (ref: fst::Compose / src/fstext/table-matcher.h fsttablecompose)."""
    b_by_ilabel: List[Dict[int, List[Arc]]] = []
    for s in range(b.num_states):
        d: Dict[int, List[Arc]] = {}
        for arc in b.arcs[s]:
            d.setdefault(arc.ilabel, []).append(arc)
        b_by_ilabel.append(d)

    out = Fst()
    state_map: Dict[Tuple[int, int, int], int] = {}

    def get_state(sa: int, sb: int, filt: int) -> int:
        key = (sa, sb, filt)
        if key not in state_map:
            s = out.add_state()
            state_map[key] = s
            if a.is_final(sa) and b.is_final(sb):
                out.final[s] = a.final[sa] + b.final[sb]
        return state_map[key]

    if a.start < 0 or b.start < 0:
        return out
    out.start = get_state(a.start, b.start, 0)
    stack = [(a.start, b.start, 0)]
    seen = {(a.start, b.start, 0)}
    while stack:
        sa, sb, filt = stack.pop()
        cur = get_state(sa, sb, filt)

        def emit(il, ol, w, na, nb, nf):
            key = (na, nb, nf)
            ns = get_state(na, nb, nf)
            out.add_arc(cur, il, ol, w, ns)
            if key not in seen:
                seen.add(key)
                stack.append(key)

        for arc_a in a.arcs[sa]:
            if arc_a.olabel == EPS:
                # eps-output move on a (filter: allowed in states 0,1 -> 1)
                if filt != 2:
                    emit(arc_a.ilabel, EPS, arc_a.weight, arc_a.nextstate,
                         sb, 1)
            else:
                for arc_b in b_by_ilabel[sb].get(arc_a.olabel, ()):
                    emit(arc_a.ilabel, arc_b.olabel,
                         arc_a.weight + arc_b.weight,
                         arc_a.nextstate, arc_b.nextstate, 0)
        # eps-input move on b (filter: allowed in states 0,2 -> 2)
        if filt != 1:
            for arc_b in b_by_ilabel[sb].get(EPS, ()):
                emit(EPS, arc_b.olabel, arc_b.weight, sa, arc_b.nextstate, 2)
    return out.connect()


# --------------------------------------------------------------------------
# determinization with epsilon removal + output-string factoring
# --------------------------------------------------------------------------

def determinize_star(f: Fst, max_states: int = 5_000_000) -> Fst:
    """Weighted determinization treating input-eps as true epsilon and
    accumulating output-label strings, then factoring multi-label
    outputs into chains (ref: src/fstext/determinize-star.{h,inl}).

    The input must be functional (true for L∘G with disambig symbols).
    """
    if f.start < 0:
        return Fst()

    def norm_w(w: float) -> float:
        return round(w, 6)

    def eps_closure(items: Iterable[Tuple[int, float, Tuple[int, ...]]]):
        """Follow ilabel-eps arcs, accumulating weight and output string.
        Keeps the min-weight representative per (state, outstring)."""
        best: Dict[Tuple[int, Tuple[int, ...]], float] = {}
        stack = []
        for s, w, o in items:
            key = (s, o)
            if w < best.get(key, INF):
                best[key] = w
                stack.append((s, w, o))
        while stack:
            s, w, o = stack.pop()
            if w > best.get((s, o), INF):
                continue
            for a in f.arcs[s]:
                if a.ilabel == EPS:
                    no = o + ((a.olabel,) if a.olabel != EPS else ())
                    nw = w + a.weight
                    key = (a.nextstate, no)
                    if nw < best.get(key, INF) - 1e-9:
                        best[key] = nw
                        stack.append((a.nextstate, nw, no))
        return [(s, w, o) for (s, o), w in best.items()]

    def normalize(items):
        """Subtract common weight, factor common output prefix."""
        wmin = min(w for _, w, _ in items)
        strings = [o for _, _, o in items]
        prefix = strings[0]
        for o in strings[1:]:
            k = 0
            while k < len(prefix) and k < len(o) and prefix[k] == o[k]:
                k += 1
            prefix = prefix[:k]
            if not prefix:
                break
        p = len(prefix)
        subset = tuple(sorted((s, norm_w(w - wmin), o[p:])
                              for s, w, o in items))
        return wmin, prefix, subset

    out = Fst()
    subset_map: Dict[tuple, int] = {}

    start_items = eps_closure([(f.start, 0.0, ())])
    w0, pre0, subset0 = normalize(start_items)
    # initial weight/prefix folded into a chain from the new start
    out.start = out.add_state()
    cur = out.start
    for i, ol in enumerate(pre0):
        n = out.add_state()
        out.add_arc(cur, EPS, ol, w0 if i == 0 else 0.0, n)
        cur = n
    if not pre0 and w0 != 0.0:
        n = out.add_state()
        out.add_arc(cur, EPS, EPS, w0, n)
        cur = n
    subset_map[subset0] = cur
    queue = [subset0]

    def emit_arc(src: int, ilabel: int, weight: float,
                 outstr: Tuple[int, ...], dest_subset) -> None:
        if dest_subset not in subset_map:
            subset_map[dest_subset] = out.add_state()
            queue.append(dest_subset)
        dest = subset_map[dest_subset]
        if len(outstr) == 0:
            out.add_arc(src, ilabel, EPS, weight, dest)
        else:
            s = src
            for i, ol in enumerate(outstr):
                last = i == len(outstr) - 1
                n = dest if last else out.add_state()
                out.add_arc(s, ilabel if i == 0 else EPS, ol,
                            weight if i == 0 else 0.0, n)
                s = n

    while queue:
        subset = queue.pop()
        src = subset_map[subset]
        # final weight: min over final member states; emit leftover output
        # strings at finals via eps chains
        final_items = [(w + f.final[s], o) for s, w, o in subset
                       if f.is_final(s)]
        if final_items:
            plain = [w for w, o in final_items if not o]
            if plain:
                out.final[src] = min(out.final[src], min(plain))
            for w, o in final_items:
                if o:
                    s = src
                    for i, ol in enumerate(o):
                        n = out.add_state()
                        out.add_arc(s, EPS, ol, w if i == 0 else 0.0, n)
                        s = n
                    out.final[s] = 0.0
        # group non-eps transitions by ilabel
        by_label: Dict[int, List[Tuple[int, float, Tuple[int, ...]]]] = {}
        for s, w, o in subset:
            for a in f.arcs[s]:
                if a.ilabel != EPS:
                    no = o + ((a.olabel,) if a.olabel != EPS else ())
                    by_label.setdefault(a.ilabel, []).append(
                        (a.nextstate, w + a.weight, no))
        for ilabel, items in sorted(by_label.items()):
            closed = eps_closure(items)
            wmin, prefix, dest_subset = normalize(closed)
            emit_arc(src, ilabel, wmin, prefix, dest_subset)
        if len(out.arcs) > max_states:
            raise RuntimeError("determinize_star: state blow-up "
                               f"(> {max_states}); input not determinizable?")
    return out.connect()


def remove_eps(f: Fst) -> Fst:
    """Epsilon (both-tape) removal via eps-closure per state."""
    out = Fst()
    for _ in range(f.num_states):
        out.add_state()
    out.start = f.start
    for s in range(f.num_states):
        # closure over arcs with ilabel==olabel==EPS
        dist: Dict[int, float] = {s: 0.0}
        stack = [s]
        while stack:
            u = stack.pop()
            for a in f.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    nd = dist[u] + a.weight
                    if nd < dist.get(a.nextstate, INF) - 1e-12:
                        dist[a.nextstate] = nd
                        stack.append(a.nextstate)
        fin = INF
        for u, d in dist.items():
            if f.is_final(u):
                fin = min(fin, d + f.final[u])
            for a in f.arcs[u]:
                if not (a.ilabel == EPS and a.olabel == EPS):
                    out.add_arc(s, a.ilabel, a.olabel, d + a.weight,
                                a.nextstate)
        out.final[s] = fin
    return out.connect()


def relabel(f: Fst, imap: Optional[Dict[int, int]] = None,
            omap: Optional[Dict[int, int]] = None) -> Fst:
    """Relabel arcs in place (used to replace disambig symbols with eps
    after determinization, ref: fstrmsymbols)."""
    for alist in f.arcs:
        for a in alist:
            if imap is not None:
                a.ilabel = imap.get(a.ilabel, a.ilabel)
            if omap is not None:
                a.olabel = omap.get(a.olabel, a.olabel)
    return f


# --------------------------------------------------------------------------
# equivalence testing (for unit tests; ref: fst::RandEquivalent pattern)
# --------------------------------------------------------------------------

def accepts_cost(f: Fst, iseq: Sequence[int]) -> float:
    """Min cost of paths whose non-eps input sequence == iseq (ignores
    output tape). INF if rejected. Dynamic program over (state, pos)."""
    best: Dict[Tuple[int, int], float] = {}

    def relax(key, w, pq):
        if w < best.get(key, INF) - 1e-12:
            best[key] = w
            heapq.heappush(pq, (w, key))

    pq: list = []
    relax((f.start, 0), 0.0, pq)
    result = INF
    L = len(iseq)
    while pq:
        w, (s, i) = heapq.heappop(pq)
        if w > best.get((s, i), INF):
            continue
        if i == L and f.is_final(s):
            result = min(result, w + f.final[s])
        for a in f.arcs[s]:
            if a.ilabel == EPS:
                relax((a.nextstate, i), w + a.weight, pq)
            elif i < L and a.ilabel == iseq[i]:
                relax((a.nextstate, i + 1), w + a.weight, pq)
    return result


def transduce_cost(f: Fst, iseq: Sequence[int], oseq: Sequence[int]) -> float:
    """Min cost over paths with given input AND output sequences."""
    best: Dict[Tuple[int, int, int], float] = {}
    pq: list = []

    def relax(key, w):
        if w < best.get(key, INF) - 1e-12:
            best[key] = w
            heapq.heappush(pq, (w, key))

    relax((f.start, 0, 0), 0.0)
    result = INF
    Li, Lo = len(iseq), len(oseq)
    while pq:
        w, (s, i, o) = heapq.heappop(pq)
        if w > best.get((s, i, o), INF):
            continue
        if i == Li and o == Lo and f.is_final(s):
            result = min(result, w + f.final[s])
        for a in f.arcs[s]:
            ni = i
            if a.ilabel != EPS:
                if i >= Li or a.ilabel != iseq[i]:
                    continue
                ni = i + 1
            no = o
            if a.olabel != EPS:
                if o >= Lo or a.olabel != oseq[o]:
                    continue
                no = o + 1
            relax((a.nextstate, ni, no), w + a.weight)
    return result


def random_paths(f: Fst, n: int, rng: np.random.Generator,
                 max_len: int = 100):
    """Sample n random successful paths; returns (iseq, oseq, cost) lists."""
    out = []
    for _ in range(n):
        s = f.start
        iseq, oseq, cost = [], [], 0.0
        for _ in range(max_len):
            options = list(range(len(f.arcs[s])))
            stop_ok = f.is_final(s)
            if stop_ok and (not options or rng.random() < 0.3):
                out.append((iseq, oseq, cost + f.final[s]))
                break
            if not options:
                break
            a = f.arcs[s][rng.integers(len(options))]
            if a.ilabel != EPS:
                iseq.append(a.ilabel)
            if a.olabel != EPS:
                oseq.append(a.olabel)
            cost += a.weight
            s = a.nextstate
        else:
            if f.is_final(s):
                out.append((iseq, oseq, cost + f.final[s]))
    return out


def equivalent(a: Fst, b: Fst, n: int = 30,
               rng: Optional[np.random.Generator] = None,
               tol: float = 1e-3) -> bool:
    """Randomized equivalence check: paths sampled from each must have
    equal min-cost in the other (fst::RandEquivalent pattern)."""
    rng = rng or np.random.default_rng(0)
    for src, other in ((a, b), (b, a)):
        for iseq, oseq, _ in random_paths(src, n, rng):
            ca = transduce_cost(a, iseq, oseq)
            cb = transduce_cost(b, iseq, oseq)
            if not (math.isfinite(ca) and math.isfinite(cb)):
                return False
            if abs(ca - cb) > tol:
                return False
    return True
