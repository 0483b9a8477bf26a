"""Lattices: generation-side data structure + post-processing.

Clean-room equivalent of src/lat/ (kaldi-lattice.{h,cc},
lattice-functions.{h,cc}, determinize-lattice-pruned.{h,cc},
sausages.{h,cc}) re-designed for the vectorized decoder: a lattice is a
DAG in flat numpy arrays with the LatticeWeight semiring's
⟨graph-cost, acoustic-cost⟩ pair kept per arc — acoustic costs are
stored UNSCALED (raw -loglike sums), so rescoring sweeps
(ref: local/score.sh lattice-scale loop) are pure re-weighting without
touching the decoder.

States carry a frame time; ilabels are transition-ids, olabels words.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INF = np.float32(np.inf)


@dataclass
class Lattice:
    num_states: int
    start: int
    state_time: np.ndarray        # [S] int32 frame index of each state
    arc_src: np.ndarray           # [A] int32
    arc_dst: np.ndarray           # [A] int32
    arc_ilabel: np.ndarray        # [A] int32 transition-ids (0 = eps)
    arc_olabel: np.ndarray        # [A] int32 word ids (0 = eps)
    arc_graph: np.ndarray         # [A] f32 graph cost (LM + transition)
    arc_acoustic: np.ndarray      # [A] f32 raw -loglike (unscaled)
    final_graph: np.ndarray       # [S] f32 (inf = non-final)

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)

    def topo_order(self) -> np.ndarray:
        """Topological state order (raw lattices are DAGs; ref:
        TopSortLatticeIfNeeded)."""
        indeg = np.zeros(self.num_states, np.int64)
        np.add.at(indeg, self.arc_dst, 1)
        order = np.argsort(self.arc_src, kind="stable")
        src_sorted = self.arc_src[order]
        starts = np.searchsorted(src_sorted, np.arange(self.num_states))
        ends = np.searchsorted(src_sorted, np.arange(self.num_states) + 1)
        out = []
        stack = [s for s in range(self.num_states) if indeg[s] == 0]
        while stack:
            s = stack.pop()
            out.append(s)
            for k in range(starts[s], ends[s]):
                d = self.arc_dst[order[k]]
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(int(d))
        if len(out) != self.num_states:
            raise ValueError("lattice has a cycle")
        return np.asarray(out, np.int64)

    def arc_cost(self, lm_scale: float = 1.0, acoustic_scale: float = 1.0,
                 word_ins_penalty: float = 0.0) -> np.ndarray:
        """Scaled per-arc scalar cost (ref: lattice-scale +
        lattice-add-penalty collapsed into one view)."""
        return (lm_scale * self.arc_graph
                + acoustic_scale * self.arc_acoustic
                + word_ins_penalty * (self.arc_olabel > 0))

    # -- cached structure for vectorized DAG sweeps ------------------------
    def _levels(self):
        """(state depth, arcs grouped by src depth) — processing arcs in
        ascending src-depth is a valid relaxation order on a DAG, which
        turns every sweep into ~depth vectorized scatter ops instead of
        a python loop over arcs."""
        if getattr(self, "_lv_cache", None) is not None:
            return self._lv_cache
        # fast path for decoder-emitted lattices: state_time already
        # orders emitting arcs, so only the (shallow) within-time eps
        # sub-DAG needs iterating — the generic longest-path loop below
        # costs O(path_length) full-arc scatter rounds (~16 s per bench
        # batch before this)
        ts = self.state_time[self.arc_src].astype(np.int64)
        td = self.state_time[self.arc_dst].astype(np.int64)
        eps_same = (td == ts)
        if self.num_arcs == 0:
            depth = np.zeros(self.num_states, np.int64)
        elif bool(np.all((td > ts) | (eps_same & (self.arc_ilabel == 0)))):
            de = np.zeros(self.num_states, np.int64)
            esel = np.nonzero(eps_same)[0]
            esrc = self.arc_src[esel]
            edst = self.arc_dst[esel]
            for _ in range(self.num_states + 1):
                upd = np.zeros(self.num_states, np.int64)
                np.maximum.at(upd, edst, de[esrc] + 1)
                new = np.maximum(de, upd)
                if (new == de).all():
                    break
                de = new
            else:
                raise ValueError("lattice has an epsilon cycle")
            stride = int(de.max()) + 1
            depth = self.state_time.astype(np.int64) * stride + de
        else:
            depth = np.zeros(self.num_states, np.int64)
            for _ in range(self.num_states + 1):
                upd = np.zeros(self.num_states, np.int64)
                np.maximum.at(upd, self.arc_dst,
                              depth[self.arc_src] + 1)
                new = np.maximum(depth, upd)
                if (new == depth).all():
                    break
                depth = new
            else:
                raise ValueError("lattice has a cycle")
        order = np.argsort(depth[self.arc_src], kind="stable")
        src_depth_sorted = depth[self.arc_src][order]
        max_d = int(depth.max()) if self.num_states else 0
        bounds = np.searchsorted(src_depth_sorted,
                                 np.arange(max_d + 2))
        self._lv_cache = (depth, order, bounds)
        return self._lv_cache

    def sweep_min_forward(self, w: np.ndarray) -> np.ndarray:
        """Viterbi forward costs over scalar arc costs w."""
        depth, order, bounds = self._levels()
        dist = np.full(self.num_states, np.inf)
        dist[self.start] = 0.0
        for d in range(len(bounds) - 1):
            sel = order[bounds[d]:bounds[d + 1]]
            if len(sel) == 0:
                continue
            cand = dist[self.arc_src[sel]] + w[sel]
            np.minimum.at(dist, self.arc_dst[sel], cand)
        return dist

    def sweep_min_backward(self, w: np.ndarray,
                           fin: np.ndarray) -> np.ndarray:
        depth, order, bounds = self._levels()
        bwd = fin.astype(np.float64).copy()
        for d in range(len(bounds) - 2, -1, -1):
            sel = order[bounds[d]:bounds[d + 1]]
            if len(sel) == 0:
                continue
            cand = w[sel] + bwd[self.arc_dst[sel]]
            np.minimum.at(bwd, self.arc_src[sel], cand)
        return bwd


def save_lattices(path: str, lats: Dict[str, Lattice]) -> None:
    """npz archive of lattices (the native on-disk form; ref:
    lat.JOB.gz archives of steps/decode.sh)."""
    blobs = {}
    for utt, l in lats.items():
        blobs[f"{utt}.meta"] = np.asarray([l.num_states, l.start],
                                          np.int64)
        blobs[f"{utt}.time"] = l.state_time
        blobs[f"{utt}.arcs"] = np.stack(
            [l.arc_src, l.arc_dst, l.arc_ilabel, l.arc_olabel]).astype(
            np.int32)
        blobs[f"{utt}.w"] = np.stack([l.arc_graph, l.arc_acoustic])
        blobs[f"{utt}.final"] = l.final_graph
    np.savez_compressed(path, **blobs)


def load_lattices(path: str) -> Dict[str, Lattice]:
    z = np.load(path)
    utts = sorted({k.rsplit(".", 1)[0] for k in z.files})
    out = {}
    for u in utts:
        meta = z[f"{u}.meta"]
        arcs = z[f"{u}.arcs"]
        w = z[f"{u}.w"]
        out[u] = Lattice(
            num_states=int(meta[0]), start=int(meta[1]),
            state_time=z[f"{u}.time"],
            arc_src=arcs[0], arc_dst=arcs[1],
            arc_ilabel=arcs[2], arc_olabel=arcs[3],
            arc_graph=w[0], arc_acoustic=w[1],
            final_graph=z[f"{u}.final"])
    return out


def write_lattice_text(lat: Lattice, fh) -> None:
    """Kaldi text-lattice format: one arc per line
    ``src dst ilabel olabel graph,acoustic,`` and final lines
    ``state graph,0,`` (ref: kaldi-lattice.cc LatticeWriter text
    mode) — for interop/debugging."""
    for a in range(lat.num_arcs):
        fh.write(f"{lat.arc_src[a]} {lat.arc_dst[a]} "
                 f"{lat.arc_ilabel[a]} {lat.arc_olabel[a]} "
                 f"{lat.arc_graph[a]:.6g},{lat.arc_acoustic[a]:.6g},\n")
    for s in range(lat.num_states):
        if np.isfinite(lat.final_graph[s]):
            fh.write(f"{s} {lat.final_graph[s]:.6g},0,\n")


def _in_arc_groups(lat: Lattice):
    if getattr(lat, "_in_cache", None) is None:
        order = np.argsort(lat.arc_dst, kind="stable")
        bounds = np.searchsorted(lat.arc_dst[order],
                                 np.arange(lat.num_states + 1))
        lat._in_cache = (order, bounds)
    return lat._in_cache


def shortest_path(lat: Lattice, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0,
                  word_ins_penalty: float = 0.0
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Best path under scaled costs -> (tids, word ids, total cost)
    (ref: lattice-best-path.cc).  Vectorized level sweeps; the path is
    recovered by walking in-arcs backward from the best final state."""
    w = lat.arc_cost(lm_scale, acoustic_scale,
                     word_ins_penalty).astype(np.float64)
    dist = lat.sweep_min_forward(w)
    total = dist + np.where(np.isfinite(lat.final_graph),
                            lm_scale * lat.final_graph, np.inf)
    best = int(np.argmin(total))
    if not np.isfinite(total[best]):
        return np.zeros(0, np.int32), np.zeros(0, np.int32), float("inf")
    in_order, in_bounds = _in_arc_groups(lat)
    tids, words = [], []
    s = best
    guard = 0
    while s != lat.start or dist[s] > 0.0:
        arcs = in_order[in_bounds[s]:in_bounds[s + 1]]
        cand = dist[lat.arc_src[arcs]] + w[arcs]
        a = int(arcs[int(np.argmin(np.abs(cand - dist[s])))])
        if lat.arc_ilabel[a] > 0:
            tids.append(int(lat.arc_ilabel[a]))
        if lat.arc_olabel[a] > 0:
            words.append(int(lat.arc_olabel[a]))
        s = int(lat.arc_src[a])
        guard += 1
        if guard > lat.num_arcs + 1:
            raise RuntimeError("backtrace loop")
    return (np.asarray(tids[::-1], np.int32),
            np.asarray(words[::-1], np.int32), float(total[best]))


def _alpha_beta(lat: Lattice, w: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Log-semiring forward/backward state scores over scalar costs
    (ref: lattice-functions.cc LatticeForwardBackward; here in -cost =
    logprob domain), as vectorized level sweeps."""
    depth, order, bounds = lat._levels()
    alpha = np.full(lat.num_states, -np.inf, np.float64)
    alpha[lat.start] = 0.0
    for d in range(len(bounds) - 1):
        sel = order[bounds[d]:bounds[d + 1]]
        if len(sel) == 0:
            continue
        np.logaddexp.at(alpha, lat.arc_dst[sel],
                        alpha[lat.arc_src[sel]] - w[sel])
    fin = np.where(np.isfinite(lat.final_graph),
                   -lat.final_graph.astype(np.float64), -np.inf)
    beta = fin.copy()
    for d in range(len(bounds) - 2, -1, -1):
        sel = order[bounds[d]:bounds[d + 1]]
        if len(sel) == 0:
            continue
        np.logaddexp.at(beta, lat.arc_src[sel],
                        beta[lat.arc_dst[sel]] - w[sel])
    tot = float(np.logaddexp.reduce(alpha + fin))
    return alpha, beta, tot


def arc_posteriors(lat: Lattice, lm_scale: float = 1.0,
                   acoustic_scale: float = 0.1) -> np.ndarray:
    """[A] posterior probability of each arc
    (ref: LatticeForwardBackward -> Posterior)."""
    w = lat.arc_cost(lm_scale, acoustic_scale).astype(np.float64)
    alpha, beta, tot = _alpha_beta(lat, w)
    logp = alpha[lat.arc_src] - w + beta[lat.arc_dst] - tot
    return np.exp(np.clip(logp, -745, 0))


def prune_lattice(lat: Lattice, beam: float, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0) -> Lattice:
    """Keep arcs on paths within ``beam`` of the best path
    (ref: lattice-prune.cc PruneLattice)."""
    w = lat.arc_cost(lm_scale, acoustic_scale).astype(np.float64)
    fwd = lat.sweep_min_forward(w)
    fin = np.where(np.isfinite(lat.final_graph),
                   lm_scale * lat.final_graph, np.inf)
    bwd = lat.sweep_min_backward(w, fin)
    best = float(np.min(fwd + bwd))
    keep = fwd[lat.arc_src] + w + bwd[lat.arc_dst] <= best + beam
    return _sub_lattice(lat, keep)


def _sub_lattice(lat: Lattice, arc_keep: np.ndarray) -> Lattice:
    used = np.zeros(lat.num_states, bool)
    used[lat.start] = True
    used[lat.arc_src[arc_keep]] = True
    used[lat.arc_dst[arc_keep]] = True
    remap = np.cumsum(used) - 1
    return Lattice(
        num_states=int(used.sum()),
        start=int(remap[lat.start]),
        state_time=lat.state_time[used],
        arc_src=remap[lat.arc_src[arc_keep]].astype(np.int32),
        arc_dst=remap[lat.arc_dst[arc_keep]].astype(np.int32),
        arc_ilabel=lat.arc_ilabel[arc_keep],
        arc_olabel=lat.arc_olabel[arc_keep],
        arc_graph=lat.arc_graph[arc_keep],
        arc_acoustic=lat.arc_acoustic[arc_keep],
        final_graph=lat.final_graph[used],
    )


def nbest(lat: Lattice, n: int, lm_scale: float = 1.0,
          acoustic_scale: float = 1.0, word_ins_penalty: float = 0.0,
          unique_words: bool = True
          ) -> List[Tuple[List[int], float]]:
    """N best (word sequence, cost) pairs via A* over the lattice with
    exact backward heuristic (ref: lattice-nbest.cc + ShortestPath)."""
    import heapq
    w = lat.arc_cost(lm_scale, acoustic_scale, word_ins_penalty).astype(
        np.float64)
    fin = np.where(np.isfinite(lat.final_graph),
                   lm_scale * lat.final_graph, np.inf)
    bwd = lat.sweep_min_backward(w, fin)
    arc_by_src: Dict[int, List[int]] = {}
    for a in range(lat.num_arcs):
        arc_by_src.setdefault(int(lat.arc_src[a]), []).append(a)
    if not np.isfinite(bwd[lat.start]):
        return []
    heap = [(float(bwd[lat.start]), 0.0, lat.start, ())]
    out: List[Tuple[List[int], float]] = []
    seen_words = set()
    pops = 0
    while heap and len(out) < n and pops < 200000:
        f, g, s, words = heapq.heappop(heap)
        pops += 1
        if np.isfinite(fin[s]) and g + fin[s] <= f + 1e-9:
            key = words
            if not unique_words or key not in seen_words:
                seen_words.add(key)
                out.append((list(words), g + float(fin[s])))
        for a in arc_by_src.get(int(s), ()):
            d = int(lat.arc_dst[a])
            ng = g + float(w[a])
            nw = words + ((int(lat.arc_olabel[a]),)
                          if lat.arc_olabel[a] > 0 else ())
            heapq.heappush(heap, (ng + float(bwd[d]), ng, d, nw))
    return out


def determinize_lattice(lat: Lattice, lm_scale: float = 1.0,
                        acoustic_scale: float = 0.1,
                        max_paths: int = 200) -> Lattice:
    """Word-level determinization: one path per distinct word sequence,
    keeping the best-scoring alignment (ref:
    determinize-lattice-pruned.cc DeterminizeLatticePruned — same
    contract, realized by ranked path extraction instead of on-the-fly
    subset determinization; lattices here are per-utterance and
    beam-pruned, so the path count is modest)."""
    import heapq
    w = lat.arc_cost(lm_scale, acoustic_scale).astype(np.float64)
    fin = np.where(np.isfinite(lat.final_graph),
                   lm_scale * lat.final_graph, np.inf)
    bwd = lat.sweep_min_backward(w, fin)
    arc_by_src: Dict[int, List[int]] = {}
    for a in range(lat.num_arcs):
        arc_by_src.setdefault(int(lat.arc_src[a]), []).append(a)
    # heap entries carry a monotonic tiebreak so comparisons never
    # descend into the word/arc tuples, and (state, word-history)
    # dominance pruning keeps only the best alignment per subset-state
    # — the on-the-fly pruning DeterminizeLatticePruned gets from its
    # subset construction, which is what bounds the pop count
    heap = [(float(bwd[lat.start]), 0, 0.0, lat.start, (), ())]
    best_by_words: Dict[Tuple, Tuple[float, Tuple[int, ...]]] = {}
    seen: Dict[Tuple, float] = {}
    pops = 0
    tie = 0
    while heap and len(best_by_words) < max_paths and pops < 200000:
        f, _, g, s, words, arcs = heapq.heappop(heap)
        pops += 1
        key = (s, words)
        prev = seen.get(key)
        if prev is not None and g > prev + 1e-9:
            continue                       # dominated alignment
        seen[key] = g if prev is None else min(prev, g)
        if np.isfinite(fin[s]):
            tot = g + float(fin[s])
            if words not in best_by_words:
                best_by_words[words] = (tot, arcs)
        for a in arc_by_src.get(int(s), ()):
            d = int(lat.arc_dst[a])
            ng = g + float(w[a])
            nw = words + ((int(lat.arc_olabel[a]),)
                          if lat.arc_olabel[a] > 0 else ())
            nkey = (d, nw)
            nprev = seen.get(nkey)
            if nprev is not None and ng > nprev + 1e-9:
                continue
            tie += 1
            heapq.heappush(heap, (ng + float(bwd[d]), tie, ng, d, nw,
                                  arcs + (a,)))
    if not best_by_words and np.isfinite(bwd[lat.start]):
        # the pop budget ran out before any word sequence reached a final
        # state (a large, flat lattice): the raw lattice's best path,
        # which the backward costs give exactly
        best_by_words = _best_path_by_words(lat, w, fin, bwd, arc_by_src)
    # rebuild a union-of-paths lattice (prefix-shared)
    return _paths_to_lattice(lat, best_by_words)


def _best_path_by_words(lat: Lattice, w: np.ndarray, fin: np.ndarray,
                        bwd: np.ndarray, arc_by_src: Dict[int, List[int]]
                        ) -> Dict[Tuple, Tuple[float, Tuple[int, ...]]]:
    """{words: (cost, arcs)} of the lattice's best path, walked forward
    from the start along the arcs that attain the backward costs ``bwd``
    (the first such arc on a tie), stopping where the final cost does."""
    s, g = lat.start, 0.0
    words: Tuple[int, ...] = ()
    arcs: Tuple[int, ...] = ()
    for _ in range(lat.num_arcs + 1):
        out = arc_by_src.get(int(s), ())
        via = [float(w[a]) + float(bwd[lat.arc_dst[a]]) for a in out]
        if not via or fin[s] <= min(via):
            return {words: (g + float(fin[s]), arcs)}
        a = out[int(np.argmin(via))]
        g += float(w[a])
        if lat.arc_olabel[a] > 0:
            words = words + (int(lat.arc_olabel[a]),)
        arcs = arcs + (a,)
        s = int(lat.arc_dst[a])
    raise RuntimeError("best-path walk did not end: the lattice has a cycle")


def _paths_to_lattice(lat: Lattice,
                      best_by_words: Dict[Tuple, Tuple[float, Tuple]]
                      ) -> Lattice:
    states: Dict[Tuple, int] = {(): 0}
    times = [0]
    a_src, a_dst, a_il, a_ol, a_g, a_ac = [], [], [], [], [], []
    finals: Dict[int, float] = {}
    for words, (tot, arcs) in best_by_words.items():
        prefix = ()
        cur = 0
        for a in arcs:
            prefix = prefix + (a,)
            nxt = states.get(prefix)
            if nxt is None:
                nxt = len(states)
                states[prefix] = nxt
                times.append(int(lat.state_time[lat.arc_dst[a]]))
                a_src.append(cur)
                a_dst.append(nxt)
                a_il.append(int(lat.arc_ilabel[a]))
                a_ol.append(int(lat.arc_olabel[a]))
                a_g.append(float(lat.arc_graph[a]))
                a_ac.append(float(lat.arc_acoustic[a]))
            cur = nxt
        finals[cur] = float(lat.final_graph[
            lat.arc_dst[arcs[-1]]] if arcs else lat.final_graph[lat.start])
    n = len(states)
    fg = np.full(n, np.inf, np.float32)
    for s, v in finals.items():
        fg[s] = v
    return Lattice(
        num_states=n, start=0,
        state_time=np.asarray(times, np.int32),
        arc_src=np.asarray(a_src, np.int32),
        arc_dst=np.asarray(a_dst, np.int32),
        arc_ilabel=np.asarray(a_il, np.int32),
        arc_olabel=np.asarray(a_ol, np.int32),
        arc_graph=np.asarray(a_g, np.float32),
        arc_acoustic=np.asarray(a_ac, np.float32),
        final_graph=fg,
    )


def confusion_network(lat: Lattice, lm_scale: float = 1.0,
                      acoustic_scale: float = 0.1
                      ) -> List[List[Tuple[int, float]]]:
    """Sausage / confusion network: time-ordered bins of
    (word, posterior), eps = 0 (ref: src/lat/sausages.{h,cc}
    MinimumBayesRisk — realized by posterior-weighted time clustering
    of word arcs; MBR decode = per-bin argmax)."""
    post = arc_posteriors(lat, lm_scale, acoustic_scale)
    word_arcs = np.nonzero(lat.arc_olabel > 0)[0]
    if len(word_arcs) == 0:
        return []
    items = []
    for a in word_arcs:
        t0 = float(lat.state_time[lat.arc_src[a]])
        t1 = float(lat.state_time[lat.arc_dst[a]])
        items.append((0.5 * (t0 + t1), t0, t1, int(lat.arc_olabel[a]),
                      float(post[a])))
    items.sort()
    bins: List[Dict] = []
    for mid, t0, t1, word, p in items:
        placed = False
        for b in bins:
            # same word overlapping in time merges; else overlap with
            # bin midpoint opens competition in the same slot
            if t0 < b["t1"] and t1 > b["t0"]:
                b["words"][word] = b["words"].get(word, 0.0) + p
                b["t0"] = min(b["t0"], t0)
                b["t1"] = max(b["t1"], t1)
                b["mass"] += p
                placed = True
                break
        if not placed:
            bins.append({"t0": t0, "t1": t1, "mass": p,
                         "words": {word: p}})
    out = []
    for b in sorted(bins, key=lambda x: x["t0"]):
        eps_mass = max(0.0, 1.0 - b["mass"])
        slot = sorted(b["words"].items(), key=lambda kv: -kv[1])
        if eps_mass > 1e-6:
            slot.append((0, eps_mass))
            slot.sort(key=lambda kv: -kv[1])
        out.append(slot)
    return out


def mbr_decode(lat: Lattice, lm_scale: float = 1.0,
               acoustic_scale: float = 0.1) -> List[int]:
    """Minimum-Bayes-risk word sequence: per-sausage-bin argmax,
    dropping eps (ref: sausages.cc MinimumBayesRisk::GetOneBest)."""
    cn = confusion_network(lat, lm_scale, acoustic_scale)
    out = []
    for slot in cn:
        word, p = slot[0]
        if word != 0:
            out.append(word)
    return out


def push_lattice(lat: Lattice) -> Lattice:
    """Weight pushing toward the initial state (ref: push-lattice.cc
    PushCompactLatticeWeights): after pushing, the minimum cost from
    every co-accessible state to a final state is zero, so partial-path
    costs are meaningful prefixes of total costs.  The potential is
    computed in the combined (graph + acoustic) tropical semiring and
    applied to the graph component only, so per-arc acoustic costs stay
    raw/rescorable; total path costs are preserved exactly (the start
    potential is re-added on arcs leaving the start state, mirroring
    the reference's keep-total-weight behavior)."""
    w = (lat.arc_graph.astype(np.float64)
         + lat.arc_acoustic.astype(np.float64))
    fin = np.where(np.isfinite(lat.final_graph),
                   lat.final_graph.astype(np.float64), np.inf)
    phi = lat.sweep_min_backward(w, fin)        # min cost to final
    phi_safe = np.where(np.isfinite(phi), phi, 0.0)
    new_graph = (lat.arc_graph.astype(np.float64)
                 + phi_safe[lat.arc_dst] - phi_safe[lat.arc_src])
    start_arcs = lat.arc_src == lat.start
    new_graph[start_arcs] += phi_safe[lat.start]
    new_final = np.where(np.isfinite(lat.final_graph),
                         lat.final_graph.astype(np.float64) - phi_safe,
                         np.inf)
    # a final start state also carries the start potential back
    if np.isfinite(lat.final_graph[lat.start]):
        new_final[lat.start] += phi_safe[lat.start]
    out = Lattice(
        num_states=lat.num_states, start=lat.start,
        state_time=lat.state_time,
        arc_src=lat.arc_src, arc_dst=lat.arc_dst,
        arc_ilabel=lat.arc_ilabel, arc_olabel=lat.arc_olabel,
        arc_graph=new_graph.astype(np.float32),
        arc_acoustic=lat.arc_acoustic,
        final_graph=new_final.astype(np.float32))
    return out


def minimize_lattice(lat: Lattice) -> Lattice:
    """Suffix-sharing state merge (ref: minimize-lattice.cc
    MinimizeLattice): states whose outgoing arc sets (labels, weights,
    destination class) and final weights are identical are merged.
    Classic backward hash refinement; exact on DAGs, preserves every
    path with its weights."""
    order = lat.topo_order()[::-1]               # reverse topological
    out_order = np.argsort(lat.arc_src, kind="stable")
    starts = np.searchsorted(lat.arc_src[out_order],
                             np.arange(lat.num_states))
    ends = np.searchsorted(lat.arc_src[out_order],
                           np.arange(lat.num_states) + 1)
    cls = np.full(lat.num_states, -1, np.int64)
    sig_to_cls: Dict[tuple, int] = {}
    for s in order:
        arcs = out_order[starts[s]:ends[s]]
        sig_arcs = tuple(sorted(
            (int(lat.arc_ilabel[a]), int(lat.arc_olabel[a]),
             round(float(lat.arc_graph[a]), 6),
             round(float(lat.arc_acoustic[a]), 6),
             int(cls[lat.arc_dst[a]]))
            for a in arcs))
        f = float(lat.final_graph[s])
        sig = (round(f, 6) if np.isfinite(f) else None, sig_arcs)
        c = sig_to_cls.get(sig)
        if c is None:
            c = len(sig_to_cls)
            sig_to_cls[sig] = c
        cls[int(s)] = c
    # one representative state per class, reached classes only
    keep_cls = np.zeros(len(sig_to_cls), bool)
    keep_cls[cls[lat.start]] = True
    src_cls, dst_cls = cls[lat.arc_src], cls[lat.arc_dst]
    for _ in range(lat.num_states):
        prev = keep_cls.copy()
        keep_cls[dst_cls[keep_cls[src_cls]]] = True
        if (prev == keep_cls).all():
            break
    rep = np.full(len(sig_to_cls), -1, np.int64)
    for s in range(lat.num_states - 1, -1, -1):
        rep[cls[s]] = s                           # earliest state wins
    new_id = np.cumsum(keep_cls) - 1
    keep_state = np.zeros(lat.num_states, bool)
    keep_state[rep[keep_cls]] = True
    arc_keep = keep_state[lat.arc_src]
    kept = np.nonzero(keep_cls)[0]
    return Lattice(
        num_states=int(keep_cls.sum()),
        start=int(new_id[cls[lat.start]]),
        state_time=lat.state_time[rep[kept]],
        arc_src=new_id[cls[lat.arc_src[arc_keep]]].astype(np.int32),
        arc_dst=new_id[cls[lat.arc_dst[arc_keep]]].astype(np.int32),
        arc_ilabel=lat.arc_ilabel[arc_keep],
        arc_olabel=lat.arc_olabel[arc_keep],
        arc_graph=lat.arc_graph[arc_keep],
        arc_acoustic=lat.arc_acoustic[arc_keep],
        final_graph=lat.final_graph[rep[kept]])


def lm_rescore(lat: Lattice, lm, scale: float = 1.0) -> Lattice:
    """Compose the lattice with an n-gram LM over word labels,
    adding ``scale * -log p(word | history)`` to the graph cost of each
    word arc and ``scale * -log p(</s> | history)`` at finals
    (ref: lattice-lmrescore-const-arpa.cc; run once with the old LM at
    scale=-1 and once with the new LM at scale=+1 to swap LMs, exactly
    the reference's lattice-lmrescore flow).  ``lm`` is a
    :class:`~kaldi_cnn_tpu_torch.lang.const_arpa.ConstArpaLm` over the same
    word ids as the lattice olabels.  States are expanded to
    (state, LM history) pairs, so higher-order LMs split lattice states
    as needed."""
    from collections import deque
    out_order = np.argsort(lat.arc_src, kind="stable")
    starts = np.searchsorted(lat.arc_src[out_order],
                             np.arange(lat.num_states))
    ends = np.searchsorted(lat.arc_src[out_order],
                           np.arange(lat.num_states) + 1)
    init_hist = lm.advance((), lm.bos_id)
    state_of: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    times: List[int] = []
    a_src, a_dst, a_il, a_ol = [], [], [], []
    a_g, a_ac = [], []
    finals: Dict[int, float] = {}

    def get_state(s: int, h: Tuple[int, ...]) -> int:
        key = (s, h)
        i = state_of.get(key)
        if i is None:
            i = len(state_of)
            state_of[key] = i
            times.append(int(lat.state_time[s]))
        return i

    start_id = get_state(lat.start, init_hist)
    queue = deque([(lat.start, init_hist)])
    seen = {(lat.start, init_hist)}
    while queue:
        s, h = queue.popleft()
        sid = state_of[(s, h)]
        if np.isfinite(lat.final_graph[s]):
            lp = lm.log_prob(list(h), lm.eos_id)
            add = scale * -(lp if np.isfinite(lp) else -100.0)
            finals[sid] = float(lat.final_graph[s]) + add
        for k in range(starts[s], ends[s]):
            a = out_order[k]
            word = int(lat.arc_olabel[a])
            if word > 0:
                lp = lm.log_prob(list(h), word)
                add = scale * -(lp if np.isfinite(lp) else -100.0)
                nh = lm.advance(h, word)
            else:
                add = 0.0
                nh = h
            d = int(lat.arc_dst[a])
            did = get_state(d, nh)
            a_src.append(sid)
            a_dst.append(did)
            a_il.append(int(lat.arc_ilabel[a]))
            a_ol.append(word)
            a_g.append(float(lat.arc_graph[a]) + add)
            a_ac.append(float(lat.arc_acoustic[a]))
            if (d, nh) not in seen:
                seen.add((d, nh))
                queue.append((d, nh))
    n = len(state_of)
    fg = np.full(n, np.inf, np.float32)
    for s, v in finals.items():
        fg[s] = v
    return Lattice(
        num_states=n, start=start_id,
        state_time=np.asarray(times, np.int32),
        arc_src=np.asarray(a_src, np.int32),
        arc_dst=np.asarray(a_dst, np.int32),
        arc_ilabel=np.asarray(a_il, np.int32),
        arc_olabel=np.asarray(a_ol, np.int32),
        arc_graph=np.asarray(a_g, np.float32),
        arc_acoustic=np.asarray(a_ac, np.float32),
        final_graph=fg)


def word_alignment(lat: Lattice, tids: np.ndarray, words: np.ndarray,
                   trans_model) -> List[Tuple[int, int, int]]:
    """(word, start_frame, num_frames) for a best path
    (ref: word-align-lattice.cc, best-path case): word boundaries taken
    at the word-emitting arcs' source-state times."""
    # re-walk the best path cheaply: words were emitted in order; use
    # phone segmentation to attribute frames
    from kaldi_cnn_tpu_torch.tree.stats import split_to_phones
    segs = split_to_phones(trans_model, tids)
    # simple attribution: divide the phone segments evenly over words
    if len(words) == 0:
        return []
    starts = [fr[0] for _, fr in segs]
    bounds = np.linspace(0, len(segs), len(words) + 1).astype(int)
    out = []
    for i, wd in enumerate(words):
        s0 = starts[bounds[i]] if bounds[i] < len(segs) else len(tids)
        s1 = (starts[bounds[i + 1]] if bounds[i + 1] < len(segs)
              else len(tids))
        out.append((int(wd), int(s0), int(s1 - s0)))
    return out
