"""Where a recipe's deleted words go: the diagnostic scripts' shared
classification of the test utterances that lose words.

``Recorder`` wraps a recipe's ``decode_utterances`` (the name the recipe
module looks up) and keeps each call's graph, loglikes, settings and
lattices: a recipe decodes dev first and test last.  ``classify``
decodes the test call's loglikes again with the port under ``Probe``,
which keeps, for every utterance, what the decoder's lattice steps did,
and sorts each utterance that has a deletion at the recipe's operating
point into exactly one class:

  i    no_final      no token at the last frame was in a final state of
                     the graph (``TopKDecoder._assemble_lattice`` then
                     makes the last frame's states final at cost 0)
  ii   pop_budget    ``determinize_lattice`` ran out of heap pops before
                     any word sequence reached a final state and took its
                     best-path fallback
  iii  lost          the raw lattice has a path with the reference words
                     and the pruned or the determinized one has none
  iv   not_in_raw    no path of the raw lattice has the reference words
  v    outscored     every lattice has such a path, and it costs more at
                     the operating point than the best path

With ``wide`` it decodes the deleted utterances again with a wider
search (lattice beam 16, ``max_active`` 7000, acoustic scale 0.2), and
with each of the three changes alone; for the first ``host_subset`` of
them, with the host ``lattice_decode`` at the recipe's settings and no
cap on the active states, whose raw lattice (no lattice-beam prune) is
searched for the reference words too; it counts what each gives back.  It
also counts the deleted words by word against each word's count in the
training transcripts, and how many of them repeat a neighbour.

``save_inputs`` / ``load_inputs`` keep a decode's graph, loglikes and
point in one ``.npz``, which either package can decode
(``decode_inputs``), so that the two packages' words are compared on the
same inputs.  Only ``classify`` needs the port; the rest reads the
package it is given.
"""

from __future__ import annotations

import importlib
import json
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

PORT = "kaldi_cnn_tpu_torch"
GRAPH_KEYS = ("e_src", "e_dst", "e_ilabel", "e_olabel", "e_weight", "e_pdf",
              "n_src", "n_dst", "n_olabel", "n_weight", "final")
CLASSES = ("no_final", "pop_budget", "lost", "not_in_raw", "outscored")
WIDE = dict(acoustic_scale=0.2, beam=60.0, lattice_beam=16.0,
            max_active=7000)
# the wide search's changes one at a time
ONE_CHANGE = (("lattice_beam", 16.0), ("max_active", 7000),
              ("acoustic_scale", 0.2))


def gpu_name() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


class Recorder:
    """Within the block, ``lib.decode_utterances`` (or, where ``lib`` looks
    it up at call time, ``<package>.decode.topk_decoder``'s) keeps each
    call in ``calls``: {"graph", "loglikes", "kwargs", "lats"}."""

    def __init__(self, lib, package: str):
        self.owner = (lib if hasattr(lib, "decode_utterances") else
                      importlib.import_module(
                          f"{package}.decode.topk_decoder"))
        self.calls: List[dict] = []

    def __enter__(self):
        fn = self.saved = self.owner.decode_utterances

        def wrapper(graph, loglikes, *args, **kwargs):
            out = fn(graph, loglikes, *args, **kwargs)
            self.calls.append(dict(graph=graph, loglikes=dict(loglikes),
                                   args=args, kwargs=kwargs, lats=out))
            return out
        self.owner.decode_utterances = wrapper
        return self

    def __exit__(self, *exc):
        self.owner.decode_utterances = self.saved


def test_deleted(package: str, call: dict, refs, word_table, point
                 ) -> Dict[str, int]:
    """{utt: deletions} of ``call``'s lattices at ``point``, by
    ``package``'s own ``shortest_path``."""
    shortest_path = importlib.import_module(
        f"{package}.decode.lattice").shortest_path
    out = {}
    for u, lat in call["lats"].items():
        _, wids, _ = shortest_path(lat, 1.0, point[0], point[1])
        n = len(deleted_indices(refs[u],
                                [word_table.sym(int(w)) for w in wids]))
        if n:
            out[u] = n
    return out


def deleted_indices(ref: Sequence, hyp: Sequence) -> List[int]:
    """The reference positions that ``decode.score.edit_distance``'s
    backtrace counts as deletions (its cost and tie rule)."""
    m, n = len(ref), len(hyp)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            dp[i, j] = min(dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                           dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    i, j, out = m, n, []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            out.append(i - 1)
            i -= 1
        else:
            j -= 1
    return out[::-1]


def ref_cost(lat, wids: Sequence[int], acoustic_scale: float,
             wip: float = 0.0) -> float:
    """The least cost at (acoustic scale, word insertion penalty) of a
    path of ``lat`` whose words are ``wids`` (inf: none), by a forward
    sweep over (state, words matched so far) in the lattice's levels."""
    L = len(wids)
    if lat.num_states == 0:
        return float("inf")
    w = lat.arc_cost(1.0, acoustic_scale, wip).astype(np.float64)
    _, order, bounds = lat._levels()
    cost = np.full((lat.num_states, L + 1), np.inf)
    cost[lat.start, 0] = 0.0
    ref = np.asarray(wids, np.int64)
    for d in range(len(bounds) - 1):
        sel = order[bounds[d]:bounds[d + 1]]
        if len(sel) == 0:
            continue
        ol = lat.arc_olabel[sel]
        cand = cost[lat.arc_src[sel]] + w[sel, None]
        eps = ol == 0
        np.minimum.at(cost, lat.arc_dst[sel[eps]], cand[eps])
        if (~eps).any():
            hit = ref[None, :] == ol[~eps, None]
            moved = np.full((int((~eps).sum()), L + 1), np.inf)
            moved[:, 1:] = np.where(hit, cand[~eps, :L], np.inf)
            np.minimum.at(cost, lat.arc_dst[sel[~eps]], moved)
    fin = np.where(np.isfinite(lat.final_graph), lat.final_graph, np.inf)
    return float(np.min(cost[:, L] + fin))


class Probe:
    """Within the block, each lattice the port's ``TopKDecoder`` assembles
    appends a row to ``rows``: {"final": a token at the last frame was in
    a final state, "raw": the lattice before the lattice-beam prune,
    "pruned": after it, "fallback": determinize took its best-path
    fallback, "det": the determinized lattice}."""

    def __init__(self):
        self.rows: List[dict] = []
        self._det = 0
        self._fallbacks = 0

    def __enter__(self):
        td = importlib.import_module(f"{PORT}.decode.topk_decoder")
        lt = importlib.import_module(f"{PORT}.decode.lattice")
        self._mods = (td, lt)
        self._saved = (td.TopKDecoder._assemble_lattice, td.prune_lattice,
                       td.determinize_lattice, lt._best_path_by_words)
        asm, prune, det, fallback = self._saved
        probe = self

        def assemble(dec, fetch, am, T, b):
            fs = np.asarray(fetch["fsT"][b])
            fs = fs[fs != td.INVALID]
            probe.rows.append({"final": bool(
                np.isfinite(dec.g.final[fs]).any())})
            return asm(dec, fetch, am, T, b)

        def pruned(lat, *args, **kwargs):
            out = prune(lat, *args, **kwargs)
            probe.rows[-1].update(raw=lat, pruned=out)
            return out

        def determinized(lat, *args, **kwargs):
            row = probe.rows[probe._det]
            probe._det += 1
            n = probe._fallbacks
            out = det(lat, *args, **kwargs)
            row.update(fallback=probe._fallbacks > n, det=out)
            return out

        def best_path(*args, **kwargs):
            probe._fallbacks += 1
            return fallback(*args, **kwargs)

        td.TopKDecoder._assemble_lattice = assemble
        td.prune_lattice = pruned
        td.determinize_lattice = determinized
        lt._best_path_by_words = best_path
        return self

    def __exit__(self, *exc):
        td, lt = self._mods
        (td.TopKDecoder._assemble_lattice, td.prune_lattice,
         td.determinize_lattice, lt._best_path_by_words) = self._saved


def _words(lat, point, word_table, shortest_path) -> List[str]:
    _, wids, _ = shortest_path(lat, 1.0, point[0], point[1])
    return [word_table.sym(int(w)) for w in wids]


def _dels(refs, hyps) -> int:
    return sum(len(deleted_indices(refs[u], hyps[u])) for u in hyps)


def _settings(call: dict) -> dict:
    kw = {k: v for k, v in call["kwargs"].items()
          if k not in ("group", "device", "decoder", "mesh")}
    names = ("acoustic_scale", "beam", "lattice_beam", "max_active",
             "lattice_arcs_per_frame", "batch_size")
    kw.update(zip(names, call["args"]))
    return kw


def classify(call: dict, refs: Dict[str, List[str]], word_table,
             point, train_transcripts: Dict[str, List[str]], device,
             wide: bool = False, host_subset: int = 0) -> dict:
    """The classification of ``call``'s deleted utterances (module doc):
    class counts, the deletions in emptied utterances and inside others,
    the pop-budget fallbacks over the whole set, the deleted words by
    word, and with ``wide`` / ``host_subset`` what the wider searches
    give back.  The port decodes ``call``'s loglikes again on ``device``
    and must give the recipe's words."""
    from kaldi_cnn_tpu_torch.decode.decoder import lattice_decode
    from kaldi_cnn_tpu_torch.decode.lattice import (determinize_lattice,
                                                    prune_lattice,
                                                    shortest_path)
    from kaldi_cnn_tpu_torch.decode.topk_decoder import decode_utterances
    t0 = time.perf_counter()
    graph, lls = call["graph"], call["loglikes"]
    kw = _settings(call)
    scale, wip = point
    with Probe() as probe:
        lats = decode_utterances(graph, lls, **kw, device=device)
    rows = dict(zip(lats, probe.rows))
    hyps = {u: _words(lats[u], point, word_table, shortest_path)
            for u in lats}
    recipe = {u: _words(lat, point, word_table, shortest_path)
              for u, lat in (call["lats"] or {}).items()}
    mismatch = sorted(u for u in recipe if recipe[u] != hyps.get(u))
    classes: Dict[str, List[str]] = {c: [] for c in CLASSES}
    gaps, emptied, inside, deleted_words, repeats = [], 0, 0, Counter(), 0
    per_utt = {}
    for u in sorted(refs):
        ref, hyp = refs[u], hyps.get(u, [])
        idx = deleted_indices(ref, hyp)
        if not idx:
            continue
        row = rows[u]
        wids = [word_table.id(x) for x in ref]
        costs = {k: ref_cost(row[k], wids, scale, wip)
                 for k in ("raw", "pruned", "det")}
        if not row["final"]:
            c = "no_final"
        elif row["fallback"]:
            c = "pop_budget"
        elif not np.isfinite(costs["raw"]):
            c = "not_in_raw"
        elif not np.isfinite(costs["det"]):
            c = "lost"
        else:
            c = "outscored"
            _, _, best = shortest_path(row["det"], 1.0, scale, wip)
            gaps.append(costs["det"] - best)
        classes[c].append(u)
        if hyp:
            inside += len(idx)
        else:
            emptied += len(idx)
        for i in idx:
            deleted_words[ref[i]] += 1
            repeats += int((i > 0 and ref[i - 1] == ref[i])
                           or (i + 1 < len(ref) and ref[i + 1] == ref[i]))
        per_utt[u] = {"class": c, "ref": ref, "hyp": hyp,
                      "deleted": [ref[i] for i in idx],
                      "raw_arcs": int(row["raw"].num_arcs),
                      "in_pruned": bool(np.isfinite(costs["pruned"]))}
    train_count = Counter(w for ws in train_transcripts.values() for w in ws)
    test_count = Counter(w for ws in refs.values() for w in ws)
    out = {
        "utts": len(refs), "deleted_utts": len(per_utt),
        "deletions": emptied + inside,
        "emptied_utts": sum(1 for v in per_utt.values() if not v["hyp"]),
        "deletions_in_emptied": emptied, "deletions_inside": inside,
        "deletions_repeating_a_neighbour": repeats,
        "classes": {c: len(v) for c, v in classes.items()},
        "lost_in_prune": sum(1 for u in classes["lost"]
                             if not per_utt[u]["in_pruned"]),
        "outscored_gap": ([float(np.min(gaps)), float(np.median(gaps)),
                           float(np.max(gaps))] if gaps else None),
        "fallbacks": sum(1 for r in probe.rows if r["fallback"]),
        "no_final_utts": sum(1 for r in probe.rows if not r["final"]),
        "redecode_mismatches": len(mismatch),
        "by_word": {w: [deleted_words[w], test_count[w], train_count[w]]
                    for w in sorted(test_count)},
        "per_utt": per_utt,
    }
    deleted = sorted(per_utt)
    wids = {u: [word_table.id(x) for x in refs[u]] for u in deleted}

    def search(**change):
        """The deleted utterances decoded with ``change`` to the recipe's
        settings: deletions at the point, and lattices with the
        reference."""
        lats = decode_utterances(graph, {u: lls[u] for u in deleted},
                                 **{**kw, **change}, device=device)
        hyp = {u: _words(lats[u], point, word_table, shortest_path)
               for u in deleted}
        return {"deletions_after": _dels(refs, hyp),
                "utts_whose_lattice_has_the_reference": sum(
                    1 for u in deleted if np.isfinite(ref_cost(
                        lats[u], wids[u], scale, wip)))}

    if wide and deleted:
        out["wide"] = {**WIDE, "utts": len(deleted),
                       "deletions_before": out["deletions"], **search(
                           **{k: v for k, v in WIDE.items()
                              if k != "beam"})}
        out["one_change"] = {f"{k} {v}": search(**{k: v})
                             for k, v in ONE_CHANGE}
    if host_subset and deleted:
        sub = deleted[:host_subset]
        hh, raw_has, found = {}, 0, 0
        for u in sub:
            raw = lattice_decode(
                graph, np.asarray(lls[u], np.float32),
                acoustic_scale=kw["acoustic_scale"], beam=kw["beam"],
                lattice_beam=np.inf, max_active=0)
            raw_has += int(np.isfinite(ref_cost(raw, wids[u], scale, wip)))
            lat = determinize_lattice(prune_lattice(
                raw, kw["lattice_beam"], 1.0, kw["acoustic_scale"]))
            hh[u] = _words(lat, point, word_table, shortest_path)
            found += int(np.isfinite(ref_cost(lat, wids[u], scale, wip)))
        out["host"] = {"utts": len(sub), "max_active": None,
                       "deletions_before": _dels(
                           refs, {u: hyps[u] for u in sub}),
                       "deletions_after": _dels(refs, hh),
                       "utts_whose_raw_lattice_has_the_reference": raw_has,
                       "utts_whose_lattice_has_the_reference": found}
    out["seconds"] = time.perf_counter() - t0
    return out


def save_inputs(path: str, call: dict, refs, word_table, point,
                utts: Optional[Sequence[str]] = None) -> None:
    """``call``'s graph and loglikes (of ``utts``, or all), with the
    references, the word table and the operating point, into one
    ``.npz``."""
    g = call["graph"]
    blobs = {f"g.{k}": getattr(g, k) for k in GRAPH_KEYS}
    blobs["g.meta"] = np.asarray([g.num_states, g.start], np.int64)
    for u, ll in call["loglikes"].items():
        if utts is None or u in utts:
            blobs[f"ll.{u}"] = np.asarray(ll, np.float32)
    meta = {"refs": refs, "point": list(point),
            "words": [word_table.sym(i) for i in range(len(word_table))],
            "settings": _settings(call)}
    blobs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **blobs)


def load_inputs(path: str, package: str):
    """(graph as ``package``'s CompiledGraph, loglikes, meta) of
    ``save_inputs``' file."""
    z = np.load(path)
    cg = importlib.import_module(f"{package}.decode.graph").CompiledGraph
    g = object.__new__(cg)
    for k in GRAPH_KEYS:
        setattr(g, k, z[f"g.{k}"])
    g.num_states, g.start = (int(v) for v in z["g.meta"])
    lls = {k[3:]: z[k] for k in z.files if k.startswith("ll.")}
    return g, lls, json.loads(bytes(z["meta"]).decode())


class WordList:
    """A word table from ``save_inputs``' list of words (id -> word)."""

    def __init__(self, words: Sequence[str]):
        self.words = list(words)
        self.index = {w: i for i, w in enumerate(self.words)}

    def sym(self, i: int) -> str:
        return self.words[i]

    def id(self, w: str) -> int:
        return self.index[w]


def classify_inputs(path: str, train_transcripts, device, wide: bool,
                    host_subset: int) -> dict:
    """``classify`` on a ``save_inputs`` file's decode (the port, on
    ``device``)."""
    g, lls, meta = load_inputs(path, PORT)
    call = dict(graph=g, loglikes=lls, args=(), kwargs=meta["settings"],
                lats=None)
    return classify(call, meta["refs"], WordList(meta["words"]),
                    tuple(meta["point"]), train_transcripts, device, wide,
                    host_subset)


def decode_inputs(path: str, package: str, device: Optional[str] = None,
                  utts: Optional[Sequence[str]] = None) -> dict:
    """``package``'s ``decode_utterances`` (the file's settings) on the
    file's loglikes (``utts`` of them, or all), then each utterance's
    words at the file's point: {"words": {utt: words}, "wer", "del"}."""
    g, lls, meta = load_inputs(path, package)
    td = importlib.import_module(f"{package}.decode.topk_decoder")
    lat_mod = importlib.import_module(f"{package}.decode.lattice")
    score = importlib.import_module(f"{package}.decode.score")
    if utts is not None:
        lls = {u: lls[u] for u in utts}
    kw = dict(meta["settings"])
    if package == PORT:
        kw["device"] = device
    t = time.perf_counter()
    lats = td.decode_utterances(g, lls, **kw)
    words = {}
    for u, lat in lats.items():
        _, wids, _ = lat_mod.shortest_path(lat, 1.0, *meta["point"])
        words[u] = [meta["words"][int(w)] for w in wids]
    r = score.wer_details({u: meta["refs"][u] for u in words}, words)
    return {"package": package, "utts": len(words), "wer": r["wer"],
            "del": r["del"], "errors": r["errors"],
            "seconds": time.perf_counter() - t, "words": words}
