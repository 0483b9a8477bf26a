"""Batched top-K beam search over a CSR-packed HCLG, with on-device
lattice records, and its streaming interface.

Port of ``kaldi_cnn_tpu/decode/topk_decoder.py`` (``TopKGraph``,
``_recombine_topk``, ``_lookup``, ``TpuTopKDecoder``,
``TpuStreamingDecoder`` and ``decode_utterances``) to PyTorch (ref:
src/decoder/lattice-faster-decoder.cc ProcessEmitting /
ProcessNonemitting / PruneActiveTokens / GetRawLattice):

  tokens   = K active (state, cost) pairs per utterance, kept sorted by
             state so that membership lookup is a binary search;
  expand   = windowed gather of each active state's out-arcs from the
             CSR packing, plus a dense relaxation of the few high-degree
             hub states' arcs;
  recombine= one sort by a packed (dst, cost) int64 key + dedup mask;
  prune    = beam cutoff + top-K (beam + max-active), ranked with an
             acoustic lookahead;
  eps      = the same expand/recombine on the eps arcs, iterated to the
             eps-DAG depth;
  backptrs = best path: one resolution pass per frame; the host walks
             them back;
  lattice  = or, per frame, every within-lattice-beam candidate arc
             between surviving tokens compacted into a fixed-size record
             buffer kept on the device; after the frame loop the records
             are compressed on the device, cross to the host in one
             transfer and become a ``Lattice`` there (assembled, pruned
             and optionally determinized).

``vmap`` over utterances is an explicit leading batch dimension.  The
counterpart of the JAX package's ``lax.scan`` over frames is the block
function ``TopKDecoder._block`` (S frames of the carry), which on the
card runs as CUDA graphs: greedy blocks from ``FRAME_BLOCKS``, each
captured at its first use and replayed after (``_BlockRunner``), so a
batch's frame loop is a few replays and no host sync.  Elsewhere the
same block function runs eagerly, frame by frame.  The best path is
walked back on the device (``_backtrace_impl``'s counterpart, in
captured chunks of steps on the card), and only each row's arc sequence
crosses to the host.  ``StreamingDecoder`` runs its chunks through the
same block machinery with a carry of its own.  ``decode_utterances``
splits a keyed utterance set over the ranks of a process group, where
the JAX package shards the batch over its mesh's data axis.
``TopKGraph`` is a copy of the JAX package's numpy packing (the port
imports nothing of that package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from kaldi_cnn_tpu_torch.core.graphs import capture as _capture
from kaldi_cnn_tpu_torch.core.logging import get_logger
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.lattice import (Lattice, determinize_lattice,
                                                prune_lattice)

logger = get_logger(__name__)

BIG = np.float32(1e30)
INVALID = np.int32(2**31 - 1)
_BIG = float(BIG)            # the same constants as torch scalars
_INVALID = int(INVALID)

# a batch's frames (and the backtrace's steps) run as greedy blocks from
# this ladder, each block one CUDA graph on the card: decode_utterances
# pads every batch to a multiple of 128 frames, so the 64-frame graph
# serves all of it
FRAME_BLOCKS = (64, 16, 4, 1)


def _ladder(n: int, sizes) -> List[int]:
    """n as a greedy sum of ``sizes`` (largest first; 1 must be in it)."""
    out = []
    while n:
        out.append(next(s for s in sizes if s <= n))
        n -= out[-1]
    return out


# ---------------------------------------------------------------------------
# Graph packing (numpy, host)
# ---------------------------------------------------------------------------

class TopKGraph:
    """Two-tier CSR packing of a CompiledGraph.

    Arc tables are sorted by source state (full CSR, arc multiset and
    state numbering unchanged).  States whose out-degree fits the caps
    are expanded with a fixed gather window per frame; the few states
    that exceed them (LM backoff / word-loop hubs with 10^4-10^5 arcs)
    are marked as *hubs* and get a dense relaxation instead: every hub
    arc is a candidate every frame, its source cost looked up in the
    active set.  That is exactly the cost the reference pays when a hub
    is active (ProcessEmitting walks all its arcs) — but here the hub
    arc set is static, so the tensor shapes are fixed per graph.
    """

    def __init__(self, g: CompiledGraph, max_emit: int = 16,
                 max_eps: int = 8):
        assert max_emit >= 1 and max_eps >= 2
        S = g.num_states
        self.num_states = S
        self.start = g.start

        # full CSR over all emitting arcs (vectorized: 10^6-10^7 arc
        # graphs pack in milliseconds)
        e_order = np.argsort(np.asarray(g.e_src, np.int64), kind="stable")
        e_src_a = np.asarray(g.e_src, np.int64)[e_order]
        self.e_src = e_src_a.astype(np.int32)
        self.e_dst = g.e_dst[e_order]
        self.e_pdf = g.e_pdf[e_order]
        self.e_w = g.e_weight[e_order]
        self.e_ilabel = g.e_ilabel[e_order]
        self.e_olabel = g.e_olabel[e_order]
        self.e_off = np.searchsorted(
            e_src_a, np.arange(S + 1)).astype(np.int32)

        n_order = np.argsort(np.asarray(g.n_src, np.int64), kind="stable")
        n_src_a = np.asarray(g.n_src, np.int64)[n_order]
        self.n_src = n_src_a.astype(np.int32)
        self.n_dst = g.n_dst[n_order]
        self.n_w = g.n_weight[n_order]
        self.n_olabel = g.n_olabel[n_order]
        self.n_off = np.searchsorted(
            n_src_a, np.arange(S + 1)).astype(np.int32)

        # hub classification (per arc family)
        e_deg = self.e_off[1:] - self.e_off[:-1]
        n_deg = self.n_off[1:] - self.n_off[:-1]
        self.e_is_hub = (e_deg > max_emit)
        self.n_is_hub = (n_deg > max_eps)
        self.e_hub_arcs = np.concatenate(
            [np.arange(self.e_off[s], self.e_off[s + 1])
             for s in np.nonzero(self.e_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.n_hub_arcs = np.concatenate(
            [np.arange(self.n_off[s], self.n_off[s + 1])
             for s in np.nonzero(self.n_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.max_emit_deg = int(e_deg[~self.e_is_hub].max()) \
            if (~self.e_is_hub).any() and len(self.e_src) else 0
        self.max_eps_deg = int(n_deg[~self.n_is_hub].max()) \
            if (~self.n_is_hub).any() and len(self.n_src) else 0

        self.final = np.asarray(g.final, np.float32)
        self.eps_depth = self._eps_depth()
        self._build_lookahead()
        self._build_hub_aux()
        self._build_eps_incsr()

    def _build_hub_aux(self) -> None:
        """Per-hub-state auxiliary tables: hub arcs are relaxed densely
        every frame, but their SOURCES are a handful of distinct hub
        states — looking up those few states once and broadcasting via a
        static arc->hub-state index replaces a 10^5-query binary search
        per frame.  Hub arc DESTINATIONS are static too, so their
        acoustic-lookahead table rows are pre-gathered here; at runtime
        the lookahead becomes a small-table gather over the P-row
        acoustic vector instead of a random gather over the [S, W+1]
        table."""
        for fam in ("e", "n"):
            arcs = getattr(self, f"{fam}_hub_arcs")
            srcs = getattr(self, f"{fam}_src")[arcs] if len(arcs) else \
                np.zeros(0, np.int32)
            states, sid = np.unique(srcs, return_inverse=True)
            setattr(self, f"{fam}_hub_states", states.astype(np.int32))
            setattr(self, f"{fam}_hub_sid", sid.astype(np.int32))
        dsts = self.n_dst[self.n_hub_arcs] if len(self.n_hub_arcs) else \
            np.zeros(0, np.int64)
        self.n_hub_la_pdf = self.la_pdf[dsts]
        self.n_hub_la_w = self.la_w[dsts]

    def _build_eps_incsr(self, max_in: int = 8) -> None:
        """CSR of eps arcs BY DESTINATION, for backpointer resolution:
        each surviving token checks only its own eps in-arcs (a bounded
        window) instead of the whole expansion being scattered through
        segment-min reductions.  States whose eps in-degree exceeds the
        cap (e.g. an LM backoff state fed by many word-ends) keep a
        dense in-hub arc table."""
        A = len(self.n_src)
        order = np.argsort(np.asarray(self.n_dst, np.int64),
                           kind="stable")
        dst_sorted = np.asarray(self.n_dst, np.int64)[order]
        off = np.searchsorted(dst_sorted, np.arange(self.num_states + 1))
        deg = off[1:] - off[:-1]
        self.ni_is_hub = deg > max_in
        hub_arcs = np.concatenate(
            [order[off[s]:off[s + 1]]
             for s in np.nonzero(self.ni_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.ni_hub_arcs = hub_arcs
        self.ni_off = off.astype(np.int32)
        self.ni_arc = order.astype(np.int32)
        self.max_in_deg = int(deg[~self.ni_is_hub].max()) \
            if (~self.ni_is_hub).any() and A else 0

    def _build_lookahead(self, W: int = 2) -> None:
        """Per-state acoustic-lookahead table: up to W outgoing emitting
        (weight, pdf) pairs per state, used to RANK tokens during top-K
        pruning by cost + min_a(w_a + scale*am_next[pdf_a]).  States
        whose out-degree exceeds W (hubs), is zero, or that also have
        epsilon out-arcs get an optimistic 0-cost sentinel slot (never
        wrongly evicted: a state with 1-2 emitting arcs plus eps
        out-arcs — e.g. a word-end state feeding LM backoff through a
        non-hub eps chain — must not be ranked purely by its emitting
        arcs' next-frame acoustics, or the eps fixpoint can evict tokens
        whose best continuation is epsilon).  True Viterbi costs are
        untouched — only survival under K/beam pressure changes, which
        is what lets acoustically-supported word-start tokens live
        through an LM hub fan-out that K cannot cover (the reference has
        the same eviction problem in GetCutoff when active >> max-active;
        ref: lattice-faster-decoder.cc adaptive-beam logic)."""
        S = self.num_states
        deg = (self.e_off[1:] - self.e_off[:-1]).astype(np.int64)
        eps_deg = (self.n_off[1:] - self.n_off[:-1]).astype(np.int64)
        la_pdf = np.full((S, W + 1), -1, np.int32)   # -1 = sentinel slot
        la_w = np.full((S, W + 1), BIG, np.float32)
        for j in range(W):
            has = deg > j
            idx = self.e_off[:-1][has] + j
            la_pdf[has, j] = self.e_pdf[idx]
            la_w[has, j] = self.e_w[idx]
        optimistic = (deg == 0) | (deg > W) | (eps_deg > 0)
        la_w[optimistic, W] = 0.0
        self.la_pdf = la_pdf
        self.la_w = la_w

    def _eps_depth(self, cap: int = 64) -> int:
        if len(self.n_src) == 0:
            return 0
        depth = np.zeros(self.num_states, np.int32)
        for _ in range(cap):
            upd = np.zeros(self.num_states, np.int32)
            np.maximum.at(upd, self.n_dst, depth[self.n_src] + 1)
            new = np.maximum(depth, upd)
            if (new == depth).all():
                return int(depth.max())
            depth = new
        raise ValueError("epsilon cycle in decoding graph")

    @property
    def num_emitting_arcs(self) -> int:
        return len(self.e_src)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.n_src)


# ---------------------------------------------------------------------------
# Device-side primitives, batched over utterances on a leading dimension
# ---------------------------------------------------------------------------

def _sort_key(dst: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """One int64 key ordering candidates by (dst, cost): dst in the high
    32 bits, the order-preserving unsigned image of the f32 cost bits in
    the low 32 (torch has no multi-key sort)."""
    bits = cost.contiguous().view(torch.int32).to(torch.int64)
    low = torch.where(bits < 0, ~bits, bits | 0x80000000)
    return (dst.to(torch.int64) << 32) | low


def _sort_by_dst_cost(dst, cost, rest):
    order = torch.sort(_sort_key(dst, cost), dim=-1, stable=True).indices
    return (dst.gather(-1, order), cost.gather(-1, order),
            tuple(r.gather(-1, order) for r in rest))


def _recombine_topk(dst, cost, payloads, k, beam, la=None):
    """Hash-map insert + beam + max-active in one shot, per batch row:
    sort candidates by (dst, cost), keep the cheapest per dst, beam-cut,
    take the top K, and restore state-sorted order (ref:
    ProcessEmitting's token map + PruneActiveTokens).

    ``la``: optional per-candidate acoustic-lookahead ranking addend; the
    stored costs stay true costs, only the top-K selection ranks by
    cost + lookahead (TopKGraph._build_lookahead).  Ties at the K-th
    place may select other slots than ``lax.top_k`` does; the surviving
    costs agree."""
    extra = () if la is None else (la,)
    sdst, scost, rest = _sort_by_dst_cost(dst, cost, extra + tuple(payloads))
    dup = torch.zeros_like(sdst, dtype=torch.bool)
    dup[:, 1:] = sdst[:, 1:] == sdst[:, :-1]
    cutoff = scost.amin(dim=-1, keepdim=True) + beam
    bad = dup | (scost > cutoff) | (sdst == _INVALID)
    scost = torch.where(bad, _BIG, scost)
    sdst = torch.where(bad, _INVALID, sdst)
    if la is None:
        rank = scost
    else:
        rank, rest = torch.where(bad, _BIG, scost + rest[0]), rest[1:]
    idx = torch.topk(rank, k, dim=-1, largest=False, sorted=False).indices
    seld, selc, selr = _sort_by_dst_cost(
        sdst.gather(-1, idx), scost.gather(-1, idx),
        tuple(r.gather(-1, idx) for r in rest))
    return (seld, selc) + selr


def _lookup(sorted_states, values, query, default):
    """values[slot of query] for queries present in the state-sorted
    active set, else default; and the slot, else -1.  [B, K] tables,
    [B, Q] queries."""
    k = sorted_states.shape[-1]
    pos = torch.searchsorted(sorted_states.contiguous(),
                             query.contiguous()).clamp_(0, k - 1)
    hit = (sorted_states.gather(-1, pos) == query) & (query != _INVALID)
    return (torch.where(hit, values.gather(-1, pos), default),
            torch.where(hit, pos, -1))


class TopKDecoder:
    """Batched top-K beam decoder with optional lattice records
    (counterpart of ``kaldi_cnn_tpu.decode.topk_decoder.TpuTopKDecoder``).

    Exact Viterbi whenever ``max_active`` covers all simultaneously
    alive states and the beam is generous; otherwise the usual beam
    search approximation.  Per frame the token sets of all utterances
    advance together as [B, K] tensors on ``device``; on the card the
    frame loop is replays of captured CUDA graphs of ``FRAME_BLOCKS``
    frames (``_run_frames``), which bake in the decoder's beam, acoustic
    scale, K, eps depth and record capacity.  ``decode_batch`` walks the
    best path back on the device and fetches only the arc sequences;
    ``decode_batch_lattice`` keeps lattice records on the device and
    builds the lattices on the host.

    ``lattice_arcs_per_frame``: per-frame lattice record capacity.  0
    disables lattice output (best path only); None derives the capacity
    from ``max_active`` (``_derive_lattice_arcs``)."""

    def __init__(self, graph: CompiledGraph, beam: float = 16.0,
                 max_active: int = 2048, acoustic_scale: float = 0.1,
                 lattice_beam: float = 8.0,
                 lattice_arcs_per_frame: Optional[int] = 0,
                 max_emit_deg: int = 16, max_eps_deg: int = 8,
                 device="cuda"):
        self.g0 = graph
        self.g = TopKGraph(graph, max_emit_deg, max_eps_deg)
        g = self.g
        self.device = torch.device(device)
        self.beam = float(np.float32(min(beam, 1e9)))
        self.K = int(min(max_active, g.num_states)) if max_active > 0 \
            else g.num_states
        self.acoustic_scale = float(np.float32(acoustic_scale))
        self.lattice_beam = float(lattice_beam)
        self.A_lat = (self._derive_lattice_arcs(self.K)
                      if lattice_arcs_per_frame is None
                      else int(lattice_arcs_per_frame))
        # (arcs dropped, frames affected) of the last lattice decode
        self.last_overflow: Optional[Tuple[int, int]] = None
        # per row of the last decode_batch: whether its best path ends in
        # a final state (ref: ReachedFinal()); else it ended on the
        # row's cheapest token, its cost without a final cost
        self.last_reached_final: Optional[np.ndarray] = None
        self.De = max(g.max_emit_deg, 1)
        self.Dn = max(g.max_eps_deg, 1)
        self.He = len(g.e_hub_arcs)
        self.Hn = len(g.n_hub_arcs)
        self.Di = max(g.max_in_deg, 1)
        self.Hni = len(g.ni_hub_arcs)
        self.eps_iters = g.eps_depth

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i32, i64, f32, b = torch.int32, torch.int64, torch.float32, \
            torch.bool
        self.d = {
            "e_off": t(g.e_off, i64), "e_dst": t(g.e_dst, i32),
            "e_pdf": t(g.e_pdf, i64), "e_w": t(g.e_w, f32),
            "n_off": t(g.n_off, i64), "n_dst": t(g.n_dst, i32),
            "n_w": t(g.n_w, f32),
            "e_is_hub": t(g.e_is_hub, b), "n_is_hub": t(g.n_is_hub, b),
            "la_pdf": t(g.la_pdf, i64), "la_w": t(g.la_w, f32),
            "final": t(g.final, f32),
        }
        if self.He:
            ha = g.e_hub_arcs
            self.d["e_hub"] = (t(ha, i64), t(g.e_dst[ha], i32),
                               t(g.e_w[ha], f32))
            self.d["e_hub_states"] = t(g.e_hub_states, i32)
            self.d["e_hub_sid"] = t(g.e_hub_sid, i64)
        if self.Hn:
            ha = g.n_hub_arcs
            self.d["n_hub"] = (t(ha, i64), t(g.n_dst[ha], i32),
                               t(g.n_w[ha], f32))
            self.d["n_hub_states"] = t(g.n_hub_states, i32)
            self.d["n_hub_sid"] = t(g.n_hub_sid, i64)
            self.d["n_hub_la_pdf"] = t(g.n_hub_la_pdf, i64)
            self.d["n_hub_la_w"] = t(g.n_hub_la_w, f32)
        if self.eps_iters > 0:
            self.d["ni_off"] = t(g.ni_off, i64)
            self.d["ni_arc"] = t(g.ni_arc, i64)
            self.d["ni_is_hub"] = t(g.ni_is_hub, b)
            self.d["n_src"] = t(g.n_src, i32)
            if self.Hni:
                ha = g.ni_hub_arcs
                self.d["ni_hub"] = (t(ha, i64), t(g.n_src[ha], i32),
                                    t(g.n_dst[ha], i32), t(g.n_w[ha], f32))
        # on the card: the batch search's block runners (one a batch
        # width), the best-path history the backtrace's graphs read, and
        # the memory pool every graph of this decoder shares
        self._runners: Dict[int, _BlockRunner] = {}
        self._bt: Optional[_Backtrace] = None
        self._pool = None

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def capture_seconds(self) -> Dict[tuple, float]:
        """Seconds of each CUDA graph captured for the batch search:
        ("frames", lattice, B, S, A_lat) and ("backtrace", B, S)."""
        out = {("frames", k[0], B, k[1], k[2]): blk.capture_s
               for B, run in self._runners.items()
               for k, blk in run.blocks.items()}
        if self._bt is not None:
            out.update({("backtrace", self._bt.B, S): s
                        for S, (_, s) in self._bt.graphs.items()})
        return out

    # -- expansion ---------------------------------------------------------
    def _expand(self, states, costs, off, dst, w, width, is_hub):
        """Windowed CSR gather of the out-arcs of the active set's
        non-hub states: flat (arc_id, dst, base_cost, src_slot, ok) of
        K * width candidates per row (invalid ones cost _BIG, dst
        _INVALID)."""
        B, K = states.shape
        valid = states != _INVALID
        sc = torch.where(valid, states, 0).long()
        base = off[sc]
        deg = off[sc + 1] - base
        j = torch.arange(width, device=self.device)
        arc = (base[..., None] + j).clamp_(0, dst.shape[0] - 1)
        ok = ((j < deg[..., None]) & valid[..., None]
              & (costs[..., None] < _BIG) & ~is_hub[sc][..., None])
        cdst = torch.where(ok, dst[arc], _INVALID)
        ccost = torch.where(ok, costs[..., None] + w[arc], _BIG)
        slot = torch.arange(K, device=self.device)[None, :, None].expand(
            B, K, width)
        return (arc.reshape(B, -1), cdst.reshape(B, -1),
                ccost.reshape(B, -1), slot.reshape(B, -1),
                ok.reshape(B, -1))

    def _expand_hub(self, states, costs, hub, hub_states, hub_sid):
        """Dense relaxation of a static hub arc table: source costs are
        looked up once per distinct hub state and broadcast to arcs."""
        arc, dst, w = hub
        B = states.shape[0]
        scost_s, sslot_s = _lookup(states, costs,
                                   hub_states.expand(B, -1), _BIG)
        scost = scost_s[:, hub_sid]
        sslot = sslot_s[:, hub_sid]
        ok = (sslot >= 0) & (scost < _BIG)
        cdst = torch.where(ok, dst, _INVALID)
        ccost = torch.where(ok, scost + w, _BIG)
        return arc.expand(B, -1), cdst, ccost, sslot, ok

    @staticmethod
    def _cat(parts_a, parts_b):
        return tuple(torch.cat([a, b], dim=-1)
                     for a, b in zip(parts_a, parts_b))

    def _expand_emit(self, states, costs):
        d = self.d
        cand = self._expand(states, costs, d["e_off"], d["e_dst"],
                            d["e_w"], self.De, d["e_is_hub"])
        if self.He:
            cand = self._cat(cand, self._expand_hub(
                states, costs, d["e_hub"], d["e_hub_states"],
                d["e_hub_sid"]))
        return cand

    # -- one frame ---------------------------------------------------------
    def _am_ext(self, am_next):
        """Scaled next-frame acoustic costs [B, P] with a trailing 0
        sentinel column (la_pdf -1 slots index it)."""
        return torch.cat([self.acoustic_scale * am_next,
                          am_next.new_zeros((am_next.shape[0], 1))], dim=1)

    def _la_gather(self, am_ext, pdfs):
        P = am_ext.shape[1] - 1
        idx = torch.where((pdfs < 0) | (pdfs >= P), P, pdfs)
        B = am_ext.shape[0]
        return am_ext.gather(1, idx.reshape(B, -1)).reshape(idx.shape)

    def _la_states(self, states, am_ext):
        """Dynamic acoustic lookahead for a [B, Q] state set."""
        s = torch.where(states == _INVALID, 0, states).long()
        pdfs = self.d["la_pdf"][s]
        v = (self.d["la_w"][s] + self._la_gather(am_ext, pdfs)).amin(-1)
        return torch.where(states == _INVALID, 0.0, v.clamp_max(_BIG))

    def _la_hub(self, am_ext):
        """Lookahead of the static eps hub arc destinations."""
        B = am_ext.shape[0]
        pdfs = self.d["n_hub_la_pdf"].expand(B, -1, -1)
        return (self.d["n_hub_la_w"] + self._la_gather(am_ext, pdfs)
                ).amin(-1).clamp_max(_BIG)

    def _eps_fixpoint(self, fs, fc, am_ext=None):
        d = self.d
        for _ in range(self.eps_iters):
            cand = self._expand(fs, fc, d["n_off"], d["n_dst"],
                                d["n_w"], self.Dn, d["n_is_hub"])
            dsts = [fs, cand[1]]
            costs = [fc, cand[2]]
            las = None
            if am_ext is not None:
                las = [self._la_states(fs, am_ext),
                       self._la_states(cand[1], am_ext)]
            if self.Hn:
                hub = self._expand_hub(fs, fc, d["n_hub"],
                                       d["n_hub_states"], d["n_hub_sid"])
                dsts.append(hub[1])
                costs.append(hub[2])
                if am_ext is not None:
                    las.append(self._la_hub(am_ext))
            fs, fc = _recombine_topk(
                torch.cat(dsts, -1), torch.cat(costs, -1), (), self.K,
                self.beam, None if las is None else torch.cat(las, -1))
        return fs, fc

    def _resolve_bp(self, fs, fc, es, ec, e_bp_arc, e_bp_prev):
        """Post-fixpoint backpointers: each surviving token is traced to
        the emitting set (same state, same cost) or to the eps in-arc
        from another surviving token that achieves its cost (the
        lowest such arc id wins).  -1 marks a token left unresolved,
        repaired on the host by ``_host_fix``."""
        tol = float(np.float32(1e-3))
        B, K = fs.shape
        ecost_at, eslot = _lookup(es, ec, fs, _BIG)
        emit_hit = (ecost_at - fc).abs() <= tol
        if self.eps_iters > 0:
            d = self.d
            arc, ok, scost, sslot = self._eps_in_arcs(fs, fc)
            match = ok & (sslot >= 0) & (
                (scost + d["n_w"][arc] - fc[..., None]).abs() <= tol)
            arc_m = torch.where(match, arc, _INVALID)
            pos = arc_m.argmin(dim=-1, keepdim=True)
            best_arc = arc_m.gather(-1, pos)[..., 0]
            best_src = torch.where(match, sslot, _INVALID).gather(
                -1, pos)[..., 0]
            if self.Hni:
                ha, hsrc, hdst, hw = d["ni_hub"]
                hscost, hslot = _lookup(fs, fc, hsrc.expand(B, -1), _BIG)
                hdcost, hdslot = _lookup(fs, fc, hdst.expand(B, -1), _BIG)
                hmatch = ((hslot >= 0) & (hdslot >= 0)
                          & ((hscost + hw - hdcost).abs() <= tol))
                seg = torch.where(hmatch, hdslot, K)
                init = torch.full((B, K + 1), int(_INVALID),
                                  dtype=torch.int64, device=self.device)
                h_arc = init.scatter_reduce(
                    1, seg, torch.where(hmatch, ha, _INVALID),
                    "amin")[:, :K]
                win = hmatch & (ha == h_arc.gather(
                    1, torch.where(hdslot >= 0, hdslot, 0)))
                h_src = init.scatter_reduce(
                    1, seg, torch.where(win, hslot, _INVALID), "amin")[:, :K]
                valid = fs != _INVALID
                is_ihub = d["ni_is_hub"][torch.where(valid, fs, 0).long()] \
                    & valid
                best_arc = torch.where(is_ihub, h_arc, best_arc)
                best_src = torch.where(is_ihub, h_src, best_src)
            eps_hit = best_arc != _INVALID
        else:
            eps_hit = torch.zeros_like(fs, dtype=torch.bool)
            best_arc = best_src = torch.full_like(fs, int(_INVALID),
                                                  dtype=torch.int64)
        n_e = self.g.num_emitting_arcs
        has = eslot >= 0
        es_c = torch.where(has, eslot, 0)
        bp_arc = torch.where(
            emit_hit, torch.where(has, e_bp_arc.gather(-1, es_c), -1),
            torch.where(eps_hit, best_arc + n_e, -1))
        bp_prev = torch.where(
            emit_hit, torch.where(has, e_bp_prev.gather(-1, es_c), -1),
            torch.where(eps_hit, best_src, -1))
        dead = fs == _INVALID
        return (torch.where(dead, -1, bp_arc),
                torch.where(dead, -1, bp_prev))

    def _eps_in_arcs(self, fs, fc):
        """Each surviving token's own eps in-arcs from the by-destination
        in-CSR, a [B, K, Di] window (tokens of in-hub states masked out):
        (arc ids, ok, the source's cost and slot in the active set)."""
        d = self.d
        valid = fs != _INVALID
        sc = torch.where(valid, fs, 0).long()
        base = d["ni_off"][sc]
        deg = d["ni_off"][sc + 1] - base
        j = torch.arange(self.Di, device=self.device)
        hi = max(int(self.g.num_eps_arcs) - 1, 0)
        arc = d["ni_arc"][(base[..., None] + j).clamp_(0, hi)]
        ok = ((j < deg[..., None]) & valid[..., None]
              & ~d["ni_is_hub"][sc][..., None])
        src = torch.where(ok, d["n_src"][arc], _INVALID)
        scost, sslot = _lookup(fs, fc, src.reshape(fs.shape[0], -1), _BIG)
        return arc, ok, scost.reshape(src.shape), sslot.reshape(src.shape)

    # -- lattice records ---------------------------------------------------
    def _emit_records(self, fs, fc, cdst, ccost, srcslot, arc, ok):
        """GetRawLattice emitting-arc records for one frame: the candidate
        arcs into surviving tokens that pass the exact per-destination
        lattice-beam cut ``ccost <= fc[dst] + lattice_beam`` (f32, as the
        JAX package computes it).  An arc beyond the cut lies on no path
        within the lattice beam of the best, so ``prune_lattice`` would
        drop it on the host anyway."""
        lbeam = float(np.float32(self.lattice_beam))
        dcost, dslot = _lookup(fs, fc, cdst, _BIG)
        keep = ok & (dslot >= 0) & (ccost <= dcost + lbeam)
        return self._compact(keep, (srcslot, dslot, arc), self.A_lat)

    def _eps_records(self, fs, fc):
        """Same-level eps-arc records under the same per-destination cut,
        from the by-destination in-CSR: each surviving token gathers its
        own eps in-arcs ([K, Di] window, then the dense in-hub table) and
        looks the source up in the active set.  The candidate order (the
        window first, then the in-hub arcs) is the JAX package's, so the
        compacted records come out in its order."""
        B, K = fs.shape
        if self.eps_iters == 0:
            return (torch.full((B, 3, self.A_lat), -1, dtype=torch.int64,
                               device=self.device),
                    torch.zeros(B, dtype=torch.int32, device=self.device))
        lbeam = float(np.float32(self.lattice_beam))
        d = self.d
        arc, ok, scost, sslot = self._eps_in_arcs(fs, fc)
        keep = ok & (sslot >= 0) & (
            scost + d["n_w"][arc] <= fc[..., None] + lbeam)
        dslot = torch.arange(K, device=self.device)[None, :, None].expand(
            B, K, self.Di)
        keeps = [keep.reshape(B, -1)]
        srcs = [sslot.reshape(B, -1)]
        dsts = [dslot.reshape(B, -1)]
        arcs = [arc.reshape(B, -1)]
        if self.Hni:
            ha, hsrc, hdst, hw = d["ni_hub"]
            hscost, hslot = _lookup(fs, fc, hsrc.expand(B, -1), _BIG)
            hdcost, hdslot = _lookup(fs, fc, hdst.expand(B, -1), _BIG)
            keeps.append((hslot >= 0) & (hdslot >= 0)
                         & (hscost + hw <= hdcost + lbeam))
            srcs.append(hslot)
            dsts.append(hdslot)
            arcs.append(ha.expand(B, -1))
        return self._compact(
            torch.cat(keeps, -1),
            (torch.cat(srcs, -1), torch.cat(dsts, -1), torch.cat(arcs, -1)),
            self.A_lat)

    @staticmethod
    def _compact(mask, arrays, out_len):
        """Compacts each row's mask-selected entries to its first
        ``out_len`` slots, in candidate order (a stable sort of ~mask, as
        in the JAX package).  Returns the records [B, len(arrays),
        out_len] (int64, -1 past the row's count) and each row's TRUE
        (unclamped) count, so that the host can detect and report an
        overflow (count > out_len: arcs were dropped on this frame)."""
        B, n = mask.shape
        take = min(out_len, n)
        order = torch.sort((~mask).to(torch.int8), dim=-1,
                           stable=True).indices[:, :take]
        cnt_true = mask.sum(-1, dtype=torch.int32)
        live = torch.arange(take, device=mask.device) < cnt_true[:, None]
        vals = torch.stack(arrays, 1).gather(
            -1, order[:, None].expand(-1, len(arrays), -1))
        out = torch.where(live[:, None], vals, -1)
        if take < out_len:
            out = nnf.pad(out, (0, out_len - take), value=-1)
        return out, cnt_true

    # -- one frame ---------------------------------------------------------
    def _frame(self, prev_fs, prev_fc, am_row, am_next_row, lattice=False):
        """One decode frame: (fs, fc, bp_arc, bp_prev) in the best-path
        variant; (fs, fc, emit records, eps records) in the lattice
        variant, which skips the backpointer pass (the best path comes
        from the lattice itself)."""
        arc, cdst, ccost, srcslot, ok = self._expand_emit(prev_fs, prev_fc)
        pdf = self.d["e_pdf"][torch.where(ok, arc, 0)]
        ccost = torch.where(
            ok, ccost + self.acoustic_scale * am_row.gather(1, pdf), _BIG)
        am_ext = self._am_ext(am_next_row)
        if lattice:
            es, ec = _recombine_topk(cdst, ccost, (), self.K, self.beam)
            fs, fc = self._eps_fixpoint(es, ec, am_ext)
            return (fs, fc,
                    self._emit_records(fs, fc, cdst, ccost, srcslot, arc, ok),
                    self._eps_records(fs, fc))
        es, ec, e_arc, e_prev = _recombine_topk(
            cdst, ccost, (arc, srcslot), self.K, self.beam)
        fs, fc = self._eps_fixpoint(es, ec, am_ext)
        bp_arc, bp_prev = self._resolve_bp(fs, fc, es, ec, e_arc, e_prev)
        return fs, fc, bp_arc, bp_prev

    # -- the block function -----------------------------------------------
    def _levels(self, S: int, B: int, lattice: bool, device
                ) -> Dict[str, torch.Tensor]:
        """Empty int32 level buffers of S frames: best path "lv" [S, 4,
        B, K] (states, cost bits, bp_arc, bp_prev); lattice "fs" [S, B,
        K], "e_rec" / "n_rec" [S, B, 3, A_lat] and "e_cnt" / "n_cnt" [S,
        B]."""
        i32 = dict(dtype=torch.int32, device=device)
        K, A = self.K, self.A_lat
        if not lattice:
            return {"lv": torch.empty((S, 4, B, K), **i32)}
        return {"fs": torch.empty((S, B, K), **i32),
                "e_rec": torch.empty((S, B, 3, A), **i32),
                "e_cnt": torch.empty((S, B), **i32),
                "n_rec": torch.empty((S, B, 3, A), **i32),
                "n_cnt": torch.empty((S, B), **i32)}

    def _block(self, fs, fc, am, out, lattice=False):
        """The block function: S = ``len(am) - 1`` frames of ``_frame``
        from the carry (fs, fc) [B, K] over raw acoustic rows am [S + 1,
        B, P] (row j + 1 is frame j's lookahead); frame j's level goes
        into row j of each of ``out``'s buffers (``_levels``' layout).
        Returns the new carry."""
        for j in range(am.shape[0] - 1):
            r = self._frame(fs, fc, am[j], am[j + 1], lattice)
            fs, fc = r[0], r[1]
            if lattice:
                out["fs"][j].copy_(fs)
                out["e_rec"][j].copy_(r[2][0])
                out["e_cnt"][j].copy_(r[2][1])
                out["n_rec"][j].copy_(r[3][0])
                out["n_cnt"][j].copy_(r[3][1])
            else:
                lv = out["lv"][j]
                lv[0].copy_(fs)
                lv[1].copy_(fc.view(torch.int32))
                lv[2].copy_(r[2])
                lv[3].copy_(r[3])
        return fs, fc

    def _run_frames(self, fs, fc, rows, out, lattice):
        """A batch's frames from the carry (fs, fc) over rows [T + 1, B,
        P], levels into ``out``: on the card as replays of the captured
        block graphs, elsewhere eagerly.  A failed capture or replay
        raises; nothing falls back."""
        if rows.device.type != "cuda":
            self._run_frames_eager(fs, fc, rows, out, lattice)
            return
        run = self._runners.get(fs.shape[0])
        if run is None:
            run = self._runners[fs.shape[0]] = _BlockRunner(
                self, fs.shape[0], FRAME_BLOCKS)
        run.fs.copy_(fs)
        run.fc.copy_(fc)
        run.run(rows, out, lattice)

    def _run_frames_eager(self, fs, fc, rows, out, lattice):
        """The same frames as one eager call of the block function, on
        any device."""
        self._block(fs, fc, rows, out, lattice)

    # -- full decode -------------------------------------------------------
    @torch.no_grad()
    def _decode(self, am: torch.Tensor, lattice: bool = False):
        """am [B, T, P] raw acoustic costs (-loglikes) on the device.
        Level 0 (the start token + eps closure, with its backpointers or
        its eps records) runs eagerly, then the T frames
        (``_run_frames``).  Returns the device histories.  Best path:
        "lv" [T + 1, 4, B, K] (states, cost bits, bp_arc, bp_prev), a
        view of the buffer the backtrace's graphs read (the next
        best-path decode overwrites it).  Lattice: fs [T + 1, B, K]; emit
        records e_rec [T, B, 3, A_lat] (row t: arcs into level t + 1)
        with true counts e_cnt [T, B]; eps records n_rec [T + 1, B, 3,
        A_lat] (row t: arcs within level t) with n_cnt [T + 1, B].  A
        record is (source slot, destination slot, arc id), -1 past the
        count."""
        B, T, P = am.shape
        K, dev = self.K, self.device
        # rows [T + 1, B, P]: frame t's row and its lookahead row t + 1
        # (the last frame is its own lookahead)
        rows = torch.cat([am, am[:, -1:]], dim=1).transpose(0, 1).contiguous()
        s0 = torch.full((B, K), _INVALID, dtype=torch.int32, device=dev)
        s0[:, 0] = self.g.start
        c0 = torch.full((B, K), _BIG, dtype=torch.float32, device=dev)
        c0[:, 0] = 0.0
        fs, fc = self._eps_fixpoint(s0, c0, self._am_ext(rows[0]))
        if lattice:
            r = self._levels(T + 1, B, True, dev)
            r["e_rec"], r["e_cnt"] = r["e_rec"][1:], r["e_cnt"][1:]
            r["fs"][0] = fs
            r["n_rec"][0], r["n_cnt"][0] = self._eps_records(fs, fc)
            out = {"fs": r["fs"][1:], "e_rec": r["e_rec"],
                   "e_cnt": r["e_cnt"], "n_rec": r["n_rec"][1:],
                   "n_cnt": r["n_cnt"][1:]}
        else:
            if self._bt is None or not self._bt.fits(B, T):
                self._bt = None          # its graphs and buffers go first
                self._bt = _Backtrace(self, B, T)
            r = {"lv": self._bt.lv[:T + 1]}
            root = torch.full((B, K), -1, dtype=torch.int64, device=dev)
            bp_a, bp_p = self._resolve_bp(fs, fc, s0, c0, root, root)
            lv0 = r["lv"][0]
            lv0[0].copy_(fs)
            lv0[1].copy_(fc.view(torch.int32))
            lv0[2].copy_(bp_a)
            lv0[3].copy_(bp_p)
            out = {"lv": r["lv"][1:]}
        self._run_frames(fs, fc, rows, out, lattice)
        return r

    @staticmethod
    def _pad(loglikes: List[np.ndarray], pad_frames: int = 0,
             pad_rows: int = 0):
        """Host am [B, T, P] = -loglikes, zero frames padding each
        utterance to the longest one (or to ``pad_frames``), and the true
        lengths [n] of the n utterances; with ``pad_rows`` > n, rows of
        zero acoustics pad the batch to that many rows."""
        n = len(loglikes)
        T = max(max(x.shape[0] for x in loglikes), pad_frames)
        am = np.zeros((max(n, pad_rows), T, loglikes[0].shape[1]),
                      np.float32)
        lengths = np.zeros((n,), np.int32)
        for i, x in enumerate(loglikes):
            am[i, :x.shape[0]] = -x
            lengths[i] = x.shape[0]
        return am, lengths

    def decode_batch(self, loglikes: List[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """Best-path decode; per utterance (tids, word ids, total cost).
        Shorter utterances are padded to the longest; padding frames
        carry zero acoustics and are ignored by the backtrace.  The
        histories stay on the device, the backtrace walks them there
        (``_backtrace``) and only each row's arc sequence, count, cost
        and flags cross to the host, in one transfer.  A row whose walk
        met an unresolved backpointer fetches its own history and is
        repaired on the host (``_best_path``)."""
        am, lengths = self._pad(loglikes)
        lv = self._decode(torch.as_tensor(am, device=self.device))["lv"]
        arcs, ns, costs, fails, empties, self.last_reached_final = (
            self._backtrace(lv, torch.as_tensor(lengths, device=self.device)))
        out = []
        for b in range(len(loglikes)):
            if empties[b]:
                out.append((np.zeros(0, np.int32), np.zeros(0, np.int32),
                            float("inf")))
            elif fails[b]:
                h = lv[:, :, b].cpu().numpy()          # [T + 1, 4, K]
                r = {k: h[None, :, i] for i, k in enumerate(
                    ("fs", "fc", "bp_arc", "bp_prev"))}
                r["fc"] = r["fc"].view(np.float32)
                out.append(self._best_path(r, am[b:b + 1],
                                           int(lengths[b]), 0))
            else:
                out.append(self._arcs_to_path(arcs[b], int(ns[b]),
                                              float(costs[b])))
        return out

    # -- the best-path backtrace on the device ------------------------------
    @staticmethod
    def _split(lv):
        """fs, fc, bp_arc, bp_prev [B, T + 1, K] views of a best-path
        history lv [T + 1, 4, B, K]."""
        return (lv[:, 0].transpose(0, 1),
                lv[:, 1].view(torch.float32).transpose(0, 1),
                lv[:, 2].transpose(0, 1), lv[:, 3].transpose(0, 1))

    def _bt_len(self, levels: int) -> int:
        """Steps (and arc slots) of a backtrace over ``levels`` levels."""
        return levels * (self.eps_iters + 1) + 4

    def _last_tokens(self, fs, fc, lengths):
        """Each row's tokens at its true length: valid [B, K], their
        costs, and their costs with the final cost added (BIG where no
        token or no final state)."""
        b = torch.arange(fs.shape[0], device=fs.device)
        fsT, fcT = fs[b, lengths], fc[b, lengths]
        valid = fsT != _INVALID
        return valid, fcT, torch.where(valid, fcT + self.d["final"][
            torch.where(valid, fsT, 0).long()], _BIG)

    def _bt_start(self, fs, fc, lengths, L: int) -> Dict[str, torch.Tensor]:
        """The walk's start state (``_backtrace_impl``'s per-row set-up):
        each row's cheapest token at its true length with the final cost
        added, or, when no final state was reached, its cheapest token;
        the cost, the empty flag and an arc buffer of L slots."""
        B = fs.shape[0]
        valid, fcT, total_f = self._last_tokens(fs, fc, lengths)
        slot_f = total_f.argmin(-1)
        cost_f = total_f.gather(1, slot_f[:, None])[:, 0]
        total_a = torch.where(valid, fcT, _BIG)
        slot_a = total_a.argmin(-1)
        cost_a = total_a.gather(1, slot_a[:, None])[:, 0]
        use_f = cost_f < _BIG
        empty = ~valid.any(-1)
        return {"t": lengths.long(), "slot": torch.where(use_f, slot_f,
                                                          slot_a),
                "n": torch.zeros(B, dtype=torch.int64, device=fs.device),
                "fail": torch.zeros_like(empty), "done": empty.clone(),
                "out": torch.full((B, L), -1, dtype=torch.int32,
                                  device=fs.device),
                "cost": torch.where(use_f, cost_f, cost_a), "empty": empty}

    def _bt_step(self, st, fs0, ba, bp) -> None:
        """One step of every row's walk, in place (``_backtrace_impl``'s
        loop body): the token's backpointer arc goes to the arc buffer
        unless the walk is done (the start token at level 0) or failed
        (an unresolved backpointer); an emitting arc steps a level back.
        Indices are clamped into the history (the walk never leaves it:
        level 0 holds no emitting backpointer)."""
        B, Tp1, K = ba.shape
        b = torch.arange(B, device=ba.device)
        t, slot, n = st["t"], st["slot"], st["n"]
        ti, si = t.clamp(0, Tp1 - 1), slot.clamp(0, K - 1)
        a = ba[b, ti, si].long()
        p = bp[b, ti, si].long()
        is_root = (t == 0) & (a < 0) & (fs0[b, si] == self.g.start)
        done = st["done"] | is_root
        fail = st["fail"] | ((a < 0) & ~done)
        act = ~done & ~fail
        cur = st["out"].gather(1, n[:, None])
        st["out"].scatter_(1, n[:, None], torch.where(
            act[:, None], a[:, None].to(torch.int32), cur))
        st["t"].sub_((act & (a < self.g.num_emitting_arcs)).long())
        st["slot"].copy_(torch.where(act, p, slot))
        n.add_(act.long())
        st["done"].copy_(done)
        st["fail"].copy_(fail)

    @torch.no_grad()
    def _backtrace_eager(self, fs, fc, ba, bp, lengths):
        """The backtrace (counterpart of ``_backtrace_impl``) over
        histories [B, T + 1, K] and true lengths [B], eagerly: per row the
        arcs [L] newest first (L = (T + 1)(eps_iters + 1) + 4, -1 past
        the count), their count, the cost, ``fail`` (an unresolved
        backpointer, or no root within L steps: repair on the host) and
        ``empty`` (no token survived).  Returns device tensors."""
        L = self._bt_len(fs.shape[1])
        st = self._bt_start(fs, fc, lengths, L)
        for _ in range(L):
            self._bt_step(st, fs[:, 0], ba, bp)
        return (st["out"], st["n"], st["cost"], st["fail"] | ~st["done"],
                st["empty"])

    def _backtrace(self, lv, lengths):
        """The backtrace of a best-path history lv [T + 1, 4, B, K] (the
        view ``_decode`` returned) on its device, fetched to the host in
        one transfer: (arcs [B, L], n, cost, fail, empty, whether the
        path ends in a final state) as numpy.  On the card its steps run
        as captured chunks (``_Backtrace``)."""
        L = self._bt_len(lv.shape[0])
        arcs, n, cost, fail, empty = self._bt_walk(lv, lengths)
        fs, fc, _, _ = self._split(lv)
        final = self._last_tokens(fs, fc, lengths)[2].amin(-1) < _BIG
        B = arcs.shape[0]
        flat = torch.cat([arcs[:, :L].reshape(-1), n.to(torch.int32),
                          cost.view(torch.int32), fail.to(torch.int32),
                          empty.to(torch.int32),
                          final.to(torch.int32)]).cpu().numpy()
        arcs, n, cost, fail, empty, final = np.split(
            flat, np.cumsum([B * L, B, B, B, B]))
        return (arcs.reshape(B, L), n, cost.view(np.float32),
                fail.astype(bool), empty.astype(bool), final.astype(bool))

    def _bt_walk(self, lv, lengths):
        """The walk on the card as replays of the captured step chunks,
        which read ``_decode``'s buffer (``lv`` must be its view),
        elsewhere eagerly."""
        if lv.device.type != "cuda":
            return self._bt_walk_eager(lv, lengths)
        if lv.data_ptr() != self._bt.lv.data_ptr():
            raise ValueError("the captured backtrace walks the history "
                             "of this decoder's last best-path decode")
        return self._bt.run(lengths, lv.shape[0])

    def _bt_walk_eager(self, lv, lengths):
        return self._backtrace_eager(*self._split(lv), lengths)

    def _arcs_to_path(self, arcs: np.ndarray, n: int, cost: float
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Host label mapping of a device-backtraced arc sequence
        (given newest-first, length n)."""
        g = self.g
        n_e = g.num_emitting_arcs
        fwd = arcs[:n][::-1].astype(np.int64)
        eps = fwd >= n_e
        ol = np.where(eps, g.n_olabel[np.where(eps, fwd - n_e, 0)],
                      g.e_olabel[np.where(eps, 0, fwd)])
        words = ol[ol > 0].astype(np.int32)
        tids = g.e_ilabel[fwd[~eps]].astype(np.int32)
        return tids, words, float(cost)

    def _level(self, r, t, b):
        return tuple(r[k][b, t] for k in ("fs", "fc", "bp_arc", "bp_prev"))

    def _best_path(self, r, am, T, b):
        g = self.g
        fs, fc, _, _ = self._level(r, T, b)
        valid = fs != INVALID
        if not valid.any():
            return np.zeros(0, np.int32), np.zeros(0, np.int32), float("inf")
        total = np.where(valid, fc + g.final[np.where(valid, fs, 0)], BIG)
        slot = int(np.argmin(total))
        cost = float(total[slot])
        if cost >= BIG:        # no final state reached: best active token
            total = np.where(valid, fc, BIG)
            slot = int(np.argmin(total))
            cost = float(total[slot])
        tids_r: List[int] = []
        words_r: List[int] = []
        t = T
        n_e = g.num_emitting_arcs
        guard = 0
        while t >= 0:
            guard += 1
            if guard > (T + 2) * (self.eps_iters + 2):
                raise RuntimeError("backtrace loop")
            fs_t, fc_t, bp_arc, bp_prev = self._level(r, t, b)
            a, p = int(bp_arc[slot]), int(bp_prev[slot])
            if a < 0:
                if t == 0 and fs_t[slot] == g.start:
                    break
                # unresolved: eps predecessor was evicted; repair on host
                slot2, t2, tids2, words2 = self._host_fix(
                    r, am, t, b, slot)
                tids_r.extend(tids2)
                words_r.extend(words2)
                slot, t = slot2, t2
                continue
            if a >= n_e:                  # eps arc, same level
                a -= n_e
                if g.n_olabel[a] > 0:
                    words_r.append(int(g.n_olabel[a]))
                slot = p
            else:                         # emitting arc, previous level
                tids_r.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words_r.append(int(g.e_olabel[a]))
                slot = p
                t -= 1
        return (np.asarray(tids_r[::-1], np.int32),
                np.asarray(words_r[::-1], np.int32), cost)

    def _host_fix(self, r, am, t, b, slot):
        """Recompute one frame's token chains on the host (numpy, exact)
        when a device backpointer was left unresolved.  Returns the slot
        and level to continue from plus the labels collected."""
        g = self.g
        fs_t, fc_t, _, _ = self._level(r, t, b)
        state = int(fs_t[slot])
        if t == 0:
            pstates = np.asarray([g.start]); pcosts = np.asarray([0.0])
        else:
            pfs, pfc, _, _ = self._level(r, t - 1, b)
            keep = pfs != INVALID
            pstates, pcosts = pfs[keep], pfc[keep]
        # emitting relax (skipped at level 0)
        cost = {}
        via = {}
        if t > 0:
            row = am[b, t - 1]
            for ps, pc in zip(pstates.tolist(), pcosts.tolist()):
                for a in range(g.e_off[ps], g.e_off[ps + 1]):
                    c = pc + g.e_w[a] + float(self.acoustic_scale) \
                        * float(row[g.e_pdf[a]])
                    dd = int(g.e_dst[a])
                    if c < cost.get(dd, BIG):
                        cost[dd] = c
                        via[dd] = ("e", a, int(ps))
        else:
            cost[g.start] = 0.0
            via[g.start] = None
        # eps closure to fixpoint
        for _ in range(self.eps_iters + 1):
            changed = False
            for s in list(cost):
                for a in range(g.n_off[s], g.n_off[s + 1]):
                    c = cost[s] + float(g.n_w[a])
                    dd = int(g.n_dst[a])
                    if c < cost.get(dd, BIG) - 1e-6:
                        cost[dd] = c
                        via[dd] = ("n", a, s)
                        changed = True
            if not changed:
                break
        if state not in via:
            raise RuntimeError("host backtrace repair failed")
        tids, words = [], []
        s = state
        while via.get(s) is not None:
            kind, a, ps = via[s]
            if kind == "n":
                if g.n_olabel[a] > 0:
                    words.append(int(g.n_olabel[a]))
                s = ps
            else:
                tids.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words.append(int(g.e_olabel[a]))
                # continue from the predecessor token at level t-1
                pfs, _, _, _ = self._level(r, t - 1, b)
                slots = np.nonzero(pfs == ps)[0]
                if len(slots) == 0:
                    raise RuntimeError("host repair: predecessor missing")
                return int(slots[0]), t - 1, tids, words
        # reached the start state inside level 0
        return 0, -1, tids, words

    # -- lattice path ------------------------------------------------------
    @staticmethod
    def _derive_lattice_arcs(max_active: int) -> int:
        """Initial per-frame lattice record capacity derived from the
        token budget: a frame's records are the candidate arcs of the
        <=K surviving tokens that pass the per-destination lattice-beam
        cut, and the densest frames carry up to ~1.7*K records at the
        reference settings (the JAX package's measurement).  2*K rounded
        up to a power of two, at least 2048, covers that with headroom,
        so a default-sized decode pays no auto-grow re-decode."""
        return 1 << max(11, (2 * int(max_active) - 1).bit_length())

    @staticmethod
    def _overflow_from_counts(init_cnt, e_cnt, n_cnt, lengths, cap
                              ) -> Tuple[int, int]:
        """(arcs dropped, frames affected) across the batch: per-frame
        candidate counts above A_lat mean _compact clipped that frame's
        lattice arcs (the 'no silent caps' rule: surfaced, not
        swallowed).  Only each utterance's own frames count."""
        dropped, frames = 0, 0
        for b, T in enumerate(lengths):
            cnts = np.concatenate(
                [init_cnt[b:b + 1], e_cnt[:T, b], n_cnt[:T, b]])
            over = np.maximum(cnts.astype(np.int64) - cap, 0)
            dropped += int(over.sum())
            frames += int((over > 0).sum())
        return dropped, frames

    def _compress(self, rec, cnt, lvl0, lengths, cap):
        """Device-side cut of one record history [R, B, 3, A] (counts
        [R, B]; row r holds level r + lvl0) to what the host needs: per
        utterance, the valid records of its own levels (bucket padding
        frames drop here), in (level, record) order by a stable sort of
        the mask, truncated to ``cap``.  Returns [B, 4, cap] (src slot,
        dst slot, arc, level; -1 past the count) and the counts [B]."""
        R, B, _, A = rec.shape
        dev = rec.device
        lvl = torch.arange(R, device=dev)[:, None, None]
        j = torch.arange(A, device=dev)
        ok = ((j < cnt.clamp(max=A)[..., None])
              & (lvl + lvl0 <= lengths[:, None])
              & (rec[:, :, 0] >= 0) & (rec[:, :, 1] >= 0))
        ok = ok.transpose(0, 1).reshape(B, R * A)
        take = min(cap, R * A)
        order = torch.sort((~ok).to(torch.int8), dim=-1,
                           stable=True).indices[:, :take]
        n = ok.sum(-1, dtype=torch.int32).clamp(max=take)
        row = order // A
        idx = (row * B + torch.arange(B, device=dev)[:, None]) * (3 * A) \
            + order % A
        flat = rec.reshape(-1)
        out = torch.stack([flat[idx + k * A] for k in range(3)]
                          + [(row + lvl0).to(torch.int32)], 1)
        live = torch.arange(take, device=dev) < n[:, None]
        return torch.where(live[:, None], out, -1), n

    def _fetch_lattice_run(self, r, lengths, e_cnt, n_cnt):
        """Host fetch of a lattice run.  The per-frame counts are on the
        host already; each utterance's records are compressed on the
        device to the largest per-utterance total, and the records, their
        counts and each utterance's final-level states cross in ONE
        transfer.  Rows past ``len(lengths)`` pad the batch: they hold no
        valid record and are not fetched."""
        B, Bp = len(lengths), r["fs"].shape[1]
        A = int(self.A_lat)
        Ls = lengths.astype(np.int64)
        msk = np.arange(e_cnt.shape[0])[:, None] < Ls[None, :]
        ce = int((np.minimum(e_cnt[:, :B], A) * msk).sum(0).max(initial=0))
        cn = int((np.minimum(n_cnt[1:, :B], A) * msk).sum(0).max(initial=0)
                 + np.minimum(n_cnt[0, :B], A).max(initial=0))
        L = torch.as_tensor(np.concatenate([Ls, np.full(Bp - B, -1)]),
                            device=self.device)
        e_out, e_n = self._compress(r["e_rec"], r["e_cnt"], 1, L,
                                    max(ce, 1))
        n_out, n_n = self._compress(r["n_rec"], r["n_cnt"], 0, L,
                                    max(cn, 1))
        fsT = r["fs"][L.clamp(min=0), torch.arange(Bp, device=self.device)]
        parts = tuple(p[:B] for p in (e_out, e_n, n_out, n_n, fsT))
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        e_out, e_n, n_out, n_n, fsT = (
            x.reshape(p.shape) for x, p in zip(np.split(
                flat, np.cumsum([p.numel() for p in parts])[:-1]), parts))
        return {"e": tuple(e_out[:, k] for k in range(4)) + (e_n,),
                "n": tuple(n_out[:, k] for k in range(4)) + (n_n,),
                "fsT": fsT}

    def decode_batch_lattice(self, loglikes: List[np.ndarray],
                             determinize: bool = True,
                             auto_grow: bool = True,
                             max_grow: int = 3,
                             pad_frames: int = 0,
                             pad_rows: int = 0) -> List[Lattice]:
        """Batched lattice decode.  ``determinize`` applies word-level
        lattice determinization to each assembled lattice (ref:
        GetRawLattice -> DeterminizeLatticePruned), so no duplicate word
        sequences reach rescoring.  ``auto_grow`` re-runs with doubled
        ``lattice_arcs_per_frame`` (up to ``max_grow`` doublings) when
        per-frame record buffers overflowed; any residual overflow is
        logged, never silent.  ``pad_frames`` / ``pad_rows`` pad the
        batch to at least that many frames / rows (one set of graphs for
        a bucket); padding rows carry zero acoustics, are searched on the
        device and are never fetched, counted or assembled."""
        if self.A_lat <= 0:
            raise ValueError("construct the decoder with "
                             "lattice_arcs_per_frame > 0 (or None) for "
                             "lattice output")
        am, lengths = self._pad(loglikes, pad_frames, pad_rows)
        am_dev = torch.as_tensor(am, device=self.device)
        T = am.shape[1]
        for attempt in range(max_grow + 1):
            r = self._decode(am_dev, lattice=True)
            cnt = torch.cat([r["e_cnt"], r["n_cnt"]]).cpu().numpy()
            e_cnt, n_cnt = cnt[:T], cnt[T:]
            dropped, frames = self._overflow_from_counts(
                n_cnt[0], e_cnt, n_cnt[1:], lengths, self.A_lat)
            if dropped == 0 or not auto_grow or attempt == max_grow:
                break
            new_cap = self.A_lat * 2
            logger.warning(
                "lattice buffers overflowed: %d arcs dropped on %d "
                "frames at lattice_arcs_per_frame=%d; re-running with "
                "%d", dropped, frames, self.A_lat, new_cap)
            self.A_lat = new_cap
        self.last_overflow = (dropped, frames)
        if dropped:
            logger.warning(
                "lattice overflow (final): %d arcs dropped on %d frames "
                "at lattice_arcs_per_frame=%d: lattices are thinner "
                "than the lattice beam implies", dropped, frames,
                self.A_lat)
        fetch = self._fetch_lattice_run(r, lengths, e_cnt, n_cnt)
        lats = [self._assemble_lattice(fetch, am, int(lengths[b]), b)
                for b in range(len(loglikes))]
        if determinize:
            lats = [determinize_lattice(
                lat, lm_scale=1.0, acoustic_scale=self.acoustic_scale)
                for lat in lats]
        return lats

    def _assemble_lattice(self, fetch, am, T, b) -> Lattice:
        """Builds one utterance's Lattice from the host fetch (numpy, as in
        the JAX package): lattice states are the (level, slot) tokens that
        appear as a record endpoint, arcs the records with their graph
        weights and raw acoustic costs from the padded host ``am``; then
        ``prune_lattice`` to the lattice beam."""
        g = self.g
        K = self.K
        # compact per-utterance records (flat, -1-padded): emit entries
        # carry their DST level, eps entries their (same-src/dst) level
        esb, edb, eab, elv = (x[b][:int(fetch["e"][4][b])]
                              for x in fetch["e"][:4])
        nsb, ndb, nab, nlv = (x[b][:int(fetch["n"][4][b])]
                              for x in fetch["n"][:4])
        esb_c = np.clip(esb, 0, K - 1)
        edb_c = np.clip(edb, 0, K - 1)
        nsb_c = np.clip(nsb, 0, K - 1)
        ndb_c = np.clip(ndb, 0, K - 1)

        # number ONLY tokens that appear as a record endpoint (every
        # beam-surviving token's achieving arc is itself a record, so
        # connected tokens are covered; the rest would only bloat
        # prune_lattice)
        used = np.zeros((T + 1, K), bool)
        used[elv - 1, esb_c] = True
        used[elv, edb_c] = True
        used[nlv, nsb_c] = True
        used[nlv, ndb_c] = True
        fsT = fetch["fsT"][b]
        if not (len(esb) or len(nsb)):      # nothing survived: empty
            return Lattice(
                num_states=1, start=0,
                state_time=np.zeros(1, np.int32),
                arc_src=np.zeros(0, np.int32),
                arc_dst=np.zeros(0, np.int32),
                arc_ilabel=np.zeros(0, np.int32),
                arc_olabel=np.zeros(0, np.int32),
                arc_graph=np.zeros(0, np.float32),
                arc_acoustic=np.zeros(0, np.float32),
                final_graph=np.zeros(1, np.float32))
        flat = used.ravel()
        node = np.where(flat, np.cumsum(flat) - 1, -1).reshape(T + 1, K)
        nid = max(int(flat.sum()), 1)
        times = np.repeat(np.arange(T + 1), used.sum(axis=1))

        a_src = [node[elv - 1, esb_c]]
        a_dst = [node[elv, edb_c]]
        a_il = [g.e_ilabel[eab]]
        a_ol = [g.e_olabel[eab]]
        a_gw = [g.e_w[eab]]
        a_ac = [am[b][elv - 1, g.e_pdf[eab]]]
        a_src.append(node[nlv, nsb_c])
        a_dst.append(node[nlv, ndb_c])
        a_il.append(np.zeros(len(nab), np.int32))
        a_ol.append(g.n_olabel[nab])
        a_gw.append(g.n_w[nab])
        a_ac.append(np.zeros(len(nab), np.float32))

        final_graph = np.full(nid, np.inf, np.float32)
        last = used[T]
        final_graph[node[T, last]] = g.final[
            np.where(fsT[last] == INVALID, 0, fsT[last])]
        lat = Lattice(
            num_states=nid, start=0,
            state_time=np.asarray(times, np.int32),
            arc_src=np.concatenate(a_src).astype(np.int32),
            arc_dst=np.concatenate(a_dst).astype(np.int32),
            arc_ilabel=np.concatenate(a_il).astype(np.int32),
            arc_olabel=np.concatenate(a_ol).astype(np.int32),
            arc_graph=np.concatenate(a_gw).astype(np.float32),
            arc_acoustic=np.concatenate(a_ac).astype(np.float32),
            final_graph=final_graph)
        if not np.isfinite(lat.final_graph).any():
            lat.final_graph[node[T, last]] = 0.0
        return prune_lattice(lat, self.lattice_beam, lm_scale=1.0,
                             acoustic_scale=self.acoustic_scale)


# ---------------------------------------------------------------------------
# The search as CUDA graphs
# ---------------------------------------------------------------------------

class _Block:
    """One captured block of a runner: the CUDA graph of ``size`` frames
    of ``TopKDecoder._block`` (best path or lattice), its static input
    rows am [size + 1, B, P] and its output levels (``_levels``)."""

    def __init__(self, run: "_BlockRunner", lattice: bool, size: int,
                 num_pdfs: int):
        dec = run.dec
        B = run.fs.shape[0]
        self.size = size
        self.am = torch.zeros((size + 1, B, num_pdfs), dtype=torch.float32,
                              device=dec.device)
        self.out = dec._levels(size, B, lattice, dec.device)

        def body(frames=size):
            fs, fc = dec._block(run.fs, run.fc, self.am[:frames + 1],
                                {k: v[:frames] for k, v in self.out.items()},
                                lattice)
            run.fs.copy_(fs)
            run.fc.copy_(fc)

        self.graph, self.capture_s = _capture(
            body, lambda: body(1), dec.device, dec._graph_pool(),
            (run.fs, run.fc))


class _BlockRunner:
    """Frames as greedy blocks from ``sizes``, each block one CUDA graph
    of the block function, captured at its first use under (variant,
    size, A_lat, P) and replayed after.  A runner owns a carry (fs, fc)
    [B, K], which every one of its graphs reads and writes: the batch
    search keeps one runner a batch width, a ``StreamingDecoder`` one of
    its own.  Every tensor a graph reads or writes outside its own
    temporaries (rows in, levels out, the carry) is allocated outside
    the captures, so the graphs of one decoder share its memory pool
    safely in any replay order.  After each replay the block's levels
    are copied on the device into the caller's buffers at the block's
    offset; nothing waits for the card.  The lattice graphs bake in the
    record capacity: when auto-grow changes it, the old ones go and the
    blocks are captured again."""

    def __init__(self, dec: TopKDecoder, batch: int, sizes):
        self.dec, self.sizes = dec, tuple(sizes)
        K, dev = dec.K, dec.device
        self.fs = torch.full((batch, K), _INVALID, dtype=torch.int32,
                             device=dev)
        self.fc = torch.full((batch, K), _BIG, dtype=torch.float32,
                             device=dev)
        self.blocks: Dict[tuple, _Block] = {}

    def _get(self, lattice: bool, size: int, num_pdfs: int) -> _Block:
        a_lat = self.dec.A_lat if lattice else 0
        key = (lattice, size, a_lat, num_pdfs)
        blk = self.blocks.get(key)
        if blk is None:
            for k in [k for k in self.blocks if k[0] and k[2] != a_lat]:
                del self.blocks[k]
            blk = self.blocks[key] = _Block(self, lattice, size, num_pdfs)
        return blk

    def run(self, rows: torch.Tensor, out: Dict[str, torch.Tensor],
            lattice: bool) -> None:
        """``len(rows) - 1`` frames from the carry over rows [n + 1, B,
        P]; level j into row j of each of ``out``'s buffers."""
        i = 0
        for size in _ladder(rows.shape[0] - 1, self.sizes):
            blk = self._get(lattice, size, rows.shape[-1])
            blk.am.copy_(rows[i:i + size + 1])
            blk.graph.replay()
            for k, v in blk.out.items():
                out[k][i:i + size].copy_(v)
            i += size


class _Backtrace:
    """A batch search's best-path history and the backtrace's walk state,
    at fixed addresses, so that on the card the walk runs as captured
    chunks of steps (greedy from FRAME_BLOCKS, one CUDA graph a chunk
    size, in the decoder's pool): about 1,200 eager steps for a 300-frame
    batch become a dozen replays.  The history holds up to ``cap``
    levels (a multiple of 64) of B rows; a wider or longer batch gets a
    new object, and the old one's graphs go with it."""

    def __init__(self, dec: TopKDecoder, batch: int, frames: int):
        self.dec, self.B = dec, batch
        self.cap = -(-(frames + 1) // 64) * 64
        self.lv = torch.empty((self.cap, 4, batch, dec.K), dtype=torch.int32,
                              device=dec.device)
        self.st: Optional[Dict[str, torch.Tensor]] = None
        self.graphs: Dict[int, Tuple] = {}     # chunk -> (graph, capture s)

    def fits(self, batch: int, frames: int) -> bool:
        return batch == self.B and frames + 1 <= self.cap

    def run(self, lengths: torch.Tensor, levels: int):
        """The walk over the first ``levels`` levels; the same results
        as ``TopKDecoder._backtrace_eager`` (device tensors, arcs [B,
        L_cap])."""
        dec = self.dec
        fs, fc, ba, bp = dec._split(self.lv)
        start = dec._bt_start(fs, fc, lengths, dec._bt_len(self.cap))
        if self.st is None:
            self.st = start
        else:
            for k, v in start.items():
                self.st[k].copy_(v)
        st = self.st
        for size in _ladder(dec._bt_len(levels), FRAME_BLOCKS):
            if size not in self.graphs:
                def body(steps=size):
                    for _ in range(steps):
                        dec._bt_step(st, fs[:, 0], ba, bp)
                self.graphs[size] = _capture(body, lambda: body(1),
                                             dec.device, dec._graph_pool(),
                                             tuple(st.values()))
            self.graphs[size][0].replay()
        return (st["out"], st["n"], st["cost"], st["fail"] | ~st["done"],
                st["empty"])


# ---------------------------------------------------------------------------
# Streaming (chunked) decode on the same frame
# ---------------------------------------------------------------------------

class _Staging:
    """A chunk's rows and levels on their way to and from the blocks:
    pinned host and device buffers of ``capacity`` frames."""

    def __init__(self, capacity: int, num_pdfs: int, k: int, device):
        self.capacity = capacity
        self.rows_host = torch.zeros((capacity + 1, num_pdfs),
                                     dtype=torch.float32, pin_memory=True)
        self.rows = torch.zeros((capacity + 1, num_pdfs),
                                dtype=torch.float32, device=device)
        self.out = torch.zeros((capacity, 4, k), dtype=torch.int32,
                               device=device)
        self.out_host = torch.zeros((capacity, 4, k), dtype=torch.int32,
                                    pin_memory=True)


class StreamingDecoder:
    """AdvanceDecoding-style chunked interface over ``TopKDecoder``
    (counterpart of the JAX package's ``TpuStreamingDecoder``; ref:
    online2/online-nnet2-decoding.cc
    SingleUtteranceNnet2Decoder::AdvanceDecoding): feed acoustic chunks
    as they arrive; token state (the sorted top-K active set) carries
    across chunk boundaries on the device.

    Exactly matches offline ``decode_batch`` of the same rows: the
    acoustic-lookahead ranking needs frame t+1's row when pruning frame
    t, so one frame is held back per ``advance`` and flushed by
    ``finalize()`` using itself as lookahead.

    On a CUDA device a chunk runs through the batch search's block
    machinery (``_BlockRunner``, a batch of one, with a carry of its
    own): greedy blocks from ``CHUNK_BLOCKS``, each block size one CUDA
    graph of ``TopKDecoder._block`` (the best-path variant), captured at
    its first use in the decoder's memory pool; ``reset()`` keeps them.
    A chunk costs one copy of its rows from pinned host memory, then for
    each block a copy of its rows into the graph's input buffer, one
    replay (which leaves the carry in the runner's buffers) and a copy
    of its levels out, then one copy of all the levels back to pinned
    host memory and one sync.  On the CPU the same block function runs
    eagerly, frame by frame.  One decoder is one configuration: the
    graphs bake in the decoder's beam, acoustic scale, K and eps depth.

    Host memory is bounded as in the JAX package: only a traceback
    window of recent levels is retained; every ``commit_every`` frames
    the prefix on which all live tokens agree is committed
    (``_try_commit``), and ``max_history`` optionally force-commits
    along the best token.  The host commit machinery is the JAX
    package's, verbatim."""

    # a chunk of n frames runs as greedy blocks from this ladder: the
    # online recognizer's 20-frame pieces (0.2 s of audio) as 16 + 4, a
    # piece's tail and finalize()'s held-back frame as 1s
    CHUNK_BLOCKS = (16, 4, 1)

    def __init__(self, decoder: TopKDecoder,
                 frame_shift_sec: float = 0.01,
                 commit_every: int = 24,
                 max_history: Optional[int] = None,
                 walk_limit: Optional[int] = None):
        self.dec = decoder
        self.frame_shift = frame_shift_sec
        self.commit_every = int(commit_every)
        self.max_history = max_history
        # commit checks walk at most this many recent levels, keeping
        # the per-check cost O(1) in the stream length even when live
        # hypotheses refuse to converge (e.g. an effectively infinite
        # beam keeps parallel token families alive forever)
        self.walk_limit = (max(256, 8 * self.commit_every)
                           if walk_limit is None else int(walk_limit))
        # the carry between blocks: on the card, every graph of the
        # runner reads and writes its buffers
        self._runner = _BlockRunner(decoder, 1, self.CHUNK_BLOCKS)
        self._fs, self._fc = self._runner.fs, self._runner.fc
        self._staging: Optional[_Staging] = None
        self.reset()

    @property
    def capture_seconds(self) -> Dict[int, float]:
        """Block size -> seconds of its graph's capture ({} on the
        CPU)."""
        return {b.size: b.capture_s for b in self._runner.blocks.values()}

    def reset(self) -> None:
        self._pending: Optional[np.ndarray] = None   # held-back raw row
        self._state = None                           # set by _ensure_init
        self.num_frames = 0                          # processed frames
        # committed-prefix state (see class docstring)
        self._frontier: Optional[Tuple[np.ndarray, ...]] = None
        self._frontier_slot: int = 0
        self._buf: List[Tuple[np.ndarray, ...]] = []  # levels after frontier
        self._ctids: List[int] = []                   # committed labels
        self._cwords: List[int] = []
        self._since_check = 0

    # -- the device side ---------------------------------------------------
    @torch.no_grad()
    def _run_frames(self, rows: np.ndarray) -> Tuple[np.ndarray, ...]:
        """``len(rows) - 1`` frames over raw rows [n + 1, P]; returns the
        levels (fs, fc, bp_arc, bp_prev), each [n, K] on the host."""
        n, dev, K = len(rows) - 1, self.dec.device, self.dec.K
        if dev.type != "cuda":
            out = self.dec._levels(n, 1, False, dev)
            am = torch.as_tensor(rows, device=dev)[:, None]
            self._fs, self._fc = self.dec._block(self._fs, self._fc, am,
                                                 out)
            packed = out["lv"][:, :, 0].numpy()
        else:
            st = self._staging
            if st is None or st.capacity < n:
                st = self._staging = _Staging(
                    max(64, 1 << (n - 1).bit_length()), rows.shape[1], K,
                    dev)
            st.rows_host.numpy()[:n + 1] = rows
            st.rows[:n + 1].copy_(st.rows_host[:n + 1], non_blocking=True)
            self._runner.run(st.rows[:n + 1, None],
                             {"lv": st.out[:n, :, None]}, False)
            st.out_host[:n].copy_(st.out[:n], non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            packed = st.out_host[:n].numpy().copy()
        return (packed[:, 0], packed[:, 1].view(np.float32), packed[:, 2],
                packed[:, 3])

    @torch.no_grad()
    def _ensure_init(self, am_row0: np.ndarray) -> None:
        """Level 0: the start token, its eps closure ranked with frame 0's
        lookahead, and its backpointers (eagerly, once an utterance)."""
        if self._state is not None:
            return
        dec, K = self.dec, self.dec.K
        s0 = torch.full((1, K), _INVALID, dtype=torch.int32,
                        device=dec.device)
        s0[:, 0] = dec.g.start
        c0 = torch.full((1, K), _BIG, dtype=torch.float32, device=dec.device)
        c0[:, 0] = 0.0
        am0 = torch.as_tensor(am_row0[None], device=dec.device)
        fs0, fc0 = dec._eps_fixpoint(s0, c0, dec._am_ext(am0))
        root = torch.full((1, K), -1, dtype=torch.int64, device=dec.device)
        bp_a, bp_p = dec._resolve_bp(fs0, fc0, s0, c0, root, root)
        self._fs.copy_(fs0)
        self._fc.copy_(fc0)
        lvl = tuple(x[0].cpu().numpy() for x in (fs0, fc0, bp_a, bp_p))
        self._frontier = lvl + (None,)
        root = np.nonzero((lvl[2] < 0)
                          & (lvl[0] == self.dec.g.start))[0]
        self._frontier_slot = int(root[0]) if len(root) else 0
        self._state = (self._fs, self._fc)

    def _append_level(self, lvl: Tuple[np.ndarray, ...]) -> None:
        """Host bookkeeping for one processed frame: retain the level
        in the traceback window, run the commit-cadence checks."""
        self._buf.append(lvl)
        self.num_frames += 1
        self._since_check += 1
        if self._since_check >= self.commit_every:
            self._since_check = 0
            self._try_commit()
        if self.max_history and len(self._buf) > self.max_history:
            self._force_commit()

    def advance(self, loglikes: np.ndarray) -> None:
        """Feed [n, num_pdfs] acoustic log-likelihoods.  On the card the
        frames run as blocks (CHUNK_BLOCKS), one graph replay each, and
        their levels come back in one fetch."""
        rows = -np.asarray(loglikes, np.float32)
        if rows.size == 0:
            return
        if self._pending is not None:
            rows = np.concatenate([self._pending[None], rows])
        if len(rows) < 2:
            self._pending = rows[-1]
            return
        self._ensure_init(rows[0])
        levels = self._run_frames(rows)
        for j in range(len(rows) - 1):
            self._append_level(tuple(x[j] for x in levels) + (rows[j],))
        self._pending = rows[-1]

    def finalize(self) -> None:
        """Flush the held-back frame (end of input) through the size-1
        block, with itself as lookahead."""
        if self._pending is not None:
            row = self._pending
            self._ensure_init(row)
            levels = self._run_frames(np.stack([row, row]))
            self._append_level(tuple(x[0] for x in levels) + (row,))
            self._pending = None

    # -- committed-prefix machinery ---------------------------------------
    def _collapse_eps(self, lvl, cur: np.ndarray) -> np.ndarray:
        """Map token slots to their within-level eps-ROOT slot (a path
        through an eps-descendant also passes through its root); broken
        chains go to -1 only if an unresolved backpointer interrupts."""
        _, _, ba, bp = lvl[:4]
        hi = len(ba) - 1
        n_e = self.dec.g.num_emitting_arcs
        for _ in range(self.dec.eps_iters + 1):
            a = ba[np.clip(cur, 0, hi)]
            is_eps = (cur >= 0) & (a >= n_e)
            if not is_eps.any():
                break
            cur = np.where(is_eps, bp[np.clip(cur, 0, hi)], cur)
        return cur

    def _emit_hop(self, lvl, cur: np.ndarray) -> np.ndarray:
        """Map eps-root slots at one level to their emitting-predecessor
        slots at the previous level (-1 when unresolved)."""
        _, _, ba, bp = lvl[:4]
        hi = len(ba) - 1
        cur_c = np.clip(cur, 0, hi)
        a = ba[cur_c]
        n_e = self.dec.g.num_emitting_arcs
        return np.where((cur >= 0) & (a >= 0) & (a < n_e), bp[cur_c], -1)

    def _step_back(self, lvl, cur: np.ndarray) -> np.ndarray:
        return self._emit_hop(lvl, self._collapse_eps(lvl, cur))

    def _try_commit(self) -> None:
        """Walk the live tokens' backpointer chains backward through the
        window; the LATEST level at which all chains pass through one
        token (an eps-root shared by every chain) is provably on the
        final path no matter what audio follows — Viterbi backpointers
        are unique per token, so merged paths stay merged — and the
        prefix up to it commits."""
        W = len(self._buf)
        if W == 0:
            return
        valid = self._buf[-1][0] != INVALID
        if not valid.any():
            return
        K = self.dec.K
        cur = np.where(valid, np.arange(K), -1)
        for i in range(W, max(W - self.walk_limit, -1), -1):
            lvl = self._buf[i - 1] if i > 0 else self._frontier
            cur = self._collapse_eps(lvl, cur)
            if (cur[valid] < 0).any():     # a chain broke: cannot prove
                return
            u = np.unique(cur[valid])
            if len(u) == 1:
                self._commit_to(i, int(u[0]))
                return
            if i > 0:
                cur = self._emit_hop(lvl, cur)
                if (cur[valid] < 0).any():
                    return

    def _force_commit(self) -> None:
        """max_history exceeded: commit along the CURRENT BEST token's
        path even though other live tokens disagree (forced partial
        traceback — bounded memory, approximate in the non-converging
        case; see class docstring)."""
        W = len(self._buf)
        target = W - max(self.max_history // 2, 1)
        if target < 0:
            return
        fs, fc = self._buf[-1][:2]
        valid = fs != INVALID
        if not valid.any():
            return
        s = np.asarray([int(np.argmin(np.where(valid, fc, BIG)))])
        for i in range(W, target, -1):
            s = self._step_back(self._buf[i - 1], s)
            if s[0] < 0:
                return
        s = self._collapse_eps(
            self._buf[target - 1] if target > 0 else self._frontier, s)
        if s[0] < 0:
            return
        self._commit_to(target, int(s[0]))

    def _commit_to(self, off: int, slot: int) -> None:
        try:
            tids, words = self._trace(off, slot)
        except RuntimeError:
            return          # rare unresolved chain: retry a later check
        self._ctids.extend(tids)
        self._cwords.extend(words)
        if off > 0:
            self._frontier = self._buf[off - 1]
            self._buf = self._buf[off:]
        self._frontier_slot = slot

    def _level_host(self, i: int) -> Tuple[np.ndarray, ...]:
        """Window level i: 0 = the committed frontier, i = _buf[i-1]."""
        return self._frontier if i == 0 else self._buf[i - 1]

    def _trace(self, i: int, slot: int
               ) -> Tuple[List[int], List[int]]:
        """Backpointer walk from (window level i, slot) back to the
        committed frontier token; forward-order (tids, words)."""
        g = self.dec.g
        n_e = g.num_emitting_arcs
        tids_r: List[int] = []
        words_r: List[int] = []
        guard, limit = 0, (i + 2) * (self.dec.eps_iters + 2) + 16
        while not (i == 0 and slot == self._frontier_slot):
            guard += 1
            if guard > limit:
                raise RuntimeError("streaming traceback loop")
            _, _, ba, bp = self._level_host(i)[:4]
            a, p = int(ba[slot]), int(bp[slot])
            if a < 0 or (i == 0 and a < n_e):
                if i == 0:
                    raise RuntimeError(
                        "streaming traceback: chain does not reach the "
                        "commit frontier")
                slot, i2, tids2, words2 = self._window_fix(i, slot)
                i = i2
                tids_r.extend(tids2)
                words_r.extend(words2)
                continue
            if a >= n_e:
                a -= n_e
                if g.n_olabel[a] > 0:
                    words_r.append(int(g.n_olabel[a]))
                slot = p
            else:
                tids_r.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words_r.append(int(g.e_olabel[a]))
                slot = p
                i -= 1
        return tids_r[::-1], words_r[::-1]

    def _window_fix(self, i: int, slot: int):
        """Host repair of an unresolved backpointer inside the window
        (the streaming analogue of TopKDecoder._host_fix; window
        level 0 — the committed frontier — plays the init role).  The
        port's ``_host_fix`` reads histories [B, levels, K] with level 0
        in them."""
        levels = [self._level_host(j)
                  for j in range(len(self._buf) + 1)]
        r = {name: np.stack([lv[j] for lv in levels])[None]
             for j, name in enumerate(("fs", "fc", "bp_arc", "bp_prev"))}
        am = np.stack([lv[4] for lv in levels[1:]])[None]
        return self.dec._host_fix(r, am, i, 0, slot)

    def best_path(self, use_final: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Current best (tids, words, cost) over the processed frames —
        committed prefix + traceback over the retained window only."""
        if self._state is None:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    float("inf"))
        g = self.dec.g
        fs, fc = self._level_host(len(self._buf))[:2]
        valid = fs != INVALID
        if not valid.any():
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    float("inf"))
        if use_final:
            total = np.where(valid, fc + g.final[np.where(valid, fs, 0)],
                             BIG)
        else:
            total = np.where(valid, fc, BIG)
        slot = int(np.argmin(total))
        cost = float(total[slot])
        if cost >= BIG:      # no final state reached: best active token
            total = np.where(valid, fc, BIG)
            slot = int(np.argmin(total))
            cost = float(total[slot])
        tids, words = self._trace(len(self._buf), slot)
        return (np.asarray(self._ctids + tids, np.int32),
                np.asarray(self._cwords + words, np.int32), cost)

    # -- endpointing (same rules as the host online decoder) --------------
    def trailing_silence_frames(self, trans_model, silence_phone: int
                                ) -> int:
        tids, _, _ = self.best_path(use_final=False)
        n = 0
        for tid in tids[::-1]:
            if trans_model.id_to_phone(int(tid)) == silence_phone:
                n += 1
            else:
                break
        return n

    def endpoint_detected(self, trans_model, silence_phone: int,
                          config=None) -> bool:
        """(ref: online-endpoint.cc EndpointDetected, over the top-K
        active set instead of the dense cost vector)."""
        from kaldi_cnn_tpu_torch.online2.decoder import EndpointConfig
        config = config or EndpointConfig()
        t = self.num_frames
        if t == 0:
            return False
        utt_sec = t * self.frame_shift
        _, words, _ = self.best_path(use_final=False)
        trailing_sec = self.trailing_silence_frames(
            trans_model, silence_phone) * self.frame_shift
        said_something = len(words) > 0
        if not said_something and utt_sec >= config.silence_timeout_sec:
            return True
        r = config.rule_trailing
        if said_something or not r.must_contain_nonsilence:
            if (trailing_sec >= r.min_trailing_silence_sec
                    and utt_sec >= r.min_utterance_length_sec):
                fs, fc = self._level_host(len(self._buf))[:2]
                valid = fs != INVALID
                if valid.any():
                    final = self.dec.g.final[np.where(valid, fs, 0)]
                    best_final = float(np.min(np.where(
                        valid, fc + final, BIG)))
                    best_any = float(np.min(np.where(valid, fc, BIG)))
                    if (best_final < BIG and
                            best_final - best_any <= r.max_relative_cost):
                        return True
        if utt_sec >= config.max_utterance_length_sec:
            return True
        return False


# ---------------------------------------------------------------------------
# Production entry point: the recipe's lattice decode
# ---------------------------------------------------------------------------

def decode_utterances(graph: CompiledGraph,
                      loglikes: Dict[str, np.ndarray],
                      acoustic_scale: float = 0.1,
                      beam: float = 16.0,
                      lattice_beam: float = 8.0,
                      max_active: int = 7000,
                      lattice_arcs_per_frame: Optional[int] = None,
                      batch_size: int = 16,
                      bucket_frames: int = 128,
                      determinize: bool = True,
                      decoder: Optional[TopKDecoder] = None,
                      device="cuda", group=None) -> Dict[str, Lattice]:
    """Batched lattice decode of a keyed utterance set, the recipes'
    decode path (ref: nnet2bin/nnet-latgen-faster.cc's role; the
    determinization mirrors GetRawLattice -> DeterminizeLatticePruned).

    Utterances are bucketed by padded length (multiples of
    ``bucket_frames``) and decoded in batches of ``batch_size``; a short
    last batch keeps that width with rows of zero acoustics (so that it
    replays the full batches' graphs), and those rows are never fetched,
    assembled or determinized.  ``lattice_arcs_per_frame=None`` derives the
    record capacity from ``max_active``
    (``TopKDecoder._derive_lattice_arcs``).

    With a process ``group``, rank k of the group decodes the utterances
    at sorted positions k, k + size, ... and the lattices are gathered,
    so every rank returns the whole keyed set (ordered by rank, then as
    without a group).  Each utterance's search is its own row's (top-K,
    beam and record caps are per row), so its lattice is the one the
    call without a group gives."""
    if group is not None:
        import torch.distributed as dist
        k, size = dist.get_rank(group), dist.get_world_size(group)
        mine = decode_utterances(
            graph, {u: loglikes[u] for u in sorted(loglikes)[k::size]},
            acoustic_scale, beam, lattice_beam, max_active,
            lattice_arcs_per_frame, batch_size, bucket_frames, determinize,
            decoder, device)
        parts: List[Optional[Dict[str, Lattice]]] = [None] * size
        dist.all_gather_object(parts, mine, group=group)
        return {u: lat for part in parts for u, lat in part.items()}
    dec = decoder or TopKDecoder(
        graph, beam=beam, max_active=max_active,
        acoustic_scale=acoustic_scale, lattice_beam=lattice_beam,
        lattice_arcs_per_frame=lattice_arcs_per_frame, device=device)
    if dec.A_lat <= 0:
        raise ValueError("decode_utterances needs a decoder with lattice "
                         "records (lattice_arcs_per_frame > 0 or None)")
    buckets: Dict[int, List[str]] = {}
    for utt in sorted(loglikes):
        t = loglikes[utt].shape[0]
        tb = -(-max(t, 1) // bucket_frames) * bucket_frames
        buckets.setdefault(tb, []).append(utt)
    out: Dict[str, Lattice] = {}
    for tb in sorted(buckets):
        us = buckets[tb]
        for i in range(0, len(us), batch_size):
            chunk = us[i:i + batch_size]
            lls = [np.asarray(loglikes[u], np.float32) for u in chunk]
            lats = dec.decode_batch_lattice(lls, determinize=determinize,
                                            pad_frames=tb,
                                            pad_rows=batch_size)
            out.update(zip(chunk, lats))
    return out
