"""Batched dense Viterbi beam search over a CSR-packed HCLG, on the card
as CUDA graphs.

Port of ``kaldi_cnn_tpu/decode/tpu_decoder.py`` to PyTorch (ref:
src/decoder/lattice-faster-decoder.cc and faster-decoder.cc): the exact
search, every arc relaxed every frame, batched over utterances:

  per frame, for costs [B, S] (one row an utterance):
    cand[b, a] = cost[b, src[a]] + graph_w[a] + scale * am[b, t, pdf[a]]
    cost'[b, s] = min over the arcs into s  (``scatter_reduce("amin")``)
    L eps sweeps of the same form           (ProcessNonemitting)
    beam / max-active pruning by thresholding (PruneActiveTokens)

L is the longest eps path of the graph (``_eps_depth``, capped at 32),
so the eps closure is exact.  Each frame records, for every state, the
emitting arc and the eps arc that won it; the best path is walked back
over them on the device, and only its labels cross to the host.

The relaxation is a segment min, which the JAX package computes outside
any Pallas kernel (``jax.ops.segment_min``), so plain PyTorch ops are
the port here.  On the card the frame loop runs as CUDA graphs of frame
blocks (greedy from ``FRAME_BLOCKS``, one graph a block size, captured
at its first use, ``core/graphs.py``), which read their frame index, the
acoustic rows and the lengths from device buffers and write the frame's
decisions into the histories at that index, so a batch's frames are a
few replays and no host sync.  The histories are [T, B, S] int32 each,
allocated once for a batch shape (16 utterances of 200 frames on a
539,948-state graph: 6.9 GB each).  Elsewhere, and with
``eager=True``, the same frame function runs frame by frame.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.graphs import capture as _capture
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.decode.topk_decoder import FRAME_BLOCKS, _ladder

BIG = np.float32(1e30)
_BIG = float(BIG)
_INT_MAX = 2**31 - 1        # jax.ops.segment_min's int32 identity


def _eps_depth(g: CompiledGraph, cap: int = 32) -> int:
    """Longest path length in the eps-arc subgraph (host, offline)."""
    if g.num_eps_arcs == 0:
        return 0
    depth = np.zeros(g.num_states, np.int32)
    # Bellman-Ford style; the eps subgraph of HCLG is a DAG
    for _ in range(cap):
        upd = np.zeros(g.num_states, np.int32)
        np.maximum.at(upd, g.n_dst, depth[g.n_src] + 1)
        new = np.maximum(depth, upd)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    return cap


def _segment_min_argmin(cand: torch.Tensor, dst: torch.Tensor,
                        arc_idx: torch.Tensor, num_states: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cand [B, A] -> per destination [B, S]: the min cost (inf where no
    arc enters) and the lowest arc index within 1e-7 of it (INT_MAX
    where none)."""
    B = cand.shape[0]
    idx = dst.expand(B, -1)
    m = torch.full((B, num_states), float("inf"), dtype=cand.dtype,
                   device=cand.device).scatter_reduce_(1, idx, cand, "amin")
    is_best = cand <= m.index_select(1, dst) + 1e-7
    a = torch.full((B, num_states), _INT_MAX, dtype=torch.int32,
                   device=cand.device).scatter_reduce_(
        1, idx, torch.where(is_best, arc_idx, _INT_MAX), "amin")
    return m, a


class _Runner:
    """One batch shape's buffers on the card and its block graphs: the
    acoustic rows [T, B, P], the lengths, the carry (costs and the frame
    index) and the histories [T, B, S], all allocated outside the
    captures, so the graphs of one decoder share its memory pool in any
    replay order."""

    def __init__(self, dec: "DenseViterbiDecoder", B: int, T: int, P: int):
        dev, S = dec.device, dec.S
        self.dec, self.B, self.T, self.P = dec, B, T, P
        self.am = torch.zeros((T, B, P), dtype=torch.float32, device=dev)
        self.lengths = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.cost = torch.empty((B, S), dtype=torch.float32, device=dev)
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.emit = torch.empty((T, B, S), dtype=torch.int32, device=dev)
        self.eps = torch.empty((T, B, S), dtype=torch.int32, device=dev)
        self.graphs = {}        # block size -> (graph, capture seconds)

    def fits(self, B: int, T: int, P: int) -> bool:
        return B == self.B and T <= self.T and P == self.P

    def _frames(self, n: int) -> None:
        dec = self.dec
        for _ in range(n):
            am_row = self.am.index_select(0, self.t)[0]
            cost, emit, eps = dec._frame(self.cost, am_row,
                                         self.t < self.lengths)
            self.cost.copy_(cost)
            self.emit.index_copy_(0, self.t, emit[None])
            self.eps.index_copy_(0, self.t, eps[None])
            self.t.add_(1)

    def run(self, frames: int) -> None:
        self.t.zero_()
        for size in _ladder(frames, FRAME_BLOCKS):
            if size not in self.graphs:
                self.graphs[size] = _capture(
                    lambda n=size: self._frames(n),
                    lambda: self._frames(1), self.dec.device,
                    self.dec._graph_pool(), (self.cost, self.t))
            self.graphs[size][0].replay()


class DenseViterbiDecoder:
    """Batched exact Viterbi beam search over dense [B, S] costs
    (counterpart of ``kaldi_cnn_tpu.decode.tpu_decoder.TpuViterbiDecoder``,
    with its semantics: ``BIG``, the eps depth and its cap, the segment
    min and its tie rule, eps sweeps that improve by more than 1e-6, the
    beam and ``max_active`` cutoffs, padded frames frozen, the final
    state and its fallback, the backtrace's guards).  The graphs bake in
    the decoder's beam, acoustic scale, ``max_active`` and eps depth."""

    def __init__(self, graph: CompiledGraph, beam: float = 16.0,
                 max_active: int = 0, acoustic_scale: float = 0.1,
                 device="cuda"):
        self.g = graph
        self.device = torch.device(device)
        self.beam = float(np.float32(beam))
        self.max_active = (int(max_active)
                           if 0 < max_active < graph.num_states else 0)
        self.acoustic_scale = float(np.float32(acoustic_scale))
        self.eps_iters = _eps_depth(graph)
        self.S = graph.num_states
        t = lambda a, dt=torch.int64: torch.as_tensor(
            np.asarray(a), device=self.device).to(dt)
        self.e_src, self.e_dst, self.e_pdf = (
            t(graph.e_src), t(graph.e_dst), t(graph.e_pdf))
        self.e_w = t(graph.e_weight, torch.float32)
        self.n_src, self.n_dst = t(graph.n_src), t(graph.n_dst)
        self.n_w = t(graph.n_weight, torch.float32)
        self.final = t(graph.final, torch.float32)
        self.e_ilabel = t(graph.e_ilabel, torch.int32)
        self.e_olabel = t(graph.e_olabel, torch.int32)
        self.n_olabel = t(graph.n_olabel, torch.int32)
        self.e_idx = torch.arange(len(graph.e_src), dtype=torch.int32,
                                  device=self.device)
        self.n_idx = torch.arange(len(graph.n_src), dtype=torch.int32,
                                  device=self.device)
        self._pool = None
        self._runner: Optional[_Runner] = None

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def release(self) -> None:
        """Frees the batch shape's buffers and block graphs (the
        histories above all); the next ``decode_batch`` on the card
        allocates and captures anew."""
        self._runner = None

    @property
    def capture_seconds(self) -> dict:
        """Seconds of each block graph captured, by block size."""
        r = self._runner
        return {} if r is None else {k: v[1] for k, v in r.graphs.items()}

    # -- the frame (batched) ----------------------------------------------
    def _eps_sweeps(self, cost, eps_arc):
        for _ in range(self.eps_iters):
            cand = cost[:, self.n_src] + self.n_w
            m, a = _segment_min_argmin(cand, self.n_dst, self.n_idx, self.S)
            improved = m < cost - 1e-6
            cost = torch.where(improved, m, cost)
            eps_arc = torch.where(improved, a, eps_arc)
        return cost, eps_arc

    def _frame(self, cost, am_row, active):
        """cost [B, S], am_row [B, P] (-loglikes), active [B] bool ->
        (cost, emitting arcs, eps arcs), each [B, S]."""
        cand = (cost[:, self.e_src] + self.e_w
                + self.acoustic_scale * am_row[:, self.e_pdf])
        new_cost, emit_arc = _segment_min_argmin(cand, self.e_dst,
                                                 self.e_idx, self.S)
        eps_arc = torch.full_like(emit_arc, -1)
        new_cost, eps_arc = self._eps_sweeps(new_cost, eps_arc)
        cutoff = new_cost.amin(dim=1, keepdim=True) + self.beam
        if self.max_active:
            kth = torch.kthvalue(new_cost, self.max_active + 1, dim=1,
                                 keepdim=True).values
            cutoff = torch.minimum(cutoff, kth)
        new_cost = torch.where(new_cost <= cutoff, new_cost, _BIG)
        act = active[:, None]
        return (torch.where(act, new_cost, cost),
                torch.where(act, emit_arc, -1),
                torch.where(act, eps_arc, -1))

    def _init(self, B: int):
        cost = torch.full((1, self.S), _BIG, dtype=torch.float32,
                          device=self.device)
        cost[0, self.g.start] = 0.0
        eps = torch.full((1, self.S), -1, dtype=torch.int32,
                         device=self.device)
        cost, eps = self._eps_sweeps(cost, eps)
        return cost.expand(B, -1), eps.expand(B, -1)

    # -- decode -------------------------------------------------------------
    def decode_batch(self, loglikes: List[np.ndarray], eager: bool = False
                     ) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """loglikes: list of [T_i, P] arrays.  Returns per utterance
        (tids [T_i], word ids, total cost).  Pads to the longest; padded
        frames freeze their utterance.  On the card the frames replay the
        block graphs unless ``eager``."""
        B = len(loglikes)
        T = max(x.shape[0] for x in loglikes)
        P = loglikes[0].shape[1]
        am = np.zeros((T, B, P), np.float32)
        lengths = np.zeros((B,), np.int64)
        for i, x in enumerate(loglikes):
            am[:x.shape[0], i] = -x     # raw acoustic costs
            lengths[i] = x.shape[0]
        init_cost, init_eps = self._init(B)
        if self.device.type == "cuda" and not eager:
            if self._runner is None or not self._runner.fits(B, T, P):
                self.release()      # the old histories go first
                self._runner = _Runner(self, B, T, P)
            r = self._runner
            r.am[:T].copy_(torch.as_tensor(am))
            r.lengths.copy_(torch.as_tensor(lengths))
            r.cost.copy_(init_cost)
            r.run(T)
            cost, emit, eps = r.cost, r.emit, r.eps
        else:
            am_d = torch.as_tensor(am, device=self.device)
            len_d = torch.as_tensor(lengths, device=self.device)
            emit = torch.empty((T, B, self.S), dtype=torch.int32,
                               device=self.device)
            eps = torch.empty_like(emit)
            cost = init_cost
            for t in range(T):
                cost, emit[t], eps[t] = self._frame(cost, am_d[t],
                                                    t < len_d)
        total = cost + self.final[None, :]
        best_cost, best_state = total.min(dim=1)
        # fallback when no final state is reachable
        alt_cost, alt_state = cost.min(dim=1)
        use_alt = best_cost >= _BIG
        best_state = torch.where(use_alt, alt_state, best_state)
        best_cost = torch.where(use_alt, alt_cost, best_cost)
        tids, words, init_words = self._backtrace(
            best_state, torch.as_tensor(lengths, device=self.device), emit,
            eps, init_eps, T)
        tids, words, init_words, best_cost = (
            tids.cpu().numpy(), words.cpu().numpy(), init_words.cpu().numpy(),
            best_cost.cpu().numpy())
        out = []
        for i in range(B):
            n = int(lengths[i])
            w = words[i, :n][::-1].reshape(-1)
            w = np.concatenate([w[w > 0], init_words[i][init_words[i] > 0]])
            out.append((tids[i, :n].copy(), w[::-1].astype(np.int32),
                        float(best_cost[i])))
        return out

    def _backtrace(self, state, lengths, emit, eps, init_eps, T: int):
        """The walk back over the recorded decisions, all rows at once on
        the device: tids [B, T], the words of each frame [B, T, L + 2]
        (the eps chain's in walk order, then the emitting arc's) and of
        the initial eps chain [B, L + 1], 0 where none.  Raises as the
        JAX unwind asserts: an eps chain longer than L + 1 arcs, or an
        emitting step from a state no arc reached."""
        B, dev, L = state.shape[0], self.device, self.eps_iters
        rows = torch.arange(B, device=dev)
        s = state.clone()
        tids = torch.zeros((B, T), dtype=torch.int32, device=dev)
        words = torch.zeros((B, T, L + 2), dtype=torch.int32, device=dev)
        bad = torch.zeros((B,), dtype=torch.bool, device=dev)
        E = len(self.e_idx)

        def chain(history, live, out):
            """Follows eps arcs from ``s`` while ``live``; each arc's
            output label into column j of ``out``."""
            nonlocal s
            for j in range(L + 1):
                a = history[rows, s].long()
                has = live & (a >= 0)
                a = a.clamp(min=0)
                out[:, j] = torch.where(has, self.n_olabel[a], 0)
                s = torch.where(has, self.n_src[a], s)
            return live & (history[rows, s] >= 0)

        for t in range(T - 1, -1, -1):
            live = t < lengths
            bad |= chain(eps[t], live, words[:, t])
            a = emit[t][rows, s].long()
            bad |= live & ((a < 0) | (a >= E))
            a = a.clamp(0, E - 1)
            tids[:, t] = torch.where(live, self.e_ilabel[a], 0)
            words[:, t, L + 1] = torch.where(live, self.e_olabel[a], 0)
            s = torch.where(live, self.e_src[a], s)
        init_words = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
        bad |= chain(init_eps, torch.ones_like(bad), init_words)
        if bool(bad.any()):
            raise RuntimeError(
                "backtrace hit a pruned state or an over-long eps chain in "
                f"rows {torch.nonzero(bad).flatten().tolist()}")
        return tids, words, init_words
